"""Per-request sampling parameters (facade re-export).

``SamplingParams`` lives next to the device sampler in
``repro_torch.core.sampling`` (the engine consumes it directly); the public
import path is this module / ``repro_torch.api``. Besides sampling and
termination, it carries the request's ``compression_policy``
(``"default" | "protect" | "aggressive"`` — docs/EVAL.md), the
per-request intent the scheduler's quality-aware compression planner
consumes.
"""
from repro_torch.core.sampling import SamplingParams  # noqa: F401

__all__ = ["SamplingParams"]
