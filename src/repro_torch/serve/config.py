"""Server-tier configuration (everything the HTTP layer owns).

Engine-side knobs stay in the ``repro_torch.api`` config split;
``ServeConfig`` only holds what the serving tier itself decides: the model
to bring up and the device it runs on, intake bounds, fairness, and the
bind address.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Configuration for ``repro_torch.serve`` (docs/SERVING.md)."""
    model: str = "tiny-lm"           # architecture (repro_torch.configs)
    reduce: bool = True              # family-preserving tiny config
    host: str = "127.0.0.1"
    port: int = 8000
    # waiting-backlog bound: intake + scheduler waiting queue; beyond it
    # add_request raises EngineSaturated -> HTTP 429 + Retry-After
    max_queued_requests: int = 64
    # per-client fairness: map client identity (Authorization bearer key,
    # x-client-id, or body "user") onto Request.priority = -inflight so
    # the "priority" scheduler policy round-robins across clients
    fairness: bool = True
    # scheduler admission policy the engine is built with (fairness wants
    # "priority"; see SchedulerConfig.policy for the full list)
    policy: str = "priority"
    # hard per-request output cap the protocol enforces before admission
    # (None = bounded only by max_model_len)
    max_tokens_limit: Optional[int] = 512
    # flat engine-config overrides routed through the repro_torch.api config
    # split at bring-up, e.g. {"block_size": 8, "n_total_blocks": 64}
    engine_overrides: dict = dataclasses.field(default_factory=dict)
    # the engine's device: None serves on the card ("cuda") and raises
    # without one, as every entry point of the port; "cpu" runs the
    # kernels' plain versions
    device: Optional[str] = None
