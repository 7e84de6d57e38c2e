"""``repro_torch.serve`` — the OpenAI-compatible HTTP serving tier of the
port (the JAX package's ``repro.serve``).

An asyncio front-end (hand-rolled ASGI 3 app, stdlib-only) over the
``repro_torch.api`` async surface: continuous batching, SSE streaming,
bounded backpressure, per-client fairness and graceful drain.  See
docs/SERVING.md for the architecture and ``python -m repro_torch.serve``
for the CLI, which serves on the card unless ``--device cpu`` is given.
"""
from repro_torch.serve.app import create_app  # noqa: F401
from repro_torch.serve.config import ServeConfig  # noqa: F401
from repro_torch.serve.state import ServerState  # noqa: F401

__all__ = ["create_app", "ServeConfig", "ServerState"]
