"""Server state: the engine, its background loop, and admission policy.

``ServerState`` is the seam between the protocol layer and the engine:
it owns the ``Zipage`` facade, the ``AsyncEngineLoop`` driving it, and
the fairness ledger, and exposes exactly the operations the ASGI app
needs — validated admission, streaming, abort, drain, stats.
``stats()`` reads host state only, so ``/health`` never waits on the
device.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.api import Zipage
from repro_torch.api.aio import AsyncEngineLoop
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.fairness import ClientFairness
from repro_torch.serve.protocol import CompletionRequest


class ServerState:
    def __init__(self, config: ServeConfig,
                 zipage: Optional[Zipage] = None):
        self.config = config
        if zipage is None:
            zipage = Zipage.from_config(
                config.model, device=config.device, reduce=config.reduce,
                policy=config.policy, **config.engine_overrides)
        self.zipage = zipage
        self.loop = AsyncEngineLoop(
            zipage, max_queued_requests=config.max_queued_requests)
        self.fairness = ClientFairness() if config.fairness else None

    # ------------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self.zipage.cfg.vocab_size

    @property
    def max_model_len(self) -> int:
        return self.zipage.engine.opts.max_model_len

    def validate(self, req: CompletionRequest) -> None:
        req.check_capacity(
            vocab_size=self.vocab_size,
            max_model_len=self.max_model_len,
            max_tokens_limit=self.config.max_tokens_limit)

    async def admit(self, req: CompletionRequest, client: str) -> int:
        """Admit a validated request; returns its request id.

        Raises ``EngineSaturated`` / ``EngineDraining`` (mapped to
        429 / 503 by the app). Fairness accounting is undone by
        ``release()`` when the request's stream closes.
        """
        priority = self.fairness.admit(client) if self.fairness else 0
        try:
            return await self.loop.add_request(
                req.prompt, req.params, priority=priority)
        except BaseException:
            if self.fairness:
                self.fairness.release(client)
            raise

    def release(self, client: str) -> None:
        if self.fairness:
            self.fairness.release(client)

    async def drain(self) -> None:
        await self.loop.drain()

    def stats(self) -> dict:
        eng = self.zipage.engine
        return {
            "draining": self.loop.draining,
            "backlog": self.loop.backlog,
            "max_queued_requests": self.loop.max_queued_requests,
            "n_running": len(eng.running),
            "n_waiting": len(eng.waiting),
            "free_blocks": eng.bm.num_free,
            "step_count": eng.step_count,
            "clients_inflight": (self.fairness.snapshot()
                                 if self.fairness else {}),
        }
