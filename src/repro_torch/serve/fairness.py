"""Per-client fairness: map client identity onto scheduler priority.

One aggressive client must not starve the rest. Each admission is
tagged ``priority = -inflight(client)`` (the count *before* this
request), so under the engine's "priority" admission policy a client's
second queued request sorts behind every other client's first — an
approximate least-loaded round-robin with zero new scheduler machinery
(docs/SERVING.md "Fairness").
"""
from __future__ import annotations

from typing import Dict


class ClientFairness:
    def __init__(self):
        self._inflight: Dict[str, int] = {}

    def admit(self, client: str) -> int:
        """Account an admission; returns the priority for this request."""
        n = self._inflight.get(client, 0)
        self._inflight[client] = n + 1
        return -n

    def release(self, client: str) -> None:
        n = self._inflight.get(client, 0) - 1
        if n <= 0:
            self._inflight.pop(client, None)
        else:
            self._inflight[client] = n

    def inflight(self, client: str) -> int:
        return self._inflight.get(client, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._inflight)
