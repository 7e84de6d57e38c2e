"""The ASGI application: OpenAI endpoints over the background engine loop.

Hand-rolled ASGI 3 (stdlib-only — the container ships no web framework);
any ASGI server can host it, the bundled ``repro_torch.serve.http`` bridge
and ``repro_torch.serve.testing.ASGIClient`` being the two in-repo hosts.

Request lifecycle (docs/SERVING.md):

  parse/validate (400) -> fairness priority -> admit
    -> saturated?  429 + Retry-After (load-aware estimate)
    -> draining?   503
    -> stream? SSE frames per engine step, [DONE] terminator
    -> else await the final snapshot, one JSON body

A client disconnect at any point after admission aborts the request —
its slot and blocks return to the pool immediately.
"""
from __future__ import annotations

import asyncio
import json
import math
import time
from typing import Optional

from repro_torch.api.aio import EngineDraining, EngineSaturated
from repro_torch.serve import protocol, streaming
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.protocol import CompletionRequest, ProtocolError
from repro_torch.serve.state import ServerState

JSON_HEADERS = ((b"content-type", b"application/json"),)


async def _send_json(send, status: int, payload: dict, headers=()):
    body = protocol.dumps(payload)
    await send({"type": "http.response.start", "status": status,
                "headers": list(JSON_HEADERS) + list(headers)
                + [(b"content-length", str(len(body)).encode())]})
    await send({"type": "http.response.body", "body": body})


async def _read_body(receive) -> Optional[bytes]:
    """Drain the request body; None if the client already disconnected."""
    chunks = []
    while True:
        msg = await receive()
        if msg["type"] == "http.disconnect":
            return None
        chunks.append(msg.get("body", b""))
        if not msg.get("more_body", False):
            return b"".join(chunks)


async def _watch_disconnect(receive):
    while True:
        msg = await receive()
        if msg["type"] == "http.disconnect":
            return


class ASGIApp:
    """The OpenAI-compatible app. ``app.state`` exposes the engine loop
    to in-process hosts (tests, ``bench_serving``, the CLI)."""

    def __init__(self, state: ServerState):
        self.state = state

    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            await self._lifespan(receive, send)
            return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported scope {scope['type']!r}")
        method, path = scope["method"], scope["path"]
        if path == "/health" and method == "GET":
            stats = self.state.stats()
            await _send_json(send, 503 if stats["draining"] else 200,
                             stats)
        elif path == "/v1/models" and method == "GET":
            await _send_json(send, 200, {"object": "list", "data": [
                {"id": self.state.config.model, "object": "model",
                 "owned_by": "zipage"}]})
        elif path in ("/v1/completions", "/v1/chat/completions"):
            if method != "POST":
                await _send_json(send, 405, protocol.error_body(
                    f"method {method} not allowed; POST only"))
                return
            await self._completions(scope, receive, send,
                                    chat=path.endswith("chat/completions"))
        else:
            await _send_json(send, 404, protocol.error_body(
                f"no route for {method} {path}", code="not_found"))

    async def _lifespan(self, receive, send):
        while True:
            msg = await receive()
            if msg["type"] == "lifespan.startup":
                await send({"type": "lifespan.startup.complete"})
            elif msg["type"] == "lifespan.shutdown":
                await self.state.drain()
                await send({"type": "lifespan.shutdown.complete"})
                return

    # ------------------------------------------------------------------
    def _client_id(self, scope, req: CompletionRequest) -> str:
        headers = {k.decode("latin-1").lower(): v.decode("latin-1")
                   for k, v in scope.get("headers", [])}
        auth = headers.get("authorization", "")
        if auth.lower().startswith("bearer "):
            return auth[7:].strip()
        return (headers.get("x-client-id") or req.client_hint
                or "anonymous")

    async def _completions(self, scope, receive, send, *, chat: bool):
        state = self.state
        body = await _read_body(receive)
        if body is None:
            return                         # gone before we even parsed
        try:
            try:
                parsed = json.loads(body or b"null")
            except ValueError:
                raise ProtocolError("request body is not valid JSON") \
                    from None
            req = CompletionRequest.from_body(parsed, chat=chat)
            state.validate(req)
        except ProtocolError as e:
            await _send_json(send, e.status, protocol.error_body(
                e.message, param=e.param))
            return

        client = self._client_id(scope, req)
        created = int(time.time())
        try:
            rid = await state.admit(req, client)
        except EngineSaturated as e:
            retry = max(1, math.ceil(e.retry_after))
            await _send_json(
                send, 429, protocol.error_body(
                    str(e), err_type="rate_limit_error",
                    code="engine_saturated"),
                headers=[(b"retry-after", str(retry).encode())])
            return
        except EngineDraining:
            await _send_json(send, 503, protocol.error_body(
                "server is draining; retry against another replica",
                err_type="service_unavailable", code="draining"))
            return

        watcher = asyncio.create_task(_watch_disconnect(receive))
        try:
            if req.stream:
                await self._stream_response(send, req, rid, created,
                                            watcher)
            else:
                await self._unary_response(send, req, rid, created,
                                           watcher)
        finally:
            watcher.cancel()
            state.release(client)

    async def _unary_response(self, send, req, rid, created, watcher):
        state = self.state

        async def last_output():
            final = None
            async for out in state.loop.stream_outputs(rid):
                final = out
            return final

        result = asyncio.create_task(last_output())
        done, _ = await asyncio.wait({result, watcher},
                                     return_when=asyncio.FIRST_COMPLETED)
        if result not in done:             # client went away: reclaim
            result.cancel()
            await state.loop.abort(rid)
            return
        await _send_json(send, 200, protocol.completion_response(
            req, result.result(), created))

    async def _stream_response(self, send, req, rid, created, watcher):
        await send({"type": "http.response.start", "status": 200,
                    "headers": list(streaming.SSE_HEADERS)})
        gen = streaming.sse_events(self.state, req, rid, created)
        try:
            while True:
                nxt = asyncio.create_task(anext(gen))
                done, _ = await asyncio.wait(
                    {nxt, watcher}, return_when=asyncio.FIRST_COMPLETED)
                if nxt not in done:        # disconnect mid-stream
                    nxt.cancel()
                    await self.state.loop.abort(rid)
                    return
                try:
                    data = nxt.result()
                except StopAsyncIteration:
                    break
                await send({"type": "http.response.body", "body": data,
                            "more_body": True})
            await send({"type": "http.response.body", "body": b""})
        finally:
            await gen.aclose()


def create_app(config: Optional[ServeConfig] = None,
               zipage=None) -> ASGIApp:
    """Build the serving app. ``zipage`` lets tests/benchmarks inject a
    pre-built facade (skipping model bring-up); otherwise the engine is
    constructed from ``config``."""
    return ASGIApp(ServerState(config or ServeConfig(), zipage))
