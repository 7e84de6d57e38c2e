"""In-process ASGI client — drives the app with no sockets (CI-safe).

``ASGIClient.request`` runs one request/response cycle to completion;
``ASGIClient.stream`` returns a handle that exposes SSE events as they
arrive and can simulate a client disconnect mid-stream (the abort-path
races in tests/test_torch_serve.py depend on that).
"""
from __future__ import annotations

import asyncio
import json as _json
from typing import AsyncIterator, List, Optional, Tuple


class Response:
    def __init__(self, status: int, headers: List[Tuple[bytes, bytes]],
                 body: bytes):
        self.status = status
        self.headers = {k.decode("latin-1").lower(): v.decode("latin-1")
                        for k, v in headers}
        self.body = body

    def json(self):
        return _json.loads(self.body)


class StreamHandle:
    """A streaming response in flight. Use as an async context manager;
    iterate ``events()`` for decoded SSE data payloads (the final
    ``[DONE]`` marker is yielded as the string ``"[DONE]"``)."""

    def __init__(self, client: "ASGIClient", scope: dict, body: bytes):
        self._client = client
        self._scope = scope
        self._request_body = body
        self._in: asyncio.Queue = asyncio.Queue()
        self._out: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._buffer = b""
        self._pending: List[dict] = []
        self._closed = False
        self.status: Optional[int] = None
        self.headers: dict = {}

    async def __aenter__(self) -> "StreamHandle":
        self._in.put_nowait({"type": "http.request",
                             "body": self._request_body,
                             "more_body": False})
        self._task = asyncio.create_task(
            self._client.app(self._scope, self._in.get, self._send))
        return self

    async def started(self) -> "StreamHandle":
        """Wait for the response head (status + headers). Not awaited by
        disconnect-before-response tests — entering the context does not
        block on the app."""
        while self.status is None:
            msg = await self._next_message()
            if msg["type"] == "http.response.start":
                self.status = msg["status"]
                self.headers = {
                    k.decode("latin-1").lower(): v.decode("latin-1")
                    for k, v in msg.get("headers", [])}
            else:
                self._pending.append(msg)
        return self

    async def __aexit__(self, *exc):
        if not self._task.done():
            self.disconnect()
            try:
                await asyncio.wait_for(asyncio.shield(self._task), 5)
            except (asyncio.TimeoutError, Exception):
                self._task.cancel()
        else:
            self._task.result()      # surface app exceptions

    async def _send(self, msg):
        self._out.put_nowait(msg)

    async def _next_message(self) -> dict:
        get = asyncio.ensure_future(self._out.get())
        done, _ = await asyncio.wait(
            {get, self._task}, return_when=asyncio.FIRST_COMPLETED)
        if get in done:
            return get.result()
        get.cancel()
        self._task.result()          # raises the app's exception
        raise RuntimeError("app exited without completing the response")

    def disconnect(self):
        """Simulate the client going away: the app's ``receive`` yields
        ``http.disconnect`` next."""
        if not self._closed:
            self._closed = True
            self._in.put_nowait({"type": "http.disconnect"})

    async def events(self) -> AsyncIterator:
        """Decoded SSE payloads in arrival order; ends after [DONE] or
        once the app closes the body."""
        await self.started()
        ended = False
        while not ended:
            msg = (self._pending.pop(0) if self._pending
                   else await self._next_message())
            if msg["type"] != "http.response.body":
                continue
            self._buffer += msg.get("body", b"")
            ended = not msg.get("more_body", False)
            while b"\n\n" in self._buffer:
                frame, self._buffer = self._buffer.split(b"\n\n", 1)
                for line in frame.split(b"\n"):
                    if not line.startswith(b"data: "):
                        continue
                    data = line[6:]
                    if data == b"[DONE]":
                        yield "[DONE]"
                        return
                    yield _json.loads(data)


class ASGIClient:
    def __init__(self, app):
        self.app = app

    def _scope(self, method: str, path: str, headers) -> dict:
        hdrs = [(k.lower().encode("latin-1"), v.encode("latin-1"))
                for k, v in (headers or {}).items()]
        return {"type": "http", "asgi": {"version": "3.0"},
                "http_version": "1.1", "method": method.upper(),
                "scheme": "http", "path": path, "raw_path": path.encode(),
                "query_string": b"", "headers": hdrs,
                "client": ("testclient", 0), "server": ("test", 80)}

    async def request(self, method: str, path: str, *, json=None,
                      body: bytes = b"", headers=None) -> Response:
        if json is not None:
            body = _json.dumps(json).encode()
            headers = dict(headers or {})
            headers.setdefault("content-type", "application/json")
        received = {"sent": False}

        async def receive():
            if not received["sent"]:
                received["sent"] = True
                return {"type": "http.request", "body": body,
                        "more_body": False}
            await asyncio.Event().wait()   # park until app completes

        messages: List[dict] = []

        async def send(msg):
            messages.append(msg)

        await self.app(self._scope(method, path, headers), receive, send)
        start = next(m for m in messages
                     if m["type"] == "http.response.start")
        payload = b"".join(m.get("body", b"") for m in messages
                           if m["type"] == "http.response.body")
        return Response(start["status"], start.get("headers", []),
                        payload)

    def stream(self, method: str, path: str, *, json=None,
               headers=None) -> StreamHandle:
        body = _json.dumps(json).encode() if json is not None else b""
        headers = dict(headers or {})
        headers.setdefault("content-type", "application/json")
        return StreamHandle(self, self._scope(method, path, headers),
                            body)
