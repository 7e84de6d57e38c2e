"""Minimal asyncio HTTP/1.1 host for the ASGI app (stdlib-only).

No ASGI server is a dependency, so ``python -m repro_torch.serve`` hosts
the app on a tiny HTTP/1.1 bridge: one request per connection
(``Connection: close``), chunked transfer for streaming responses, and
connection-EOF surfaced as ``http.disconnect`` so client hang-ups abort
their requests. Production deployments would mount ``create_app()`` on
a real ASGI server instead; the in-process tests use
``repro_torch.serve.testing.ASGIClient``.
"""
from __future__ import annotations

import asyncio

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 8 * 1024 * 1024

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 429: "Too Many Requests",
           500: "Internal Server Error", 503: "Service Unavailable"}


async def _handle(app, reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter):
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
        writer.close()
        return
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, _version = lines[0].split(" ", 2)
    except ValueError:
        writer.close()
        return
    headers = []
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers.append((k.strip().lower().encode("latin-1"),
                            v.strip().encode("latin-1")))
    length = int(dict(headers).get(b"content-length", b"0"))
    body = await reader.readexactly(min(length, MAX_BODY_BYTES)) \
        if length else b""
    path, _, query = target.partition("?")
    scope = {"type": "http", "asgi": {"version": "3.0"},
             "http_version": "1.1", "method": method, "scheme": "http",
             "path": path, "raw_path": path.encode("latin-1"),
             "query_string": query.encode("latin-1"), "headers": headers,
             "client": writer.get_extra_info("peername"),
             "server": writer.get_extra_info("sockname")}

    sent_body = False

    async def receive():
        nonlocal sent_body
        if not sent_body:
            sent_body = True
            return {"type": "http.request", "body": body,
                    "more_body": False}
        # after the body, the only further event is the peer closing the
        # connection — a read returning EOF means the client went away
        try:
            data = await reader.read(1)
        except ConnectionError:
            data = b""
        if data == b"":
            return {"type": "http.disconnect"}
        return {"type": "http.disconnect"}   # pipelining unsupported

    started = False

    async def send(msg):
        nonlocal started
        if msg["type"] == "http.response.start":
            started = True
            status = msg["status"]
            reason = REASONS.get(status, "Unknown")
            hdrs = list(msg.get("headers", []))
            names = {k.lower() for k, _ in hdrs}
            if b"content-length" not in names:
                hdrs.append((b"transfer-encoding", b"chunked"))
            hdrs.append((b"connection", b"close"))
            writer.write(f"HTTP/1.1 {status} {reason}\r\n".encode())
            for k, v in hdrs:
                writer.write(k + b": " + v + b"\r\n")
            writer.write(b"\r\n")
            send.chunked = b"transfer-encoding" not in names \
                and b"content-length" not in names
        elif msg["type"] == "http.response.body":
            data = msg.get("body", b"")
            if getattr(send, "chunked", False):
                if data:
                    writer.write(f"{len(data):x}\r\n".encode() + data
                                 + b"\r\n")
                if not msg.get("more_body", False):
                    writer.write(b"0\r\n\r\n")
            else:
                writer.write(data)
            await writer.drain()
        else:
            raise RuntimeError(f"unexpected ASGI message {msg['type']!r}")

    try:
        await app(scope, receive, send)
    except ConnectionError:
        pass
    except Exception:
        if not started:
            writer.write(b"HTTP/1.1 500 Internal Server Error\r\n"
                         b"content-length: 0\r\nconnection: close\r\n"
                         b"\r\n")
        raise
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except ConnectionError:
            pass


async def run_server(app, host: str, port: int,
                     ready: asyncio.Event = None) -> None:
    """Serve until cancelled (the CLI wires SIGTERM/SIGINT to drain)."""
    server = await asyncio.start_server(
        lambda r, w: _handle(app, r, w), host, port)
    if ready is not None:
        ready.set()
    async with server:
        await server.serve_forever()
