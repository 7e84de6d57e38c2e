"""Server-sent events over the engine's per-request output stream.

``sse_events`` adapts ``AsyncEngineLoop.stream_outputs`` to the OpenAI
SSE wire format: one ``data: {json}\\n\\n`` frame per engine step that
grew the request, ``finish_reason`` on the terminal frame, an optional
trailing usage frame (``stream_options.include_usage``), then the
literal ``data: [DONE]`` terminator.
"""
from __future__ import annotations

from typing import AsyncIterator

from repro_torch.serve import protocol

SSE_HEADERS = ((b"content-type", b"text/event-stream; charset=utf-8"),
               (b"cache-control", b"no-cache"),
               (b"connection", b"keep-alive"))
DONE_FRAME = b"data: [DONE]\n\n"


def frame(payload: dict) -> bytes:
    return b"data: " + protocol.dumps(payload) + b"\n\n"


async def sse_events(state, req: protocol.CompletionRequest, rid: int,
                     created: int) -> AsyncIterator[bytes]:
    """Yield SSE frames for one admitted request until it finishes."""
    first = True
    usage = None
    async for out in state.loop.stream_outputs(rid):
        chunk = out.chunk
        tokens = chunk.token_ids if chunk is not None else []
        reason = out.finish_reason if out.finished else None
        if chunk is not None and chunk.usage is not None:
            usage = chunk.usage
        elif out.finished:
            usage = out.usage
        if not tokens and not out.finished and not first:
            continue                      # empty intermediate: drop
        yield frame(protocol.chunk_payload(
            req, rid, tokens, reason, created, first=first))
        first = False
    if req.include_usage:
        yield frame(protocol.usage_chunk_payload(req, rid, usage, created))
    yield DONE_FRAME
