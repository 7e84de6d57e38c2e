"""Async-native surface over the ``Zipage`` facade (the port's
``repro.api.aio``).

``AsyncEngineLoop`` owns a background task that drives the engine's
continuous-batching ``step()`` on a single-thread executor while the
event loop stays free for intake and streaming.  All engine mutation is
serialized through that one task: ``add_request`` / ``abort`` enqueue
*ops* that the loop applies between steps, so no two threads ever touch
scheduler state concurrently.  Per-step results fan out to per-request
``asyncio.Queue`` streams via the facade's step listener, marshaled onto
the event loop with ``call_soon_threadsafe``.

This is the layer both the public async API (``Zipage.generate_async`` /
``Zipage.stream``) and the HTTP tier (``repro_torch.serve``) sit on —
the server is a thin protocol adapter, not a privileged engine client.

On the card every CUDA operation of a step runs on the executor's
thread: the decode graphs' replays, a recapture when a request widens
the eos pad (``core/decode_graphs.py`` confines a capture to the thread
that captures), the kernels' launches on that thread's current stream,
and the pinned fetch of each chunk's tokens.  Ops are applied on the
event loop thread, but only while no step runs, so they stay ordered
with the steps on the device's default stream.  The listener and the
step hook read host values only.

Backpressure is bounded and observable: when the waiting backlog reaches
``max_queued_requests``, ``add_request`` raises :class:`EngineSaturated`
carrying a load-aware ``retry_after`` estimate (EWMA of step latency via
the engine's ``step_hooks``).  ``drain()`` implements graceful
shutdown: intake closes (:class:`EngineDraining`), running requests
finish, streams flush, and the loop task exits.  A step that raises is
fanned out to every open stream and re-raised from the loop task: no
failed step is served as a stream.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

from repro_torch.api.outputs import RequestOutput
from repro_torch.core.sampling import SamplingParams


class EngineSaturated(RuntimeError):
    """Waiting-queue backpressure: the engine's backlog is at capacity.

    ``retry_after`` is a load-aware estimate (seconds) of when capacity
    should free up; the HTTP tier maps this to ``429`` + ``Retry-After``.
    """

    def __init__(self, backlog: int, limit: int, retry_after: float):
        super().__init__(
            f"engine saturated: {backlog} queued requests (limit {limit}); "
            f"retry in ~{retry_after:.0f}s")
        self.backlog = backlog
        self.limit = limit
        self.retry_after = retry_after


class EngineDraining(RuntimeError):
    """Intake is closed: the loop is draining toward shutdown (HTTP 503)."""


_DONE = object()      # stream sentinel: request finished, queue closes


class AsyncEngineLoop:
    """Background continuous-batching loop over one ``Zipage`` facade.

    One instance per event loop; create inside a running loop (it binds
    ``asyncio.get_running_loop()`` at ``start()``).
    """

    def __init__(self, zipage, *, max_queued_requests: int = 256):
        self.zipage = zipage
        self.max_queued_requests = max_queued_requests
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        # step() blocks on device work; one worker keeps every engine
        # mutation on a single thread while the event loop serves I/O
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._ops: Optional[asyncio.Queue] = None
        self._streams: Dict[int, asyncio.Queue] = {}
        self._n_intake = 0            # ops enqueued but not yet applied
        self._draining = False
        self._drained: Optional[asyncio.Event] = None
        self._step_ewma: float = 0.05  # seconds; seeded, refined by hooks
        self._failure: Optional[BaseException] = None

    # ------------------------------------------------------------------
    # lifecycle

    async def start(self) -> "AsyncEngineLoop":
        if self._task is not None:
            return self
        self._loop = asyncio.get_running_loop()
        self._ops = asyncio.Queue()
        self._drained = asyncio.Event()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="zipage-step")
        self.zipage.add_listener(self._on_step_outputs)
        self.zipage.engine.step_hooks.append(self._on_step_metrics)
        self._task = self._loop.create_task(self._run(), name="zipage-loop")
        return self

    @property
    def started(self) -> bool:
        return self._task is not None

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def backlog(self) -> int:
        """Requests waiting for a decode slot: intake ops not yet applied
        plus the scheduler's waiting queue (running ones hold capacity
        already and don't count against admission)."""
        return self._n_intake + len(self.zipage.engine.waiting)

    @property
    def retry_after(self) -> float:
        """Seconds until the backlog plausibly has room: one queue drain
        at the EWMA step latency, floored at 1s for header friendliness."""
        return max(1.0, self._step_ewma * max(1, self.backlog))

    async def drain(self) -> None:
        """Graceful shutdown: close intake (new ``add_request`` raises
        :class:`EngineDraining`), let running/waiting requests finish,
        flush their streams, then stop the loop task."""
        self._draining = True
        if self._task is None:
            return
        self._ops.put_nowait(("noop", None, None))   # wake an idle loop
        await self._drained.wait()
        try:
            await self._task
        except BaseException:         # noqa: B036 — kept in self._failure
            pass
        self._teardown()

    async def stop(self) -> None:
        """Fast shutdown: abort everything in flight, then drain."""
        self._draining = True
        if self._task is None:
            return
        for rid in list(self._streams):
            await self._enqueue_op("abort", rid)
        await self.drain()

    def _teardown(self):
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self.zipage.remove_listener(self._on_step_outputs)
        hooks = self.zipage.engine.step_hooks
        if self._on_step_metrics in hooks:
            hooks.remove(self._on_step_metrics)
        self._task = None

    # ------------------------------------------------------------------
    # intake / abort / streams

    async def add_request(self, prompt: Sequence[int],
                          params: Optional[SamplingParams] = None,
                          priority: int = 0) -> int:
        """Admit a request; returns its id once the loop applied the op.

        Raises :class:`EngineSaturated` when the backlog is at
        ``max_queued_requests`` and :class:`EngineDraining` once
        ``drain()`` closed intake.
        """
        if self._draining:
            raise EngineDraining("engine is draining; not accepting requests")
        # backpressure is judged before the loop even spins up, so a
        # saturated engine rejects without scheduling work
        if self.backlog >= self.max_queued_requests:
            raise EngineSaturated(self.backlog, self.max_queued_requests,
                                  self.retry_after)
        if self._task is None:
            await self.start()
        return await self._enqueue_op("add", (list(prompt), params, priority))

    async def abort(self, request_id: int) -> Optional[RequestOutput]:
        """Cancel a request mid-flight (client disconnect). Blocks/slots
        return to the pool; the stream flushes its terminal snapshot
        (``finish_reason="abort"``) and closes."""
        return await self._enqueue_op("abort", request_id)

    def stream_outputs(self, request_id: int) -> AsyncIterator[RequestOutput]:
        """Async-iterate a request's ``RequestOutput`` emissions (each with
        a ``chunk`` delta) until the terminal one (``finished=True``)."""
        q = self._streams.get(request_id)
        if q is None:
            raise KeyError(f"unknown or already-closed stream {request_id}")

        async def _iter():
            while True:
                item = await q.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        return _iter()

    async def generate(self, prompt: Sequence[int],
                       params: Optional[SamplingParams] = None,
                       priority: int = 0) -> RequestOutput:
        """Submit one request and await its final snapshot."""
        rid = await self.add_request(prompt, params, priority)
        final = None
        async for out in self.stream_outputs(rid):
            final = out
        assert final is not None and final.finished
        return final

    # ------------------------------------------------------------------
    # loop internals (everything below runs on the event-loop thread,
    # except the listener/hook bodies marked threadsafe-marshal)

    async def _enqueue_op(self, kind: str, payload):
        fut = self._loop.create_future()
        if kind == "add":
            self._n_intake += 1     # decremented at apply time (loop task)
        self._ops.put_nowait((kind, payload, fut))
        return await fut

    def _apply_op(self, kind: str, payload, fut):
        if kind == "add":
            self._n_intake -= 1
        try:
            if kind == "add":
                prompt, params, priority = payload
                rid = self.zipage.add_request(prompt, params,
                                              priority=priority)
                self._streams[rid] = asyncio.Queue()
                result = rid
            elif kind == "abort":
                result = self.zipage.abort(payload)
                q = self._streams.pop(payload, None)
                if q is not None and result is not None:
                    q.put_nowait(result)
                    q.put_nowait(_DONE)
                elif q is not None:
                    q.put_nowait(_DONE)
            else:                     # "noop": wake-up only
                result = None
        except BaseException as e:    # noqa: B036 — surfaced via future
            if fut is not None and not fut.done():
                fut.set_exception(e)
            return
        if fut is not None and not fut.done():
            fut.set_result(result)

    async def _run(self):
        step = self.zipage.step
        try:
            while True:
                # apply every queued op before the next step so admission
                # order matches arrival order
                while not self._ops.empty():
                    self._apply_op(*self._ops.get_nowait())
                if self.zipage.has_unfinished():
                    await self._loop.run_in_executor(self._executor, step)
                    continue
                if self._draining:
                    break
                self._apply_op(*await self._ops.get())   # idle: park here
        except BaseException as e:    # noqa: B036 — fanned to streams
            self._failure = e
            for q in self._streams.values():
                q.put_nowait(e)
                q.put_nowait(_DONE)
            self._streams.clear()
            raise
        finally:
            self._draining = True
            self._drained.set()

    def _on_step_outputs(self, outs: List[RequestOutput]):
        """Facade step listener — runs on the executor thread; marshal
        the fan-out onto the event loop."""
        self._loop.call_soon_threadsafe(self._fanout, outs)

    def _fanout(self, outs: List[RequestOutput]):
        for out in outs:
            q = self._streams.get(out.request_id)
            if q is None:             # aborted/closed stream: drop
                continue
            q.put_nowait(out)
            if out.finished:
                q.put_nowait(_DONE)
                del self._streams[out.request_id]

    def _on_step_metrics(self, entry: dict):
        """Engine step hook — executor thread; a single float store is
        atomic under the GIL, no marshal needed."""
        self._step_ewma = 0.8 * self._step_ewma + 0.2 * entry["t_total"]
