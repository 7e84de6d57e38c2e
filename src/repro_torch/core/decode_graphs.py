"""One captured CUDA graph per fused decode chunk.

The JAX package jits its fused decode step, so a chunk of k decode+sample
iterations is one dispatch (``repro.core.engine._fused_fn``). Eager PyTorch
issues tens of small operations a layer instead, and the host, not the
card, bounds the step. The port's counterpart of that one dispatch is a
CUDA graph of the chunk: captured once per key (k, greedy or sampled, eos
pad width) and replayed for every chunk of that key. The decode kernel and
the layout are fixed per engine, so they need no place in the key.

Capture follows torch's pattern: a few warm-up calls on a side stream,
then ``torch.cuda.graph``. The warm-up comes first on purpose: a kernel's
first launch may set its shared-memory attribute (``csrc/common.cuh``,
``zp_allow_smem``), which belongs outside a capture. While the warm-up
calls run and the graph is captured the step caps are zero, so no row
decodes and the calls leave the engine's state as it was, whatever it
holds (the JAX package warms its jits the same way, ``_warm_fused``).

A graph reads and writes fixed addresses. The function it captures takes
every input from buffers allocated once and updates the state in place
(``core/serve_model.py``); a caller that replaced a buffer would leave the
graph reading the old one. A graph's outputs are its own buffers, which
its next replay overwrites. All graphs of one owner share one memory pool:
they run one at a time, on one stream.

Launch counts: a kernel wrapper counts a launch in Python when it is
called, so a replay would count nothing. Each graph keeps the launches
made while it was captured and adds them again at every replay; the
counts of the warm-up calls and of the capture itself are taken back,
since those calls decode nothing.

The cyclic garbage collector is off while a graph is captured. A dead
engine in a reference cycle holds its graphs; collected mid-capture, a
graph's destruction is a CUDA call that a capturing stream does not
permit, and it invalidates the capture in progress (seen on the H100 when
an earlier test's engines were collected during a capture).

A capture is confined to the thread that captures
(``capture_error_mode="thread_local"``): the async surface
(``repro_torch.api.aio``) steps the engine, and so captures anew when a
request widens the eos pad, on a worker thread, while the event loop's
thread goes on serving; under the default global mode a CUDA call that
another thread made during the capture would invalidate it.

Nothing here falls back: a failed capture or replay raises. Only an engine
on a CUDA device uses this module; on the CPU the engine calls the chunk
function eagerly.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import native

#: eager calls on a side stream before each capture
WARMUP_CALLS = 3

Key = Tuple[int, bool, int]            # (k, greedy, eos pad width)


class DecodeGraphs:
    """Captured graphs of ``run(k, greedy) -> (tokens (k, B), logprobs
    (k, B))``, a fused chunk on static buffers; ``step_caps`` is the
    buffer of per-row step caps that ``run`` reads, zeroed while a graph
    is being captured."""

    def __init__(self, run: Callable[[int, bool], Tuple[torch.Tensor,
                                                         torch.Tensor]],
                 step_caps: torch.Tensor):
        self.run = run
        self.step_caps = step_caps
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Key, tuple] = {}
        self.replays = 0

    def capture(self, k: int, greedy: bool, width: int) -> None:
        """Capture the chunk of key (k, greedy, width)."""
        counts = dict(native.launch_counts)
        caps = self.step_caps.clone()
        self.step_caps.zero_()
        side = torch.cuda.Stream(device=self.step_caps.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.run(k, greedy)
        torch.cuda.current_stream().wait_stream(side)
        before = dict(native.launch_counts)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = self.run(k, greedy)
        finally:
            if collecting:
                gc.enable()
        launched = {n: native.launch_counts[n] - before[n] for n in before
                    if native.launch_counts[n] != before[n]}
        native.launch_counts.update(counts)
        self.step_caps.copy_(caps)
        self.graphs[(k, greedy, width)] = (graph, out, launched)

    def recapture(self, width: int) -> None:
        """Capture every key anew at eos pad width ``width`` (its buffer
        was replaced), dropping the graphs of the old width first."""
        keys = sorted({(k, greedy) for k, greedy, _ in self.graphs})
        self.graphs.clear()
        self.pool = torch.cuda.graph_pool_handle()
        for k, greedy in keys:
            self.capture(k, greedy, width)

    def replay(self, k: int, greedy: bool, width: int):
        """Replay the graph of (k, greedy, width); returns its output
        buffers (tokens, logprobs), valid until its next replay."""
        entry = self.graphs.get((k, greedy, width))
        if entry is None:
            raise RuntimeError(f"no decode graph captured for chunk k={k} "
                               f"greedy={greedy} eos width={width}")
        graph, out, launched = entry
        graph.replay()
        native.add_launches(launched)
        self.replays += 1
        return out

    def launches(self) -> Dict[Key, Dict[str, int]]:
        """The kernel launches captured in each graph."""
        return {key: dict(entry[2]) for key, entry in self.graphs.items()}
