"""The precondition that lets the compaction kernel (``csrc/compaction.cu``)
write a chunk of survivor ranks before the rest of its stripe is read, on
the CPU.

The kernel cuts each (layer, request, head) stripe into chunks of
consecutive ranks and writes chunk c as soon as the reads of chunks 0 .. c
are done, with the reads of a few later chunks already in flight. That is
the sequential plain version's result if rank j's destination is a fresh
slot or cache position j of the request's own table, and the survivors are
in cache order. Here a numpy model of that order of moves is held against
``compact_plain`` (exactly: moves are copies), a case that breaks the
precondition is shown to differ, and the port's copy of the scheduler is
driven through compressions to show that it plans only such destinations.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.kernels import compaction as cmp
from repro_torch.models import lm

#: chunks whose reads may be in flight while a chunk is written
#: (``kStages - 1`` of the kernel's ring)
IN_FLIGHT = 3


def chunked_moves(pools, new_f, src_bt, src_cache, dest_flat, rows, ahead):
    """The kernel's order of moves in numpy: per stripe, chunks of ``rows``
    ranks in ascending order; before chunk c is written, the reads of
    chunks up to c + ``ahead`` are done. pools: {"k", "v": (L, N + 1, b, h,
    d), "f": (L, N + 1, b, h)}, updated copies are returned."""
    out = {n: a.copy() for n, a in pools.items()}
    L, N1, b, h, d = out["k"].shape
    n, k = dest_flat.shape
    for l in range(L):
        flat = {n_: out[n_][l].reshape(N1 * b, h, -1) for n_ in out}
        for i in range(n):
            bt = np.maximum(src_bt[i], 0)
            for hh in range(h):
                pos = src_cache[l, i, hh]
                slots = bt[pos // b] * b + pos % b
                read = {}

                def fetch(c):
                    sl = slice(c * rows, (c + 1) * rows)
                    if c * rows < k and c not in read:
                        read[c] = {n_: flat[n_][slots[sl], hh].copy()
                                   for n_ in ("k", "v")}
                        read[c]["f"] = new_f[l, i, pos[sl], hh][:, None]

                for c in range(-(-k // rows)):
                    for later in range(c, c + ahead + 1):
                        fetch(later)
                    moved = read.pop(c)
                    sl = slice(c * rows, (c + 1) * rows)
                    for n_ in out:
                        flat[n_][dest_flat[i, sl], hh] = moved[n_]
    return out


def case(seed, b=16, h=2, d=2, budget=64, L=2, shift=0):
    """Four requests as the scheduler plans them, on tables of budget + 2
    (+ shift) blocks: two share a source block and compact copy-on-write (a
    fresh block for it, then their own blocks 1 .. budget - 1), one compacts
    wholly in place (its survivors among its first k + b positions, so most
    ranks read a position written by a rank close to them), one is a
    padding row (the sink page). ``shift`` > 0 breaks the precondition: the
    in-place request's rank j lands at cache position j + shift * b of its
    own table."""
    rng = np.random.default_rng(seed)
    mb = budget + 2 + shift
    N = 3 * mb + 4
    free = [int(x) for x in rng.permutation(np.arange(1, N))]
    shared = free.pop()
    src = np.full((4, mb), -1, np.int32)
    src[0] = [shared] + [free.pop() for _ in range(mb - 1)]
    src[1] = [shared] + [free.pop() for _ in range(mb - 1)]
    src[2] = [free.pop() for _ in range(mb)]
    dest = np.full((4, budget), N)
    dest[0] = [free.pop()] + list(src[0, 1:budget])
    dest[1] = [free.pop()] + list(src[1, 1:budget])
    dest[2] = src[2, shift:shift + budget]
    T, kk = mb * b, budget * b
    dest_flat = np.repeat(dest, b, axis=1) * b + np.tile(np.arange(b), budget)
    lens = np.array([T, T - 5, kk + b, 0])
    keys = rng.random((L, 4, h, T)) + (np.arange(T) >= np.maximum(
        lens, kk)[None, :, None, None])
    src_cache = np.sort(np.argsort(keys, axis=-1)[..., :kk], axis=-1)
    pools = {"k": rng.normal(size=(L, N + 1, b, h, d)).astype(np.float32),
             "v": rng.normal(size=(L, N + 1, b, h, d)).astype(np.float32),
             "f": rng.uniform(size=(L, N + 1, b, h)).astype(np.float32)}
    new_f = rng.uniform(size=(L, 4, T, h)).astype(np.float32)
    return pools, new_f, src, src_cache, dest_flat


def plain(pools, new_f, src, src_cache, dest_flat):
    out = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
    cmp.compact_plain(out["k"], out["v"], out["f"], torch.from_numpy(new_f),
                      torch.from_numpy(src), torch.from_numpy(src_cache),
                      torch.from_numpy(dest_flat))
    return {n: a.numpy() for n, a in out.items()}


def same_but_sink(a, b):
    return all(np.array_equal(a[n][:, :-1], b[n][:, :-1]) for n in a)


@pytest.mark.parametrize("budget", [3, 30, 64])
@pytest.mark.parametrize("rows", [1, 7, 32, None])
def test_chunked_order_matches_plain(budget, rows):
    """Chunks of 1, 7, 32 and k ranks, with no read ahead and with the
    kernel's IN_FLIGHT chunks ahead, at budgets of 3, 30 and 64 blocks
    (k = 48, 480, 1024)."""
    args = case(budget, budget=budget)
    want = plain(*args)
    assert not same_but_sink(want, args[0])       # the case moves data
    rows = rows or budget * 16
    for ahead in (0, IN_FLIGHT):
        got = chunked_moves(*args, rows=rows, ahead=ahead)
        assert same_but_sink(got, want), (rows, ahead)


@pytest.mark.parametrize("rows", [1, 7, 32])
def test_chunked_order_breaks_without_the_precondition(rows):
    """Rank j of the in-place request lands at cache position j + 10 b,
    beyond the reads in flight: a chunk's writes then clobber positions a
    later chunk still has to read, so the chunked order differs from the
    sequential plain version (which reads a request's whole stripe
    first)."""
    args = case(1, budget=30, shift=10)
    want = plain(*args)
    assert same_but_sink(chunked_moves(*args, rows=30 * 16, ahead=0), want)
    for ahead in (0, IN_FLIGHT):
        assert not same_but_sink(chunked_moves(*args, rows=rows, ahead=ahead),
                                 want)


def checking(eng):
    """Hold every compression launch the engine plans to the kernel's
    precondition: each destination block is block i of the request's own
    table, or a block in no table of the launch. Returns counts of the
    launches by kind: in place or copy-on-write, and launches of requests
    that adopted a compressed segment or came back by swap-in."""
    seen = {"in_place": 0, "copy_on_write": 0, "adopted": 0,
            "swapped_in": 0}
    launch = eng._launch_compression

    def checked(outs):
        tables = {blk for c in outs.compress for blk in c.request.blocks}
        for c in outs.compress:
            blocks = c.request.blocks
            assert len(c.dest) == eng.budget_blocks <= len(blocks)
            fresh = [blk for i, blk in enumerate(c.dest) if blk != blocks[i]]
            assert not set(fresh) & tables, (c.dest, blocks)
            seen["copy_on_write" if fresh else "in_place"] += 1
            seen["adopted"] += c.request.pos_gap > 0
            seen["swapped_in"] += c.request.n_swaps > 0
        return launch(outs)

    eng._launch_compression = checked
    return seen


def test_scheduler_plans_destinations_the_kernel_takes():
    """The port's scheduler, driven through compressions of requests with
    a shared, cached prompt prefix (copy-on-write) and without one (in
    place): every planned destination block is block i of the request's
    own table, or a block in no table of the launch."""
    cfg = get_config("tiny-lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    z = Zipage(cfg, params, device="cpu", block_size=8, n_total_blocks=64,
               max_batch=4, max_model_len=128, prefill_rows=2,
               prefill_len=64)
    seen = checking(z.engine)
    prefix = list(range(1, 33))
    prompts = [prefix + [40 + i] * (3 + 5 * i) for i in range(3)]
    prompts.append(list(range(100, 127)))
    outs = z.generate(prompts, SamplingParams(max_new_tokens=40))
    outs += z.generate([prefix[:24] + [7, 8, 9]],
                       SamplingParams(max_new_tokens=30))
    assert min(o.metrics.compression.n_compressions for o in outs) > 0
    assert seen["in_place"] > 0 and seen["copy_on_write"] > 0, seen
    assert z.num_free_blocks == 64
    z.bm.check_invariants()


def test_adopters_plan_destinations_the_kernel_takes():
    """Requests that adopt a compressed segment hold its payload at the
    front of their tables (shared, copy-on-write protected); their later
    compressions copy it into fresh blocks and keep the rest in place."""
    cfg = get_config("tiny-lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    z = Zipage(cfg, params, device="cpu", block_size=8, n_total_blocks=64,
               max_batch=4, max_model_len=128, prefill_rows=2,
               prefill_len=64, cache_compressed_prefixes=True,
               prefix_cache_watermark=0.05)
    seen = checking(z.engine)
    prefix = list(range(1, 33))
    z.generate([prefix], SamplingParams(max_new_tokens=8))
    assert z.bm.segments
    outs = z.generate([prefix + [40 + i, 50 + i] for i in range(3)],
                      SamplingParams(max_new_tokens=40))
    assert all(o.metrics.compression.n_compressions for o in outs)
    assert seen["adopted"] > 0 and seen["copy_on_write"] > 0, seen
    assert z.num_free_blocks == 64
    z.bm.check_invariants()


@pytest.mark.parametrize("mode", ["swap", "auto"])
def test_swapped_in_requests_plan_destinations_the_kernel_takes(mode):
    """A swap-in gives the request all-new blocks and no shared prefix;
    its later compressions stay in place on its own table. (``auto`` runs
    at ``swap_cost_per_token=0.1`` here, so that it picks swap.)"""
    cfg = get_config("tiny-lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    z = Zipage(cfg, params, device="cpu", block_size=8, n_total_blocks=10,
               max_batch=4, m_qslots=4, n_max=3, max_model_len=256,
               prefill_rows=2, prefill_len=64, preemption_mode=mode,
               swap_space_blocks=24, swap_cost_per_token=0.1)
    seen = checking(z.engine)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [10, 11, 12, 13, 14, 15, 16],
               [20, 21]]
    outs = z.generate(prompts, SamplingParams(max_new_tokens=60))
    assert sum(m["n_swapped_in"] for m in z.metrics) > 0
    assert seen["swapped_in"] > 0, seen
    assert all(len(o.token_ids) == 60 for o in outs)
    assert z.num_free_blocks == 10
    z.bm.check_invariants()
