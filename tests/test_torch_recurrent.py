"""The recurrent configs' model and serving steps, held against the JAX
package: RecurrentGemma-2B (RG-LRU layers beside local-window attention
over a ring of pages) and RWKV6-3B (attention-free), at ``reduced()``
widths (d 64, lru_width 64, 4 heads of 16, window 32) and fp32.

  * the layers (``rglru_forward``, ``rglru_step``, ``causal_conv1d``,
    ``rwkv_forward_naive``, ``rwkv_forward`` chunked with ``valid``,
    ``rwkv_step``, local-window attention) against the JAX functions on
    the same weights and numpy inputs, atol = rtol = 1e-5, and 1e-4 where
    a scan sums in another order than the JAX package's
    (``associative_scan``, ``cumsum``): the port's RG-LRU scan is a
    Hillis-Steele doubling;
  * ``lm.forward`` for both configs and a 5-layer RecurrentGemma (one
    (rglru, rglru, attn) unit and the (rglru, rglru) tail, as the full
    config ends): fp32 at 1e-5, the registered bf16 at a relative L2 of
    2e-2;
  * the serve path against the JAX serve path on prompts that fit one
    prefill call, the ring wrapping in prefill and again in decode past
    position 64, logits at 1e-4;
  * prompts that span several prefill calls (``prefill_len`` 8, or a
    ``max_prefill_chunk`` of 8), against the JAX ``lm.forward`` at 2e-3
    (the tolerance of tests/test_serve_equivalence.py). The JAX serve path
    starts each prefill call's recurrent state from zero, so it is not the
    reference there; the port carries the state across calls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import serve_model as jsm
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.common import chunked_causal_attention
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import serve_model as tsm
from repro_torch.models import layers as TL
from repro_torch.models import lm

TOL = 1e-5
SCAN_TOL = 1e-4
SERVE_TOL = 1e-4
FORWARD_TOL = 2e-3
BF16_REL_L2 = 2e-2
NAMES = ["recurrentgemma-2b", "rwkv6-3b"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced models' ops are too small to gain
    from more, and beside the suite's other workers threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name, **kw):
    jcfg = dataclasses.replace(jget_config(name).reduced(), dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **kw)
    return jcfg, tcfg


def build_model(name, **kw):
    jcfg, tcfg = configs(name, **kw)
    params = jlm.init(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, params=params, tree=tree,
                tparams=params_from_numpy(tcfg, tree))


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    return build_model(request.param)


def layer_params(m, i=0):
    """Layer ``i``'s mixer params in both layouts (a layer of the first
    stacked unit)."""
    kind = m["tcfg"].layer_kinds()[i]
    jp = jax.tree.map(lambda a: a[0], m["params"]["main"][str(i)][kind])
    return kind, jp, m["tparams"]["layers"][i][kind]


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ----------------------------------------------------------------------
# layers


def test_init_tree_matches_jax(model):
    """``lm.init`` draws the tree the JAX package's init carries over to,
    at fp32 and at bf16: the matrices and ``mu`` at the dtype, the
    parameters the JAX package uses uncast (``lm.FP32_KEYS``) in fp32."""
    def shapes(t, prefix=""):
        if isinstance(t, dict):
            return {k: v for key, sub in t.items()
                    for k, v in shapes(sub, f"{prefix}/{key}").items()}
        if isinstance(t, list):
            return {k: v for i, sub in enumerate(t)
                    for k, v in shapes(sub, f"{prefix}/{i}").items()}
        return {prefix: (tuple(t.shape), t.dtype)}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(model["tcfg"],
                                  dtype=str(dtype).split(".")[1])
        want = params_from_numpy(cfg, model["tree"], dtype=dtype)
        got = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        assert shapes(got) == shapes(want)
        kind = cfg.layer_kinds()[0]
        for key, t in got["layers"][0][kind].items():
            assert t.dtype == (torch.float32 if key in lm.FP32_KEYS
                               else dtype), key
        n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            model["params"]))
        assert lm.param_count(got) == n


def test_rglru_layers_match_jax():
    m = build_model("recurrentgemma-2b")
    cfg = m["jcfg"]
    _, jp, tp = layer_params(m)
    x = _x((2, 40, cfg.d_model))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    xw = _x((2, 40, cfg.lru_width), seed=1)
    close(TL.causal_conv1d(tp, torch.from_numpy(xw)),
          JL.causal_conv1d(jp, jnp.asarray(xw)))
    close(TL.rglru_forward(m["tcfg"], tp, xt), JL.rglru_forward(cfg, jp, xj),
          SCAN_TOL)
    js = JL.rglru_init_state(cfg, 2, jnp.float32)
    ts = TL.rglru_init_state(m["tcfg"], 2, torch.float32)
    for t in range(12):
        jo, js = JL.rglru_step(cfg, jp, xj[:, t], js)
        to, ts = TL.rglru_step(m["tcfg"], tp, xt[:, t], ts)
        close(to, jo)
        close(ts["h"], js["h"])
        close(ts["conv"], js["conv"])


def test_rglru_forward_carries_its_state():
    """Two halves, the second from the first's state (the conv history and
    h), give the whole sequence's output and final state; a padded tail
    leaves the state at the last valid step."""
    m = build_model("recurrentgemma-2b")
    cfg, tp = m["tcfg"], layer_params(m)[2]
    x = torch.from_numpy(_x((2, 24, cfg.d_model), seed=2))
    whole = TL.rglru_forward(cfg, tp, x)
    a, st = TL.rglru_forward(cfg, tp, x[:, :10], return_state=True)
    b = TL.rglru_forward(cfg, tp, x[:, 10:], state=st)
    close(torch.cat([a, b], 1), whole, SCAN_TOL)
    pad = torch.arange(16)[None] < torch.tensor([[10], [16]])
    _, st_pad = TL.rglru_forward(cfg, tp, x[:, :16], valid=pad,
                                 return_state=True)
    close(st_pad["h"][0], st["h"][0])
    assert torch.equal(st_pad["conv"][0], st["conv"][0])


def test_rwkv_layers_match_jax():
    m = build_model("rwkv6-3b")
    cfg, tcfg = m["jcfg"], m["tcfg"]
    _, jp, tp = layer_params(m)
    x = _x((2, 64, cfg.d_model))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    close(TL.rwkv_forward_naive(tcfg, tp, xt[:, :40]),
          JL.rwkv_forward_naive(cfg, jp, xj[:, :40]))
    valid = np.arange(64)[None] < np.array([[64], [45]])
    jo, jS = JL.rwkv_forward(cfg, jp, xj, chunk=32, valid=jnp.asarray(valid),
                             return_state=True)
    to, tS = TL.rwkv_forward(tcfg, tp, xt, chunk=32,
                             valid=torch.from_numpy(valid), return_state=True)
    close(to, jo, SCAN_TOL)
    close(tS, jS, SCAN_TOL)
    js = JL.rwkv_init_state(cfg, 2, jnp.float32)
    ts = TL.rwkv_init_state(tcfg, 2, torch.float32)
    for t in range(12):
        jo, js = JL.rwkv_step(cfg, jp, xj[:, t], js)
        to, ts = TL.rwkv_step(tcfg, tp, xt[:, t], ts)
        close(to, jo)
        close(ts["S"], js["S"])


@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_rwkv_forward_carries_its_state(chunk):
    """The chunked form and the token scan from a carried (S, token shift)
    continue the sequence: two halves equal the whole."""
    m = build_model("rwkv6-3b")
    cfg, tp = m["tcfg"], layer_params(m)[2]
    x = torch.from_numpy(_x((2, 64, cfg.d_model), seed=3))
    whole, S_whole = TL.rwkv_forward(cfg, tp, x, chunk=32, return_state=True)
    a, S_a = TL.rwkv_forward(cfg, tp, x[:, :32], chunk=chunk,
                             return_state=True)
    b, S_b = TL.rwkv_forward(cfg, tp, x[:, 32:], chunk=chunk,
                             state={"S": S_a, "shift": x[:, 31]},
                             return_state=True)
    close(torch.cat([a, b], 1), whole, SCAN_TOL)
    close(S_b, S_whole, SCAN_TOL)


def test_memory_planner_takes_the_ring_and_refuses_attention_free():
    """The planner counts a local-window request at its whole ring (no
    compression: N_max's place), and refuses an attention-free config,
    which has no KV block, rather than divide by zero."""
    from repro_torch.core import memory_planner as mp
    cfg = get_config("recurrentgemma-2b")
    plan = mp.plan_memory(cfg, 10 * 2**30, 4, block_size=16, window=4,
                          dtype_bytes=2)
    ring = cfg.local_window // 16
    per_req = plan.m_kv_block * ring + plan.m_q_req
    assert plan.M == 10 * 2**30 // per_req
    with pytest.raises(ValueError, match="attention-free"):
        mp.plan_memory(get_config("rwkv6-3b"), 10 * 2**30, 4, block_size=16)


@pytest.mark.parametrize("window", [0, 16, 32])
def test_local_window_attention_matches_jax(window):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 48, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 48, 1, 16)).astype(np.float32)
    v = rng.normal(size=(2, 48, 1, 16)).astype(np.float32)
    want = chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), local_window=window,
                                    chunk=16)
    got = TL.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), local_window=window)
    close(got, want)


# ----------------------------------------------------------------------
# the whole model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,layers", [("recurrentgemma-2b", None),
                                         ("recurrentgemma-2b", 5),
                                         ("rwkv6-3b", None)])
def test_forward_matches_jax(name, layers, dtype):
    kw = {} if layers is None else {"num_layers": layers}
    m = build_model(name, **kw)
    toks = np.random.default_rng(5).integers(0, m["jcfg"].vocab_size,
                                             (2, 40))
    jcfg = dataclasses.replace(m["jcfg"], dtype=dtype)
    tcfg = dataclasses.replace(m["tcfg"], dtype=dtype)
    want = np.asarray(jlm.forward(jcfg, m["params"], jnp.asarray(toks)),
                      np.float32)
    params = params_from_numpy(tcfg, m["tree"], dtype=lm.torch_dtype(dtype))
    got = lm.forward(tcfg, params, torch.from_numpy(toks)).float().numpy()
    if dtype == "float32":
        close(got, want)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < BF16_REL_L2, rel


# ----------------------------------------------------------------------
# the serve steps


def spec_kw(prefill_len, block_size=4):
    return dict(n_slots=2, block_size=block_size, max_blocks=32,
                n_total_blocks=64, m_qslots=2, window=4, prefill_rows=2,
                prefill_len=prefill_len, dtype="float32")


def tables(cfg, spec):
    """Slot 0 takes blocks 0.., slot 1 blocks 20..: a ring's blocks for a
    local-window config, the whole table width otherwise."""
    n = spec.ring_blocks(cfg) if cfg.local_window else spec.max_blocks // 2
    bt = np.full((2, spec.max_blocks), -1, np.int32)
    bt[0, :n] = np.arange(n)
    bt[1, :n] = 20 + np.arange(n)
    return bt


def prompt_tokens(cfg, lens, n_decode, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n + n_decode) for n in lens]


def port_serve(m, seqs, lens, prefill_len, n_decode, block_size=4):
    """Prefill each row's prompt in calls of ``prefill_len`` tokens, then
    decode ``n_decode - 1`` teacher-forced tokens. Returns the logits of
    each prompt's last prefill call and of every decode step per row, and
    the number of prefill calls per row."""
    cfg = m["tcfg"]
    spec = tsm.ServeSpec(**spec_kw(prefill_len, block_size))
    st = tsm.make_state(cfg, spec, "cpu")
    st["block_tables"].copy_(torch.from_numpy(tables(cfg, spec)))
    prefill = tsm.build_prefill_step(cfg, spec)
    decode = tsm.build_decode_step(cfg, spec)
    done = [0, 0]
    calls = [0, 0]
    last = [None, None]
    while done != list(lens):
        toks = np.zeros((2, prefill_len), np.int64)
        slots, n, start = [-1, -1], [0, 0], [0, 0]
        for i in range(2):
            c = min(prefill_len, lens[i] - done[i])
            if c:
                toks[i, :c] = seqs[i][done[i]:done[i] + c]
                slots[i], n[i], start[i] = i, c, done[i]
        logits = prefill(m["tparams"], st, torch.from_numpy(toks),
                         torch.tensor(slots, dtype=torch.int32),
                         torch.tensor(n, dtype=torch.int32),
                         torch.tensor(start, dtype=torch.int32))
        for i in range(2):
            if n[i]:
                calls[i] += 1
                done[i] += n[i]
                if done[i] == lens[i]:
                    last[i] = logits[i].numpy()
    ring = tsm.ring_tokens(cfg, spec)
    st["positions"].copy_(torch.tensor(lens, dtype=torch.int32))
    st["seq_lens"].copy_(torch.tensor([min(n, ring) if ring else n
                                       for n in lens], dtype=torch.int32))
    out = [[last[0]], [last[1]]]
    active = torch.tensor([True, True])
    for t in range(n_decode - 1):
        tok = torch.tensor([int(seqs[i][lens[i] + t]) for i in range(2)])
        logits = decode(m["tparams"], st, tok, active)
        for i in range(2):
            out[i].append(logits[i].numpy())
    return [np.stack(o) for o in out], calls


def jax_serve(m, seqs, lens, prefill_len, n_decode, block_size=4):
    """The JAX serve path on prompts that fit one prefill call."""
    cfg = m["jcfg"]
    spec = jsm.ServeSpec(**spec_kw(prefill_len, block_size))
    st = jsm.make_state(cfg, spec)
    st["block_tables"] = jnp.asarray(tables(cfg, spec))
    ring = spec.ring_blocks(cfg) * block_size if cfg.local_window else 0
    st["seq_lens"] = jnp.asarray(np.array([min(n, ring) if ring else n
                                           for n in lens], np.int32))
    st["positions"] = jnp.asarray(np.array(lens, np.int32))
    prefill = jax.jit(jsm.build_prefill_step(cfg, spec))
    decode = jax.jit(jsm.build_decode_step(cfg, spec))
    toks = np.zeros((2, prefill_len), np.int32)
    for i in range(2):
        toks[i, :lens[i]] = seqs[i][:lens[i]]
    logits, st = prefill(m["params"], st, jnp.asarray(toks),
                         jnp.asarray(np.array([0, 1], np.int32)),
                         jnp.asarray(np.array(lens, np.int32)),
                         jnp.zeros((2,), jnp.int32))
    out = [[np.asarray(logits[0])], [np.asarray(logits[1])]]
    active = jnp.asarray(np.array([True, True]))
    for t in range(n_decode - 1):
        tok = jnp.asarray(np.array([seqs[i][lens[i] + t] for i in range(2)],
                                   np.int32))
        logits, st = decode(m["params"], st, tok, active)
        for i in range(2):
            out[i].append(np.asarray(logits[i]))
    return [np.stack(o) for o in out]


def test_serve_matches_jax_serve_path_in_one_call(model):
    """A 40-token prompt (the 32-token ring wraps in prefill) and a
    12-token one, each in one prefill call, then 30 decode steps, which
    take the first row past position 64 and wrap its ring again."""
    lens, n_decode = [40, 12], 31
    seqs = prompt_tokens(model["tcfg"], lens, n_decode)
    got, calls = port_serve(model, seqs, lens, 64, n_decode)
    assert calls == [1, 1]
    want = jax_serve(model, seqs, lens, 64, n_decode)
    for g, w in zip(got, want):
        close(g, w, SERVE_TOL)


@pytest.mark.parametrize("lens", [[12, 40], [33, 17]])
def test_prefill_across_calls_matches_forward(model, lens):
    """Prompts fed in calls of 8 tokens (2-5 calls each) carry their
    recurrent state and ring across the calls: their last prefill logits
    and the decode after them match the JAX ``lm.forward`` of the whole
    sequence."""
    n_decode = 12
    seqs = prompt_tokens(model["tcfg"], lens, n_decode, seed=7)
    got, calls = port_serve(model, seqs, lens, 8, n_decode)
    assert calls == [-(-n // 8) for n in lens] and min(calls) >= 2
    for g, seq, n in zip(got, seqs, lens):
        ref = np.asarray(jlm.forward(model["jcfg"], model["params"],
                                     jnp.asarray(seq[None])))[0]
        close(g, ref[n - 1:n - 1 + n_decode], FORWARD_TOL)


def test_engine_splits_match_one_call(model):
    """Through the engine: prompts of 12-40 tokens at ``prefill_len`` 8,
    and at ``prefill_len`` 64 split by ``max_prefill_chunk`` 8, give the
    greedy streams of one-call prefills; each stream's tokens are the
    argmax of the JAX ``lm.forward`` over the prompt and the stream."""
    rng = np.random.default_rng(8)
    prompts = [[int(x) for x in rng.integers(0, model["tcfg"].vocab_size,
                                             n)] for n in (12, 40, 27)]
    sp = SamplingParams(max_new_tokens=12)
    shapes = dict(block_size=4, n_total_blocks=64, max_batch=4,
                  max_model_len=128, prefill_rows=2)
    streams, calls = {}, {}
    for label, kw in (("one", dict(prefill_len=64)),
                      ("len8", dict(prefill_len=8)),
                      ("chunk8", dict(prefill_len=64, max_prefill_chunk=8))):
        z = Zipage(model["tcfg"], model["tparams"], device="cpu", **shapes,
                   **kw)
        eng = z.engine
        inner, n = eng._prefill, [0]

        def counted(*a, **k):
            n[0] += 1
            return inner(*a, **k)
        eng._prefill = counted
        streams[label] = [o.token_ids for o in z.generate(prompts, sp)]
        calls[label] = n[0]
        assert z.num_free_blocks == shapes["n_total_blocks"]
    assert streams["len8"] == streams["one"] == streams["chunk8"]
    assert calls["len8"] >= 5 and calls["chunk8"] >= 5
    for p, s in zip(prompts, streams["one"]):
        seq = np.asarray(p + s[:-1])[None]
        ref = np.asarray(jlm.forward(model["jcfg"], model["params"],
                                     jnp.asarray(seq)))[0]
        assert list(ref[len(p) - 1:].argmax(-1)) == s
