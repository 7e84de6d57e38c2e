"""bfloat16 serving: the port at ``dtype="bfloat16"``, held against the JAX
package's bf16 path and against itself.

bf16 rounds at different places in the two frameworks (XLA's CPU bf16
logistic is not correctly rounded, and XLA fuses bf16 elementwise chains
with excess precision), so the port's bf16 greedy streams cannot be
required to equal the JAX package's. What is held, level by level:

L0  the kernels' plain versions against ``repro.kernels.ops`` (backends
    "jnp" and "pallas-interpret") on identical bf16 inputs, at g = 1, 4,
    6 and 8 and on idle slots: fp32 outputs (window logits, redundancy)
    to atol = rtol = 1e-5, bf16 outputs (decode attention) to one bf16
    ulp (atol = rtol = 2**-7: both round an fp32 result once), compaction
    bit for bit;
L1  the single ops on identical inputs, each bit for bit or within one
    bf16 ulp, as each test says. The gated FFN's activation is neither
    (XLA's bf16 sigmoid): its two products and its down-projection are
    held instead, its activation against the correctly rounded one, and
    the share of its outputs that differ from JAX's is printed;
L2  the forward of every config at ``reduced()``
    (tests/test_torch_configs.py): bf16 out, relative L2 to the JAX
    package's bf16 forward at most 2e-2;
L3  the serve steps, teacher-forced with the JAX package's greedy tokens
    (tests/test_torch_model.py), and compression on identical bf16 pools
    (tests/test_torch_compression.py);
L4  here again: the port's own invariants at bf16, bit for bit, through
    the engine on the CPU with compression firing: K = 8 == K = 1 ==
    unfused, ragged == dense, swap == an ample pool, raw prefix hits ==
    cold, snapshot/restore, and the sanitizer clean throughout. The
    port's bf16 streams against the JAX engine's are measured, not gated:
    the first position where they part is printed.

Every test asserts the dtypes it relies on (pools, windows, weights,
outputs), so that none passes at fp32 by mistake.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.compression import CompressOptions as JCompress
from repro.core.compression import _compact_pool
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import ZipageEngine as JEngine
from repro.core import paged as jpaged
from repro.core.sampling import SamplingParams as JSP
from repro.kernels import ops as jops
from repro.models import common as JC
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression, invariants
from repro_torch.core import paged as tpaged
from repro_torch.core.compression import CompressOptions
from repro_torch.core.engine import EngineOptions, ZipageEngine
from repro_torch.core.sampling import SamplingParams
from repro_torch.kernels import ops
from repro_torch.models import common as TC
from repro_torch.models import layers as TL
from repro_torch.models import lm

BF = torch.bfloat16
F32_TOL = 1e-5           # fp32 outputs from bf16 inputs
ULP = 2.0 ** -7          # one bf16 ulp, relative (8 significant bits)
#: (h_q, h_kv) at g = 1, 4, 6 and 8
LAYOUTS = {1: (4, 4), 4: (8, 2), 6: (12, 2), 8: (16, 2)}
CONFIGS = ["qwen3-8b", "llama3-8b", "qwen2.5-3b", "olmo-1b",
           "nemotron-4-15b"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes are too small to gain from more,
    and beside the suite's other workers the threads contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_bf16(a):
    """fp32 numpy -> (the JAX package's bf16 array, the port's bf16 tensor)
    holding the same values."""
    j = jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j, np.float32)).to(BF)
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(j).view(np.int16))
    return j, t


def f32(a):
    """Any array or tensor as fp32 numpy (exact for bf16)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def bits(a):
    """bf16 bits as int32, for ulp distances."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def assert_within_ulp(got, want, name):
    """Both bf16; equal, or apart by at most one bf16 ulp."""
    assert got.dtype == BF, (name, got.dtype)
    assert np.asarray(want).dtype == jnp.bfloat16, (name, want.dtype)
    np.testing.assert_allclose(f32(got), f32(want), rtol=ULP, atol=ULP,
                               err_msg=name)


def assert_bits_equal(got, want, name):
    assert got.dtype == BF, (name, got.dtype)
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)


def rel_l2(got, want):
    g, w = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


# ----------------------------------------------------------------------
# L0: the kernels' plain versions against repro.kernels.ops at bf16


def decode_case(hq, hkv, lens, seed, d=16, b=4, mb=6, n_pages=32,
                similar=False):
    """fp32 q, pools and -1 padded tables; live pages never include page
    0."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(len(lens), hq, d)).astype(np.float32)
    kp = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    if similar:
        kp = 0.3 * kp + rng.normal(size=(n_pages, 1, hkv, d)).astype(
            np.float32)
    vp = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    sl = np.asarray(lens, np.int32)
    bt = np.full((len(lens), mb), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
    return q, kp, vp, bt, sl


def poisoned(t, bt, sl, b):
    """A copy of pool ``t`` whose page 0 and each row's stale tail are NaN:
    nothing of them may reach a live output."""
    t = t.clone()
    t[0] = float("nan")
    for i, s in enumerate(sl):
        if s % b:
            t[int(bt[i, s // b]), s % b:] = float("nan")
    return t


@pytest.mark.parametrize("backend", ["jnp", "pallas-interpret"])
@pytest.mark.parametrize("g", sorted(LAYOUTS))
def test_plain_kernels_match_jax_at_bf16(g, backend):
    """K1, B4, K2, K3 and B5 on identical bf16 inputs: decode outputs bf16
    within one ulp, window logits and redundancy fp32 within 1e-5; the
    port's inputs carry a NaN page 0 and NaN stale tails, the JAX
    package's the clean pool."""
    hq, hkv = LAYOUTS[g]
    b = 4
    lens = [0, 5, 24, 13]
    q, kp, vp, bt, sl = decode_case(hq, hkv, lens, seed=g, similar=True)
    (jq, tq), (jk, tk), (jv, tv) = to_bf16(q), to_bf16(kp), to_bf16(vp)
    tk_p, tv_p = poisoned(tk, bt, sl, b), poisoned(tv, bt, sl, b)
    tbt, tsl = torch.from_numpy(bt), torch.from_numpy(sl)

    ragged = ops.ragged_decode_attention(tq, tk_p, tv_p, tbt, tsl)
    dense = ops.paged_decode_attention(tq, tk_p, tv_p, tbt, tsl)
    for got, fn in ((ragged, jops.ragged_decode_attention),
                    (dense, jops.paged_decode_attention)):
        want = fn(jq, jk, jv, bt, sl, backend=backend)
        assert_within_ulp(got, want, fn.__name__)
        assert (got[tsl == 0] == 0).all()
    live = tsl > 0
    assert torch.equal(ragged[live], dense[live])

    rng = np.random.default_rng(100 + g)
    jw, tw = to_bf16(rng.normal(size=(len(lens), 4, hq, 16)))
    cbt = np.maximum(bt, 0)           # the JAX compression clamps its tables
    got = ops.score_logits(tw, tk_p, tbt, tsl)
    want = jops.score_logits(jw, jk, cbt, sl, backend=backend)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    for got, fn in ((ops.lightning_redundancy(tk_p, tbt, tsl),
                     jops.lightning_redundancy),
                    (ops.flash_redundancy(tk_p, tbt, tsl),
                     jops.flash_redundancy)):
        want = fn(jk, cbt, sl, p_thresh=0.8, backend=backend)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=fn.__name__)


@pytest.mark.parametrize("g", sorted(LAYOUTS))
def test_decode_on_idle_slots_at_bf16(g):
    """What the serve passes for a slot that decodes nothing: seq_len >= 1
    over an empty table, and a -1 entry below seq_len, read as page 0 (the
    TPU kernels' clamp), at bf16 against the JAX package's reference."""
    hq, hkv = LAYOUTS[g]
    q, kp, vp, bt, sl = decode_case(hq, hkv, [1, 1, 9, 17], seed=40 + g)
    bt[:2] = -1
    bt[2, 0] = -1
    (jq, tq), (jk, tk), (jv, tv) = to_bf16(q), to_bf16(kp), to_bf16(vp)
    args = (tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(sl))
    ragged = ops.ragged_decode_attention(*args)
    dense = ops.paged_decode_attention(*args)
    assert torch.equal(ragged, dense)
    want = jops.ragged_decode_attention(jq, jk, jv, bt, sl, backend="jnp")
    assert_within_ulp(ragged, want, "idle slots")


def test_compaction_moves_bf16_bits_as_jax():
    """B6 on bf16 K/V and fp32 F pools, in place with overlapping ranks,
    copy-on-write and a padding row, against the JAX engine's
    ``_compact_pool`` per request: bit for bit."""
    rng = np.random.default_rng(7)
    L, b, h, d, budget = 2, 4, 2, 16, 3
    mb, N = budget + 1, 16
    (jk, tk), (jv, tv) = (to_bf16(rng.normal(size=(L, N, b, h, d)))
                          for _ in range(2))
    f = rng.uniform(size=(L, N, b, h)).astype(np.float32)
    free = [int(x) for x in rng.permutation(np.arange(1, N))]
    shared = free.pop()
    src = np.full((4, mb), -1, np.int32)
    src[0] = [shared] + [free.pop() for _ in range(mb - 1)]
    src[1] = [shared] + [free.pop() for _ in range(mb - 1)]
    src[2] = [free.pop() for _ in range(mb)]
    dest = np.full((4, budget), N, np.int64)        # the sink page
    dest[0] = [free.pop()] + list(src[0, 1:budget])
    dest[1] = [free.pop()] + list(src[1, 1:budget])
    dest[2] = src[2, :budget]
    T, kk = mb * b, budget * b
    src_cache = np.sort(np.stack([np.stack([np.stack([
        rng.choice(T, kk, replace=False) for _ in range(h)])
        for _ in range(4)]) for _ in range(L)]), axis=-1).astype(np.int64)
    new_f = rng.uniform(size=(L, 4, T, h)).astype(np.float32)
    dest_flat = np.repeat(dest, b, axis=1) * b + np.tile(np.arange(b),
                                                         budget)

    def sink(a):
        return torch.cat([a, torch.zeros_like(a[:, :1])], 1)
    pools = [sink(tk), sink(tv), sink(torch.from_numpy(f))]
    assert pools[0].dtype == BF and pools[2].dtype == torch.float32
    ops.compact(*pools, torch.from_numpy(new_f), torch.from_numpy(src),
                torch.from_numpy(src_cache), torch.from_numpy(dest_flat))
    jflat = np.where(dest_flat >= N * b, 2**30, dest_flat)
    heads = np.arange(h)[:, None]
    for l in range(L):
        kl, vl, fl = jk[l], jv[l], jnp.asarray(f[l].reshape(-1, h))
        for i in range(4):
            cbt = np.maximum(src[i], 0)
            kl = _compact_pool(kl, cbt, src_cache[l, i], jflat[i])
            vl = _compact_pool(vl, cbt, src_cache[l, i], jflat[i])
            fl = fl.at[jflat[i][None, :], heads].set(
                new_f[l, i].T[heads, src_cache[l, i]], mode="drop")
        assert_bits_equal(pools[0][l, :N], kl, "k")
        assert_bits_equal(pools[1][l, :N], vl, "v")
        np.testing.assert_array_equal(pools[2][l, :N].numpy(),
                                      np.asarray(fl).reshape(N, b, h))


def test_bf16_wrapper_checks_refuse_cpu_and_other_dtypes():
    """The CUDA wrappers' checks take bf16 but refuse a CPU tensor before
    any launch, and refuse a dtype no kernel reads."""
    from repro_torch.kernels import _checks
    q = torch.zeros(2, 4, 16, dtype=BF)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _checks.kv_tensors("k", torch.device("cpu"), q=q)
    with pytest.raises(ValueError, match="one of"):
        _checks.kv_tensors("k", torch.device("cpu"),
                           q=q.to(torch.float64))


# ----------------------------------------------------------------------
# L1: the single ops on identical inputs


def layer_weights(name, seed=0):
    """A reduced config's first layer in both packages, at bf16: the JAX
    package's fp32 params (it casts at use) and the port's bf16 ones."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    params = jlm.init(jcfg, jax.random.key(seed))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                dtype=BF)
    jp = jax.tree.map(lambda a: a[0], params["main"]["0"])
    tp = tparams["layers"][0]
    assert tp["attn"]["wq"].dtype == BF and tp["ffn"]["w1"].dtype == BF
    for norm in (tp["ln1"], tp["ln2"], tparams["final_norm"]):
        assert all(v.dtype == torch.float32 for v in norm.values())
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", CONFIGS)
def test_attention_ops_match_jax_at_bf16(name):
    """apply_norm bit for bit (fp32 math, rounded once). Within one ulp:
    attn_qkv (with qk-norm or qkv bias where the config has them: a bf16
    product's sum order differs between the two CPU backends, which moves
    an output by an ulp now and then), apply_rope (the two frameworks'
    fp32 sin and cos of large angles may differ in the last bit), causal
    attention and paged prefill attention (fp32 math, rounded once)."""
    jcfg, tcfg, jp, tp = layer_weights(name)
    rng = np.random.default_rng(1)
    B, S = 2, 8
    jx, tx = to_bf16(rng.normal(size=(B, S, jcfg.d_model)))
    assert_bits_equal(TC.apply_norm(tcfg, tp["ln1"], tx),
                      JC.apply_norm(jcfg, jp["ln1"], jx), "apply_norm")
    jqkv = JL.attn_qkv(jcfg, jp["attn"], jx)
    tqkv = TL.attn_qkv(tcfg, tp["attn"], tx)
    for n, got, want in zip("qkv", tqkv, jqkv):
        assert_within_ulp(got, want, f"attn_qkv {n}")
    pos = np.tile(np.arange(S), (B, 1)).astype(np.int32)
    jq, jk = (JC.apply_rope(a, jnp.asarray(pos), jcfg.rope_theta)
              for a in jqkv[:2])
    tq, tk = (TC.apply_rope(a, torch.from_numpy(pos), tcfg.rope_theta)
              for a in tqkv[:2])
    assert_within_ulp(tq, jq, "apply_rope q")
    assert_within_ulp(tk, jk, "apply_rope k")
    assert_within_ulp(TL.causal_attention(tq, tk, tqkv[2]),
                      JC.chunked_causal_attention(jq, jk, jqkv[2]),
                      "causal_attention")
    # the same keys and values paged: 2 rows, the second starting at 3
    b, mb = 4, 4
    hkv, d = jcfg.num_kv_heads, jcfg.head_dim
    kp, vp = (rng.normal(size=(12, b, hkv, d)) for _ in range(2))
    (jkp, tkp), (jvp, tvp) = to_bf16(kp), to_bf16(vp)
    bt = np.array([[3, 7, 1, 9], [2, 11, 4, 5]], np.int32)
    start = np.array([0, 3], np.int32)
    kv_lens = start + S
    got = tpaged.paged_prefill_attention(tq, tkp, tvp, torch.from_numpy(bt),
                                         torch.from_numpy(start),
                                         torch.from_numpy(kv_lens))
    want = jpaged.paged_prefill_attention(jq, jkp, jvp, bt, start, kv_lens)
    assert_within_ulp(got, want, "paged_prefill_attention")


@pytest.mark.parametrize("name", CONFIGS)
def test_ffn_matches_jax_at_bf16(name, capsys):
    """sq_relu FFN (Nemotron) within one ulp. The gated FFN: its two
    products within one ulp (as attn_qkv's), the port's activation within
    one ulp of the correctly rounded silu(a) * b of its own products, and
    the down-projection of the JAX package's activation within one ulp;
    XLA's bf16 sigmoid is not correctly rounded, so the share of gated
    outputs that differ from JAX's is printed, and their relative L2 is
    held to 2e-2."""
    jcfg, tcfg, jp, tp = layer_weights(name)
    rng = np.random.default_rng(2)
    jx, tx = to_bf16(rng.normal(size=(2, 8, jcfg.d_model)))
    got = TL.ffn_forward(tcfg, tp["ffn"], tx)
    want = JL.ffn_forward(jcfg, jp["ffn"], jx)
    if "w3" not in tp["ffn"]:
        assert jcfg.ffn_act == "sq_relu"
        assert_within_ulp(got, want, "sq_relu ffn")
        return
    ja = jx @ jp["ffn"]["w1"].astype(jnp.bfloat16)
    jb = jx @ jp["ffn"]["w3"].astype(jnp.bfloat16)
    ta, tb = tx @ tp["ffn"]["w1"], tx @ tp["ffn"]["w3"]
    assert_within_ulp(ta, ja, "w1 product")
    assert_within_ulp(tb, jb, "w3 product")
    act = TC.ffn_act_fn(tcfg.ffn_act)(ta, tb)
    a64, b64 = f32(ta).astype(np.float64), f32(tb).astype(np.float64)
    exact = a64 / (1.0 + np.exp(-a64)) * b64
    np.testing.assert_allclose(f32(act), exact, rtol=ULP, atol=ULP)
    jact = JC.ffn_act_fn(jcfg.ffn_act)(ja, jb)
    _, tjact = to_bf16(np.asarray(jact, np.float32))
    assert_within_ulp(tjact @ tp["ffn"]["w2"],
                      jact @ jp["ffn"]["w2"].astype(jnp.bfloat16),
                      "down-projection")
    share = float(np.mean(f32(got) != f32(want)))
    with capsys.disabled():
        print(f"\n{name}: gated FFN at bf16: {share:.1%} of outputs differ "
              f"from the JAX package's (activation: "
              f"{float(np.mean(f32(act) != f32(jact))):.1%}), relative L2 "
              f"{rel_l2(got, want):.2e}")
    assert rel_l2(got, want) <= 2e-2


# ----------------------------------------------------------------------
# L4: the port's own invariants at bf16, through the engine

SHAPES = dict(block_size=8, n_total_blocks=64, max_batch=4, m_qslots=4,
              n_max=3, window=4, max_model_len=256, prefill_rows=2,
              prefill_len=64)
TIGHT = dict(SHAPES, n_total_blocks=10)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [10, 11, 12, 13, 14, 15, 16],
           [20, 21]]
MIXED = [dict(max_new_tokens=28),
         dict(max_new_tokens=28, temperature=0.8, top_k=5, seed=7),
         dict(max_new_tokens=28, temperature=1.1, top_p=0.9, seed=3),
         dict(max_new_tokens=28, temperature=0.7, seed=11, logprobs=True)]


@pytest.fixture(autouse=True)
def sanitized(monkeypatch):
    """Every port engine audits its whole state after each step."""
    monkeypatch.setattr(invariants, "enabled", lambda: True)


@pytest.fixture(scope="module")
def weights():
    """tiny-lm's JAX weights (fp32, cast at use) and the port's at bf16."""
    jcfg = dataclasses.replace(jget_config("tiny-lm"), dtype="bfloat16")
    jparams = jlm.init(jcfg, jax.random.key(0))
    tparams = params_from_numpy(get_config("tiny-lm"),
                                jax.tree.map(np.asarray, jparams), dtype=BF)
    return jcfg, jparams, tparams


@pytest.fixture
def margins(monkeypatch):
    """The smallest k-th vs (k+1)-th final-score margin of each compression
    the port runs. Within the port every run does the same arithmetic, so
    near-ties cannot flip between the runs compared here: the margins only
    show that compression ran."""
    seen = []
    select = compression._select_survivors

    def recording(cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                  hist_lens, T):
        out = select(cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                     hist_lens, T)
        top = torch.sort(out[3], dim=1, descending=True)[0]
        live = seq_lens > 0
        if bool(live.any()):
            seen.append(float((top[:, k_keep - 1]
                               - top[:, k_keep])[live].min()))
        return out

    monkeypatch.setattr(compression, "_select_survivors", recording)
    return seen


def make_engine(weights, **kw):
    opts = dict(SHAPES, compress=CompressOptions(window=4), dtype="bfloat16")
    opts.update(kw)
    eng = ZipageEngine(get_config("tiny-lm"), weights[2],
                       EngineOptions(**opts), device="cpu")
    pools = eng.state["pools"]
    assert pools["k"].dtype == pools["v"].dtype == BF
    assert eng.state["qwin"].dtype == BF
    assert pools["f"].dtype == torch.float32
    assert eng.params["embed"].dtype == BF
    assert eng.sanitize
    return eng


def serve(weights, prompts=PROMPTS, sps=MIXED, **kw):
    eng = make_engine(weights, **kw)
    rids = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(prompts, sps)]
    done = eng.run(max_steps=2000)
    return [(done[r].output, done[r].logprobs) for r in rids], eng


def total(eng, key):
    return sum(m[key] for m in eng.metrics)


@pytest.fixture(scope="module")
def reference(weights):
    """The port's bf16 streams at the defaults (K = 1, ragged, ample)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(invariants, "enabled", lambda: True)
        out, eng = serve(weights)
    assert total(eng, "n_compressing") > 0
    return out


@pytest.mark.parametrize("mode", [
    dict(decode_steps=8), dict(fuse_sampling=False),
    dict(decode_kernel="dense"),
    dict(compress=CompressOptions(window=4, redundancy="flash"),
         decode_steps=8),
])
def test_decode_modes_give_one_stream_at_bf16(weights, reference, margins,
                                              mode):
    """K = 8 == K = 1 == unfused, and dense decode == ragged, tokens and
    logprobs bit for bit, with compression firing; flash redundancy, a
    different score, is held between K = 8 and K = 1 on its own."""
    got, eng = serve(weights, **mode)
    assert margins                       # compressions ran
    if "compress" in mode:
        want, _ = serve(weights, compress=mode["compress"])
    else:
        want = reference
    assert got == want
    assert total(eng, "n_compressing") > 0
    if mode.get("decode_steps", 1) > 1:
        assert max(m["decode_horizon"] for m in eng.metrics) > 1


@pytest.mark.parametrize("mode", [
    dict(preemption_mode="swap", swap_space_blocks=24),
    dict(preemption_mode="auto", swap_space_blocks=24, decode_steps=8),
])
def test_swap_equals_an_ample_pool_at_bf16(weights, reference, margins,
                                           mode):
    """At tests/test_torch_swap.py's tight shapes the runs preempt and
    swap bf16 blocks out and back bit for bit: the streams equal the ample
    pool's."""
    got, eng = serve(weights, **TIGHT, **mode)
    assert margins                       # compressions ran
    assert got == reference
    assert total(eng, "n_preempted") > 0
    assert total(eng, "n_swapped_out") == total(eng, "n_swapped_in") > 0
    assert eng.swap_pool["k"].dtype == BF
    assert eng.swap_pool["f"].dtype == torch.float32
    assert len(eng.bm.swap_free) == 24 and eng._swap_qwin == {}


def test_prefix_hits_equal_cold_at_bf16(weights, margins):
    """Raw prefix-cache hits give the streams of a cold run, bit for
    bit."""
    base = list(range(30, 62))
    prompts = [base + [5, 6], base + [7], base + [8, 9, 10]]
    sps = [dict(max_new_tokens=20), dict(max_new_tokens=20, seed=4,
                                         temperature=0.9),
           dict(max_new_tokens=20)]
    cold, _ = serve(weights, prompts, sps, prefix_caching=False)
    eng = make_engine(weights, prefix_caching=True)
    out = []
    for p, sp in zip(prompts, sps):        # one by one: later ones hit
        rid = eng.add_request(p, SamplingParams(**sp))
        done = eng.run(max_steps=2000)
        out.append((done[rid].output, done[rid].logprobs))
    assert out == cold
    assert sum(r.n_cached for r in eng.scheduler.finished.values()) \
        > 0


def test_snapshot_restore_at_bf16(weights, reference):
    """A snapshot mid-stream restores into a fresh engine's buffers and
    continues with identical streams."""
    eng = make_engine(weights, decode_steps=8)
    rids = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(PROMPTS, MIXED)]
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    assert snap["device"]["pools"]["k"].dtype == BF
    eng2 = make_engine(weights, decode_steps=8)
    k_buf = eng2.state["pools"]["k"].data_ptr()
    eng2.restore(snap)
    done = eng2.run(max_steps=2000)
    assert eng2.state["pools"]["k"].data_ptr() == k_buf
    assert [(done[r].output, done[r].logprobs) for r in rids] == reference


def test_streams_against_the_jax_engine_are_measured(weights, reference,
                                                     capsys):
    """Measured, not gated: where each of the port's bf16 streams first
    parts from the JAX engine's bf16 stream on the same weights."""
    jcfg, jparams, _ = weights
    jeng = JEngine(jcfg, jparams, JOptions(
        **SHAPES, compress=JCompress(window=4), kernel_backend="jnp",
        dtype="bfloat16"))
    rids = [jeng.add_request(p, JSP(**sp)) for p, sp in zip(PROMPTS, MIXED)]
    done = jeng.run(max_steps=2000)
    firsts = []
    for (got, _), r in zip(reference, rids):
        want = done[r].output
        n = min(len(got), len(want))
        firsts.append(next((i for i in range(n) if got[i] != want[i]), n))
    with capsys.disabled():
        print(f"\nbf16 streams, port vs the JAX engine (tiny-lm, 28 new "
              f"tokens each): first differing position {firsts}")
    assert len(firsts) == len(PROMPTS)


# ----------------------------------------------------------------------
# ties: bf16 logits tie often


def planted_ties(V=4096, B=4, seed=0):
    """fp32 logits of bf16 products (few distinct values, so many exact
    ties), with each row's maximum planted at several ids."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32))
    x = x.to(BF).float()
    for i in range(B):
        ids = rng.choice(V, 3 + i, replace=False)
        x[i, torch.from_numpy(ids)] = 5.0
    return x


def test_ties_go_to_the_lowest_id():
    """On tied bf16 logits the greedy token, a top-k = 1 draw and the
    sampler's sort order follow the lowest id first, as ``jnp.argmax`` and
    ``lax.top_k`` do."""
    from repro_torch.core.sampling import sample_batch
    logits = planted_ties()
    B, V = logits.shape
    want = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1))
    np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(), want)
    _, top = jax.lax.top_k(jnp.asarray(logits.numpy()), 16)
    sorted_idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1]
    np.testing.assert_array_equal(sorted_idx[:, :16].numpy(), np.asarray(top))
    ones = torch.ones(B)
    uniforms = torch.rand(B, V, generator=torch.Generator().manual_seed(0))
    uniforms = uniforms.clamp(min=1e-6)
    tok, _ = sample_batch(logits, uniforms, ones,
                          torch.ones(B, dtype=torch.int32), ones)
    np.testing.assert_array_equal(tok.numpy(), want)
