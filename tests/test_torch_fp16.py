"""float16 serving: the port at ``dtype="float16"``, held against the JAX
package's fp16 path and against itself.

The levels of tests/test_torch_bf16.py, at fp16 (11 significant bits, so
one ulp is 2**-10 relative):

L0  the kernels' plain versions against ``repro.kernels.ops`` (backends
    "jnp" and "pallas-interpret") on identical fp16 inputs, at g = 1, 4,
    6 and 8 and on idle slots: fp32 outputs (window logits, redundancy)
    to atol = rtol = 1e-5, fp16 outputs (decode attention) to one fp16
    ulp (both round an fp32 result once), compaction bit for bit;
L1  the attention ops and the FFN on identical inputs, each within one
    fp16 ulp; the gated FFN's activation as test_torch_bf16.py holds it
    (XLA's sigmoid), its output within a relative L2 of FP16_REL_L2;
L2  the forward of every config at ``reduced()``: fp16 out, relative L2
    to the JAX package's fp16 forward at most FP16_REL_L2 (3e-3: twice
    the 1.5e-3 that the JAX package's own fp16 forward lies from its fp32
    one at Qwen3-8B's reduced widths);
L3  the serve steps, teacher-forced with the JAX package's greedy tokens,
    and compression on identical fp16 pools, survivors compared above a
    1e-4 margin;
L4  the port's own invariants at fp16, bit for bit, through the engine on
    the CPU with compression firing: K = 8 == K = 1 == unfused, ragged ==
    dense, swap == an ample pool, raw prefix hits == cold, snapshot /
    restore, the sanitizer clean throughout. The port's fp16 streams
    against the JAX engine's are printed, not gated.

Also the memory planner at fp16 against bf16, a checkpoint round trip of
fp16 leaves, and three training steps at tiny-lm in fp16 against the
reference's jitted fp16 steps. Every test asserts the dtypes it relies
on, so that none passes at fp32 by mistake.
"""
import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import paged as jpaged
from repro.core import serve_model as jsm
from repro.core.compression import CompressOptions as JCompress
from repro.core.compression import _compact_pool
from repro.core.compression import build_compress_fn as jbuild
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import ZipageEngine as JEngine
from repro.core.sampling import SamplingParams as JSP
from repro.eval import tasks as jax_tasks
from repro.kernels import ops as jops
from repro.models import common as JC
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.training import optimizer as jax_opt
from repro.training.train_loop import build_train_step as jax_build_step
from repro_torch.configs import all_arch_names, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression, invariants, memory_planner
from repro_torch.core import paged as tpaged
from repro_torch.core import serve_model as tsm
from repro_torch.core.compression import CompressOptions
from repro_torch.core.engine import EngineOptions, ZipageEngine
from repro_torch.core.sampling import SamplingParams
from repro_torch.eval import tasks
from repro_torch.kernels import ops
from repro_torch.models import common as TC
from repro_torch.models import layers as TL
from repro_torch.models import lm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import build_train_step
from test_torch_bf16 import (CONFIGS, LAYOUTS, MIXED, PROMPTS, SHAPES, TIGHT,
                             decode_case, poisoned, total)
from test_torch_compression import BUDGET, B_SZ, HKV, MARGIN, W, WIDTH
from test_torch_compression import L as COMP_LAYERS
from test_torch_compression import cfgs as comp_cfgs
from test_torch_compression import (make_inputs, port_final_scores,
                                    port_pools)
from test_torch_model import _install, jax_params, small_cfgs

H = torch.float16
F32_TOL = 1e-5           # fp32 outputs from fp16 inputs
ULP = 2.0 ** -10         # one fp16 ulp, relative (11 significant bits)
FP16_REL_L2 = 3e-3
#: a greedy token is held where JAX's top-2 logit gap is wider: the
#: bf16 test's 0.25 scaled by the two dtypes' relative L2 bounds
FP16_GAP = 0.25 * FP16_REL_L2 / 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes are too small to gain from more,
    and beside the suite's other workers the threads contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_f16(a):
    """fp32 numpy -> (the JAX package's fp16 array, the port's fp16 tensor)
    holding the same bits."""
    j = jnp.asarray(np.asarray(a, np.float32), jnp.float16)
    t = torch.from_numpy(np.array(j))
    assert t.dtype == H
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(j).view(np.int16))
    return j, t


def f32(a):
    """Any array or tensor as fp32 numpy (exact for fp16)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def assert_within_ulp(got, want, name):
    """Both fp16; equal, or apart by at most one fp16 ulp."""
    assert got.dtype == H, (name, got.dtype)
    assert np.asarray(want).dtype == np.float16, (name, want.dtype)
    np.testing.assert_allclose(f32(got), f32(want), rtol=ULP, atol=ULP,
                               err_msg=name)


def assert_bits_equal(got, want, name):
    assert got.dtype == H, (name, got.dtype)
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)


def rel_l2(got, want):
    g, w = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


# ----------------------------------------------------------------------
# L0: the kernels' plain versions against repro.kernels.ops at fp16


@pytest.mark.parametrize("backend", ["jnp", "pallas-interpret"])
@pytest.mark.parametrize("g", sorted(LAYOUTS))
def test_plain_kernels_match_jax_at_fp16(g, backend):
    """K1, B4, K2, K3 and B5 on identical fp16 inputs: decode outputs fp16
    within one ulp, window logits and redundancy fp32 within 1e-5; the
    port's inputs carry a NaN page 0 and NaN stale tails, the JAX
    package's the clean pool."""
    hq, hkv = LAYOUTS[g]
    b = 4
    lens = [0, 5, 24, 13]
    q, kp, vp, bt, sl = decode_case(hq, hkv, lens, seed=g, similar=True)
    (jq, tq), (jk, tk), (jv, tv) = to_f16(q), to_f16(kp), to_f16(vp)
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
    jw, tw = to_f16(rng.normal(size=(len(lens), 4, hq, 16)))
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
def test_decode_on_idle_slots_at_fp16(g):
    """seq_len >= 1 over an empty table, and a -1 entry below seq_len read
    as page 0 (the TPU kernels' clamp), at fp16 against the JAX package's
    reference."""
    hq, hkv = LAYOUTS[g]
    q, kp, vp, bt, sl = decode_case(hq, hkv, [1, 1, 9, 17], seed=40 + g)
    bt[:2] = -1
    bt[2, 0] = -1
    (jq, tq), (jk, tk), (jv, tv) = to_f16(q), to_f16(kp), to_f16(vp)
    args = (tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(sl))
    ragged = ops.ragged_decode_attention(*args)
    dense = ops.paged_decode_attention(*args)
    assert torch.equal(ragged, dense)
    want = jops.ragged_decode_attention(jq, jk, jv, bt, sl, backend="jnp")
    assert_within_ulp(ragged, want, "idle slots")


def test_compaction_moves_fp16_bits_as_jax():
    """B6 on fp16 K/V and fp32 F pools, in place with overlapping ranks,
    copy-on-write and a padding row, against the JAX engine's
    ``_compact_pool`` per request: bit for bit, a -0.0 and a NaN among the
    moved values."""
    rng = np.random.default_rng(7)
    L, b, h, d, budget = 2, 4, 2, 16, 3
    mb, N = budget + 1, 16
    k = rng.normal(size=(L, N, b, h, d))
    k[:, :, 0, 0, :2] = [-0.0, np.nan]      # bits a by-value compare misses
    (jk, tk), (jv, tv) = to_f16(k), to_f16(rng.normal(size=(L, N, b, h, d)))
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
    assert pools[0].dtype == H and pools[2].dtype == torch.float32
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


def test_fp16_wrapper_checks_take_fp16_and_refuse_cpu():
    """The CUDA wrappers' checks take fp16 as a storage type of its own
    (launched through ``<kernel>_launch_f16``), refuse a CPU tensor before
    any launch, and hold fp16 rows to bf16's 16-byte rule."""
    from repro_torch.kernels import _checks, native
    assert H in _checks.KV_DTYPES
    assert native.DTYPE_SUFFIX[str(H)] == "_f16"
    for fn in ("ragged_paged_attention_launch", "paged_attention_launch",
               "paged_score_launch", "lightning_redundancy_launch",
               "flash_redundancy_launch", "compaction_launch"):
        assert native._ARGTYPES[fn + "_f16"] == native._ARGTYPES[fn]
    q = torch.zeros(2, 4, 16, dtype=H)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _checks.kv_tensors("k", torch.device("cpu"), q=q)
    with pytest.raises(ValueError, match="one of"):
        _checks.kv_tensors("k", torch.device("cpu"), q=q.double())


def _chip_smoke():
    """chip_smoke.py at the repo's root; loaded by path, once."""
    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


def test_cpu_fp16_gemm_gives_the_native_fp16_bits():
    """chip_smoke.cpu_fp16_gemm, the CPU side of the card-vs-CPU checks at
    fp16, forms fp16 products as fp32 products rounded once: the same
    fp16 logits, bit for bit, as PyTorch's own CPU fp16 GEMM here, at 2
    layers of Qwen3-8B's reduced widths; at another dtype it changes
    nothing."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              dtype="float16", num_layers=2)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)))
    native = lm.forward(cfg, params, tokens)
    with cs.cpu_fp16_gemm(torch, "float16"):
        emulated = lm.forward(cfg, params, tokens)
    assert native.dtype == emulated.dtype == H
    assert torch.equal(native.view(torch.int16), emulated.view(torch.int16))
    x, w = torch.randn(3, 5).half(), torch.randn(5, 4).half()
    with cs.cpu_fp16_gemm(torch, "float16"):
        got = (x @ w, torch.matmul(x, w), torch.nn.functional.linear(x, w.T))
    want = (x.float() @ w.float()).half()
    assert all(torch.equal(g, want) for g in got)
    assert isinstance(cs.cpu_fp16_gemm(torch, "bfloat16"),
                      contextlib.nullcontext)


# ----------------------------------------------------------------------
# L1: the single ops on identical inputs


def layer_weights(name, seed=0):
    """A reduced config's first layer in both packages, at fp16: the JAX
    package's fp32 params (it casts at use) and the port's fp16 ones."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), dtype="float16")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float16")
    params = jlm.init(jcfg, jax.random.key(seed))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                dtype=H)
    jp = jax.tree.map(lambda a: a[0], params["main"]["0"])
    tp = tparams["layers"][0]
    assert tp["attn"]["wq"].dtype == H and tp["ffn"]["w1"].dtype == H
    for norm in (tp["ln1"], tp["ln2"], tparams["final_norm"]):
        assert all(v.dtype == torch.float32 for v in norm.values())
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", CONFIGS)
def test_attention_ops_match_jax_at_fp16(name):
    """apply_norm, attn_qkv (with qk-norm or qkv bias where the config has
    them), apply_rope, causal attention and paged prefill attention, each
    within one fp16 ulp of the JAX package's on the same fp16 inputs."""
    jcfg, tcfg, jp, tp = layer_weights(name)
    rng = np.random.default_rng(1)
    B, S = 2, 8
    jx, tx = to_f16(rng.normal(size=(B, S, jcfg.d_model)))
    assert_within_ulp(TC.apply_norm(tcfg, tp["ln1"], tx),
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
    b, mb = 4, 4
    hkv, d = jcfg.num_kv_heads, jcfg.head_dim
    kp, vp = (rng.normal(size=(12, b, hkv, d)) for _ in range(2))
    (jkp, tkp), (jvp, tvp) = to_f16(kp), to_f16(vp)
    bt = np.array([[3, 7, 1, 9], [2, 11, 4, 5]], np.int32)
    start = np.array([0, 3], np.int32)
    kv_lens = start + S
    got = tpaged.paged_prefill_attention(tq, tkp, tvp, torch.from_numpy(bt),
                                         torch.from_numpy(start),
                                         torch.from_numpy(kv_lens))
    want = jpaged.paged_prefill_attention(jq, jkp, jvp, bt, start, kv_lens)
    assert_within_ulp(got, want, "paged_prefill_attention")


@pytest.mark.parametrize("name", CONFIGS)
def test_ffn_matches_jax_at_fp16(name, capsys):
    """sq_relu FFN (Nemotron) within one ulp. The gated FFN: its two
    products within one ulp, the port's activation within one ulp of the
    correctly rounded silu(a) * b of its own products, and the
    down-projection of the JAX package's activation within one ulp; the
    share of gated outputs that differ from JAX's is printed, and their
    relative L2 is held to FP16_REL_L2."""
    jcfg, tcfg, jp, tp = layer_weights(name)
    rng = np.random.default_rng(2)
    jx, tx = to_f16(rng.normal(size=(2, 8, jcfg.d_model)))
    got = TL.ffn_forward(tcfg, tp["ffn"], tx)
    want = JL.ffn_forward(jcfg, jp["ffn"], jx)
    if "w3" not in tp["ffn"]:
        assert jcfg.ffn_act == "sq_relu"
        assert_within_ulp(got, want, "sq_relu ffn")
        return
    ja = jx @ jp["ffn"]["w1"].astype(jnp.float16)
    jb = jx @ jp["ffn"]["w3"].astype(jnp.float16)
    ta, tb = tx @ tp["ffn"]["w1"], tx @ tp["ffn"]["w3"]
    assert_within_ulp(ta, ja, "w1 product")
    assert_within_ulp(tb, jb, "w3 product")
    act = TC.ffn_act_fn(tcfg.ffn_act)(ta, tb)
    a64, b64 = f32(ta).astype(np.float64), f32(tb).astype(np.float64)
    exact = a64 / (1.0 + np.exp(-a64)) * b64
    np.testing.assert_allclose(f32(act), exact, rtol=ULP, atol=ULP)
    jact = JC.ffn_act_fn(jcfg.ffn_act)(ja, jb)
    _, tjact = to_f16(np.asarray(jact, np.float32))
    assert_within_ulp(tjact @ tp["ffn"]["w2"],
                      jact @ jp["ffn"]["w2"].astype(jnp.float16),
                      "down-projection")
    share = float(np.mean(f32(got) != f32(want)))
    with capsys.disabled():
        print(f"\n{name}: gated FFN at fp16: {share:.1%} of outputs differ "
              f"from the JAX package's (activation: "
              f"{float(np.mean(f32(act) != f32(jact))):.1%}), relative L2 "
              f"{rel_l2(got, want):.2e}")
    assert rel_l2(got, want) <= FP16_REL_L2


# ----------------------------------------------------------------------
# L2: the forward of every config


@pytest.mark.parametrize("name", sorted(all_arch_names()))
def test_forward_matches_jax_at_fp16(name):
    """Every config at ``reduced()`` in fp16 on the same weights (the
    port's stored at fp16, the JAX package's cast at use): fp16 logits
    within a relative L2 of FP16_REL_L2 of the JAX package's fp16 forward.
    A frontend's embeddings go to both forwards. The JAX package's MLA
    forward returns fp32 logits (its queries divided by a float64 numpy
    scalar), as at bf16."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), dtype="float16")
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float16")
    params = jlm.init(jcfg, jax.random.key(2))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 9))
    embeds = {}
    if jcfg.is_enc_dec:
        embeds["frame_embeds"] = rng.standard_normal(
            (2, jcfg.cross_seq_len, jcfg.d_model)).astype(np.float32)
    if jcfg.num_prefix_embeds:
        embeds["prefix_embeds"] = rng.standard_normal(
            (2, jcfg.num_prefix_embeds, jcfg.d_model)).astype(np.float32)
    out = jlm.forward(jcfg, params, jnp.asarray(tokens),
                      **{k: jnp.asarray(v) for k, v in embeds.items()})
    mla = jcfg.attn_type == "mla"
    assert out.dtype == (jnp.float32 if mla else jnp.float16)
    assert bool(jnp.isfinite(out).all())
    hparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                dtype=H)
    layer0 = hparams["layers"][0]
    mixer = layer0[lm.mixer_kind(layer0)]        # attn, rglru or rwkv
    first = next(t for k, t in mixer.items()
                 if t.dim() == 2 and k not in lm.FP32_KEYS)
    assert first.dtype == H
    assert all(t.dtype == torch.float32 for k, t in mixer.items()
               if k in lm.FP32_KEYS)
    got = lm.forward(tcfg, hparams, torch.from_numpy(tokens),
                     **{k: torch.from_numpy(v) for k, v in embeds.items()})
    assert got.dtype == H
    assert bool(torch.isfinite(got).all())
    assert rel_l2(got, out) <= FP16_REL_L2


# ----------------------------------------------------------------------
# L3: teacher-forced serve steps and compression on identical pools


def test_serve_steps_match_at_fp16():
    """A paged prefill, then 16 decode steps (an inactive row among them)
    that both packages take on the JAX package's greedy tokens, from the
    same installed state, with the JAX kernels interpreted: at every step
    the logits within a relative L2 of FP16_REL_L2 and the port's argmax
    equal to JAX's wherever JAX's top-2 gap exceeds FP16_GAP; the K/V
    pools and windows fp16 within FP16_REL_L2, F fp32."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="float16")
                  for c in small_cfgs())
    params, tree = jax_params(jcfg, seed=1)
    tparams = params_from_numpy(tcfg, tree, dtype=H)
    shape = dict(n_slots=3, block_size=4, max_blocks=10, n_total_blocks=40,
                 m_qslots=2, window=4, prefill_rows=2, prefill_len=16,
                 dtype="float16")
    jspec = jsm.ServeSpec(**shape, attn_backend="pallas-interpret")
    tspec = tsm.ServeSpec(**shape)
    tables = np.full((3, 10), -1, np.int32)
    tables[0, :8] = [3, 7, 1, 9, 20, 21, 22, 23]
    tables[2, :9] = [2, 11, 4, 5, 6, 30, 31, 32, 33]
    lengths = np.array([11, 16], np.int32)
    seq = np.array([11, 0, 16], np.int32)
    qslots = np.array([1, -1, 0], np.int32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    slots = np.array([0, 2], np.int32)
    zero = np.zeros(2, np.int32)

    jstate = _install(jsm.make_state(jcfg, jspec), tables, seq, qslots,
                      jnp.asarray)
    jl, jstate = jax.jit(jsm.build_prefill_step(jcfg, jspec))(
        params, jstate, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(lengths), jnp.asarray(zero))
    tstate = _install(tsm.make_state(tcfg, tspec, "cpu"), tables, seq,
                      qslots, torch.from_numpy)
    pools = tstate["pools"]
    assert pools["k"].dtype == pools["v"].dtype == H
    assert tstate["qwin"].dtype == H
    assert pools["f"].dtype == torch.float32
    assert jstate["pools"]["k"].dtype == jnp.float16
    tl = tsm.build_prefill_step(tcfg, tspec)(
        tparams, tstate, torch.from_numpy(toks).long(),
        torch.from_numpy(slots), torch.from_numpy(lengths),
        torch.from_numpy(zero))
    assert tl.dtype == torch.float32
    assert rel_l2(tl, jl) <= FP16_REL_L2

    def same_pools():
        for key in ("k", "v"):
            assert rel_l2(pools[key][:, :-1], jstate["pools"][key]) \
                <= FP16_REL_L2, key
        assert rel_l2(tstate["qwin"][:, :-1], jstate["qwin"]) \
            <= FP16_REL_L2
    same_pools()

    jstate["positions"] = jnp.asarray(seq)
    tstate["positions"] = torch.from_numpy(seq.copy())
    active = np.array([True, False, True])
    jdecode = jax.jit(jsm.build_decode_step(jcfg, jspec))
    tdecode = tsm.build_decode_step(tcfg, tspec)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    tok = np.array([tok[0], 9, tok[1]], np.int32)
    held = 0
    for _ in range(16):
        jl, jstate = jdecode(params, jstate, jnp.asarray(tok),
                             jnp.asarray(active))
        tl = tdecode(tparams, tstate, torch.from_numpy(tok).long(),
                     torch.from_numpy(active))
        want = np.asarray(jl)[active]
        got = tl.numpy()[active]
        assert rel_l2(got, want) <= FP16_REL_L2
        top2 = np.sort(want, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > FP16_GAP
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        held += int(clear.sum())
        tok = np.where(active, np.asarray(jl).argmax(-1), tok).astype(
            np.int32)
    assert held >= 16                # most of the 32 live tokens are held
    np.testing.assert_array_equal(tstate["seq_lens"].numpy(),
                                  np.asarray(jstate["seq_lens"]))
    same_pools()


def test_compress_matches_jax_at_fp16():
    """Compression on identical fp16 pools and windows, F in fp32: the
    statistics within 1e-5, and wherever the k-th vs (k+1)-th margin is
    above 1e-4 the compacted K and V are the same fp16 bits and F within
    1e-5."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="float16")
                  for c in comp_cfgs())
    pools, qwin, req = make_inputs(seed=2)
    jpools = {k: jnp.asarray(v, jnp.float16 if k != "f" else jnp.float32)
              for k, v in pools.items()}
    jqwin = jnp.asarray(qwin, jnp.float16)
    jfn = jax.jit(jbuild(jcfg, block_size=B_SZ, max_blocks=WIDTH,
                         budget_blocks=BUDGET,
                         opts=JCompress(window=W, backend="pallas-interpret")))
    jout, jseq, jstats = jfn(jpools, jqwin,
                             tuple(jnp.asarray(a) for a in req))
    assert jout["k"].dtype == jnp.float16
    jout = {k: np.array(v) for k, v in jout.items()}

    topts = compression.CompressOptions(window=W)
    treq = tuple(torch.from_numpy(a.copy()) for a in req)
    tpools = port_pools({k: np.array(v) for k, v in jpools.items()})
    tqwin = torch.from_numpy(np.array(jqwin))
    assert tpools["k"].dtype == tqwin.dtype == H
    final = port_final_scores(tcfg, topts, tpools, tqwin, treq)
    fn = compression.build_compress_fn(tcfg, block_size=B_SZ,
                                       max_blocks=WIDTH,
                                       budget_blocks=BUDGET, opts=topts)
    tseq, tstats = fn(tpools, tqwin, treq)
    assert tpools["k"].dtype == H and tpools["f"].dtype == torch.float32

    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    live = req[2] >= 0
    np.testing.assert_allclose(tstats.numpy()[live], np.asarray(jstats)[live],
                               rtol=F32_TOL, atol=F32_TOL)
    k_keep = BUDGET * B_SZ
    compared = n_streams = 0
    for l in range(COMP_LAYERS):
        for i in np.flatnonzero(live):
            dest = req[1][i]
            for h in range(HKV):
                n_streams += 1
                s = torch.sort(final[l, i, :, h], descending=True)[0]
                if not float(s[k_keep - 1] - s[k_keep]) > MARGIN:
                    continue
                compared += 1
                for key in ("k", "v"):
                    assert_bits_equal(tpools[key][l, dest, :, h],
                                      jout[key][l, dest, :, h], key)
                np.testing.assert_allclose(
                    tpools["f"].numpy()[l, dest, :, h],
                    jout["f"][l, dest, :, h], rtol=F32_TOL, atol=F32_TOL)
    assert compared >= 0.75 * n_streams, (compared, n_streams)


# ----------------------------------------------------------------------
# L4: the port's own invariants at fp16, through the engine


@pytest.fixture(autouse=True)
def sanitized(monkeypatch):
    """Every port engine audits its whole state after each step."""
    monkeypatch.setattr(invariants, "enabled", lambda: True)


@pytest.fixture(scope="module")
def weights():
    """tiny-lm's JAX weights (fp32, cast at use) and the port's at fp16."""
    jcfg = dataclasses.replace(jget_config("tiny-lm"), dtype="float16")
    jparams = jlm.init(jcfg, jax.random.key(0))
    tparams = params_from_numpy(get_config("tiny-lm"),
                                jax.tree.map(np.asarray, jparams), dtype=H)
    return jcfg, jparams, tparams


def make_engine(weights, **kw):
    opts = dict(SHAPES, compress=CompressOptions(window=4), dtype="float16")
    opts.update(kw)
    eng = ZipageEngine(get_config("tiny-lm"), weights[2],
                       EngineOptions(**opts), device="cpu")
    pools = eng.state["pools"]
    assert pools["k"].dtype == pools["v"].dtype == H
    assert eng.state["qwin"].dtype == H
    assert pools["f"].dtype == torch.float32
    assert eng.params["embed"].dtype == H
    assert eng.params["final_norm"]["scale"].dtype == torch.float32
    assert eng.sanitize
    return eng


def serve(weights, prompts=PROMPTS, sps=MIXED, **kw):
    eng = make_engine(weights, **kw)
    rids = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(prompts, sps)]
    done = eng.run(max_steps=2000)
    return [(done[r].output, done[r].logprobs) for r in rids], eng


@pytest.fixture(scope="module")
def reference(weights):
    """The port's fp16 streams at the defaults (K = 1, ragged, ample)."""
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
def test_decode_modes_give_one_stream_at_fp16(weights, reference, mode):
    """K = 8 == K = 1 == unfused, and dense decode == ragged, tokens and
    logprobs bit for bit, with compression firing; flash redundancy, a
    different score, is held between K = 8 and K = 1 on its own."""
    got, eng = serve(weights, **mode)
    if "compress" in mode:
        want, _ = serve(weights, compress=mode["compress"])
    else:
        want = reference
    assert got == want
    assert total(eng, "n_compressing") > 0
    if mode.get("decode_steps", 1) > 1:
        assert max(m["decode_horizon"] for m in eng.metrics) > 1


def test_swap_equals_an_ample_pool_at_fp16(weights, reference):
    """At the tight shapes the run preempts and swaps fp16 blocks out and
    back bit for bit: the streams equal the ample pool's."""
    got, eng = serve(weights, **TIGHT, preemption_mode="swap",
                     swap_space_blocks=24)
    assert got == reference
    assert total(eng, "n_preempted") > 0
    assert total(eng, "n_swapped_out") == total(eng, "n_swapped_in") > 0
    assert eng.swap_pool["k"].dtype == H
    assert eng.swap_pool["f"].dtype == torch.float32
    assert len(eng.bm.swap_free) == 24 and eng._swap_qwin == {}


def test_prefix_hits_equal_cold_at_fp16(weights):
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
    assert sum(r.n_cached for r in eng.scheduler.finished.values()) > 0


def test_snapshot_restore_at_fp16(weights, reference):
    """A snapshot mid-stream restores into a fresh engine's buffers and
    continues with identical streams."""
    eng = make_engine(weights, decode_steps=8)
    rids = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(PROMPTS, MIXED)]
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    assert snap["device"]["pools"]["k"].dtype == H
    eng2 = make_engine(weights, decode_steps=8)
    k_buf = eng2.state["pools"]["k"].data_ptr()
    eng2.restore(snap)
    done = eng2.run(max_steps=2000)
    assert eng2.state["pools"]["k"].data_ptr() == k_buf
    assert [(done[r].output, done[r].logprobs) for r in rids] == reference


def test_streams_against_the_jax_engine_are_measured(weights, reference,
                                                     capsys):
    """Measured, not gated: where each of the port's fp16 streams first
    parts from the JAX engine's fp16 stream on the same weights."""
    jcfg, jparams, _ = weights
    jeng = JEngine(jcfg, jparams, JOptions(
        **SHAPES, compress=JCompress(window=4), kernel_backend="jnp",
        dtype="float16"))
    assert jeng.state["pools"]["k"].dtype == jnp.float16
    rids = [jeng.add_request(p, JSP(**sp)) for p, sp in zip(PROMPTS, MIXED)]
    done = jeng.run(max_steps=2000)
    firsts = []
    for (got, _), r in zip(reference, rids):
        want = done[r].output
        n = min(len(got), len(want))
        firsts.append(next((i for i in range(n) if got[i] != want[i]), n))
    with capsys.disabled():
        print(f"\nfp16 streams, port vs the JAX engine (tiny-lm, 28 new "
              f"tokens each): first differing position {firsts}")
    assert len(firsts) == len(PROMPTS)


def test_quiet_qslot_audit_compares_fp16_bits(weights):
    """The sanitizer's quiet-query-slot audit compares fp16 windows as
    bits: a quiet row whose 0.0 entries turn into -0.0 is reported, which
    a compare by value would miss."""
    eng = make_engine(weights)
    eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=4))
    eng.run(max_steps=100)
    out = []
    invariants._qwin_ownership(eng, out)
    assert out == [] and eng._qwin_shadow
    assert eng.state["qwin"].dtype == H
    row = eng.state["qwin"][:, min(eng._qwin_shadow)]
    zeros = row == 0
    assert bool(zeros.any())
    row[zeros] = -0.0
    invariants._qwin_ownership(eng, out)
    assert out


# ----------------------------------------------------------------------
# the memory planner, checkpoints and training at fp16


def test_memory_planner_at_fp16_equals_bf16():
    """fp16 takes bf16's two bytes: the plan, the accounting's block bytes
    and the pools' real block bytes are bf16's; the engine's pools at
    fp16 hold the bytes the planner gives."""
    cfg = get_config("qwen3-8b")
    assert memory_planner.dtype_bytes_of("float16") == 2
    plans = {dt: memory_planner.plan_memory(
        cfg, 40 << 30, 9, block_size=16, window=8,
        dtype_bytes=memory_planner.dtype_bytes_of(dt))
        for dt in ("float16", "bfloat16", "float32")}
    assert plans["float16"] == plans["bfloat16"] != plans["float32"]
    assert memory_planner.pool_bytes_per_kv_block(cfg, 16, dtype_bytes=2) \
        < memory_planner.pool_bytes_per_kv_block(cfg, 16, dtype_bytes=4)
    tiny = get_config("tiny-lm")
    kw = dict(block_size=8, n_total_blocks=16, max_batch=2,
              max_model_len=64, prefill_rows=1, prefill_len=32)
    params = lm.init(tiny, torch.Generator().manual_seed(0), "cpu")
    for dt in ("float16", "bfloat16"):
        eng = ZipageEngine(tiny, params, EngineOptions(**kw, dtype=dt),
                           device="cpu")
        assert eng.state["pools"]["k"].dtype == lm.torch_dtype(dt)
        assert eng._kv_block_bytes() == \
            memory_planner.pool_bytes_per_kv_block(tiny, 8, dtype_bytes=2)


def test_checkpoint_round_trips_fp16_leaves(tmp_path):
    """fp16 leaves are stored as numpy's float16 under ``float16`` in the
    manifest and restored bit for bit, a -0.0, a NaN and an inf among
    them."""
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0)).to(H)
    w[0, :3] = torch.tensor([-0.0, float("nan"), float("inf")])
    tree = {"w": w, "f": [torch.randn(5)]}
    ckpt.save(str(tmp_path), 1, tree)
    d = os.path.join(str(tmp_path), "step_00000001")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["leaves"]["w"]["dtype"] == "float16"
    assert np.load(os.path.join(d, man["leaves"]["w"]["file"])).dtype \
        == np.float16
    like = {"w": torch.zeros(3, 4, dtype=H), "f": [torch.zeros(5)]}
    out, _ = ckpt.restore(str(tmp_path), 1, like)
    assert out["w"].dtype == H
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))
    assert ckpt.digest(out) == ckpt.digest(tree)


def test_fp16_steps_against_the_reference():
    """Three steps of the eval's recipe at tiny-lm in fp16 from one init,
    both packages keeping fp32 master params cast to fp16 at each use:
    losses and gradient norms at bf16's relative 2e-2, the params and the
    update the three steps made within a relative L2 of 2e-2 of the
    reference's jitted steps."""
    rel = 2e-2
    jcfg = dataclasses.replace(jget_config("tiny-lm"), dtype="float16")
    cfg = dataclasses.replace(get_config("tiny-lm"), dtype="float16")
    recipe = dict(lr=3e-3, warmup_steps=20, total_steps=300)
    jinit = jlm.init(dataclasses.replace(jcfg, dtype="float32"),
                     jax.random.key(0))
    jstep = jax.jit(jax_build_step(jcfg, jax_opt.AdamWConfig(**recipe),
                                   vocab_chunk=64))
    step = build_train_step(cfg, opt.AdamWConfig(**recipe), vocab_chunk=64)

    def port(tree):
        return params_from_numpy(cfg, jax.tree.map(np.array, tree))
    jp, jstate = jinit, jax_opt.init_opt_state(jinit)
    p = port(jinit)
    init = opt.tree_leaves(port(jinit))
    state = opt.init_opt_state(p)
    for i in range(3):
        b = tasks.train_batch(i, seq_len=80, batch=16, seed=0)
        jb = jax_tasks.train_batch(i, seq_len=80, batch=16, seed=0)
        jp, jstate, _, jm = jstep(jp, jstate, None,
                                  jax.tree.map(jnp.asarray, jb))
        p, state, _, m = step(p, state, None, b)
        assert np.isfinite(float(m["loss"]))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=rel)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=rel)
    assert p["layers"][0]["attn"]["wq"].dtype == torch.float32
    assert state["m"]["layers"][0]["attn"]["wq"].dtype == torch.float32
    assert lm.cast_params(p, H)["layers"][0]["attn"]["wq"].dtype == H
    ref = opt.tree_leaves(port(jp))
    got = opt.tree_leaves(p)

    def tree_rel(a, b):
        num = sum(float(((x.float() - y.float()) ** 2).sum())
                  for x, y in zip(a, b))
        return (num / sum(float((y.float() ** 2).sum()) for y in b)) ** 0.5
    assert tree_rel(got, ref) < rel
    assert tree_rel([a - b for a, b in zip(got, init)],
                    [a - b for a, b in zip(ref, init)]) < rel
    assert torch.is_grad_enabled()
