"""The port's other dense configs (Llama-3-8B, Qwen2.5-3B, OLMo-1B and
Nemotron-4-15B), held against the JAX package at reduced width.

Each config's ``reduced()`` (2 layers, d_model 64, 4 query heads of 16) in
fp32, on weights from ``repro.models.lm.init`` carried over by
``convert.params_from_numpy``: the parameter tree of ``lm.init``, the
logits of ``lm.forward`` (atol = rtol = 1e-5), each kernel's plain version
against ``repro.kernels.ops`` at ``backend="jnp"`` (1e-5), and greedy and
seeded token streams of ``repro_torch.api.Zipage`` against
``repro.api.Zipage`` (``kernel_backend="jnp"``), equal, with compression
firing for every request (logprobs within 1e-5).

``reduced()`` keeps 4 query heads, so it gives g = 4 (h_kv = 1) or g = 1
(OLMo-1B) only. The full configs' other layouts, g = 6 (Nemotron-4-15B,
48/8) and g = 8 (Qwen2.5-3B, 16/2), are added as cases that replace the
head counts on both sides (12/2 and 16/2).

At each registered config's own dtype (bfloat16) both forwards compute in
bf16: the port's logits are bf16 and within a relative L2 of 2e-2 of the
JAX package's (fault C1, the port's forward raising there, is closed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SamplingParams as JSP
from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import all_arch_names, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import lm

TOL = 1e-5
NAMES = ["llama3-8b", "qwen2.5-3b", "olmo-1b", "nemotron-4-15b"]
#: case -> (config, (h_q, h_kv) replacing the reduced head counts or None)
CASES = {name: (name, None) for name in NAMES}
CASES.update({"nemotron-4-15b-g6": ("nemotron-4-15b", (12, 2)),
              "qwen2.5-3b-g8": ("qwen2.5-3b", (16, 2))})
SHAPES = dict(block_size=8, n_total_blocks=64, max_batch=4,
              max_model_len=128, prefill_rows=2, prefill_len=64)
#: Qwen3's published thinking-mode sampling, with logprobs
SEEDED = dict(temperature=0.6, top_p=0.95, top_k=20, seed=2**31 + 5,
              logprobs=True)


def reduced(get, name, heads=None, dtype="float32"):
    cfg = get(name).reduced()
    if heads is not None:
        cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def prompts(vocab, seed=1):
    """Random prompts (no repeated-token runs, which make survivor
    near-ties), one of them longer than the prefill bucket."""
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, n)] for n in (30, 70, 21)]


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    name, heads = CASES[request.param]
    jcfg = reduced(jget_config, name, heads)
    tcfg = reduced(get_config, name, heads)
    params = jlm.init(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    jz = JZipage(jcfg, params, kernel_backend="jnp", **SHAPES)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params,
                tparams=params_from_numpy(tcfg, tree), jz=jz)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out or {prefix: "{}"}
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("name", NAMES)
def test_init_tree_matches_jax(name):
    """``lm.init`` makes the tree the JAX package's init carries over to:
    the same keys and shapes, the layernorm bias and the empty
    nonparam_ln included."""
    jcfg, tcfg = reduced(jget_config, name), reduced(get_config, name)
    tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.key(0)))
    want = params_from_numpy(tcfg, tree)
    got = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(got) == _shapes(want)
    assert lm.param_count(got) == lm.param_count(want)
    norms = [got["final_norm"]] + [p[k] for p in got["layers"]
                                   for k in ("ln1", "ln2")]
    for norm in norms:
        if tcfg.norm_type == "nonparam_ln":
            assert norm == {}
        else:
            assert torch.equal(norm["scale"], torch.ones(tcfg.d_model))
        if tcfg.norm_type == "layernorm":
            assert torch.equal(norm["bias"], torch.zeros(tcfg.d_model))
        else:
            assert "bias" not in norm


@pytest.mark.parametrize("name", sorted(all_arch_names()))
def test_forward_raises_where_jax_casts_to_the_registered_dtype(name):
    """Formerly fault C1 (the port's forward raised at a config's own bf16
    dtype); now the bf16 parity of the forward (L2 of
    tests/test_torch_bf16.py): at the registered dtype both forwards
    compute in bf16 on the same weights (the port's stored at bf16, the
    JAX package's cast at use) and return bf16 logits within a relative L2
    of 2e-2 (bf16 rounds at other places in the two frameworks: the JAX
    package's own bf16 forward is 1e-2 from its fp32 one); at fp32 they
    agree to TOL. A frontend's embeddings (Whisper's frames, InternVL2's
    patch prefix) go to both forwards: the JAX forward of an
    encoder-decoder config raises without frames."""
    jcfg = reduced(jget_config, name, dtype=None)
    tcfg = reduced(get_config, name, dtype=None)
    assert tcfg.dtype == jcfg.dtype == "bfloat16"
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
    jkw = {k: jnp.asarray(v) for k, v in embeds.items()}
    tkw = {k: torch.from_numpy(v) for k, v in embeds.items()}
    out = jlm.forward(jcfg, params, jnp.asarray(tokens), **jkw)
    # the JAX package's MLA layer divides its bf16 queries by np.sqrt(..),
    # a float64 numpy scalar, which promotes them to fp32: its MLA forward
    # (DeepSeek-V2-Lite) returns fp32 logits (ROADMAP §C); the port's
    # stays bf16
    mla = jcfg.attn_type == "mla"
    assert out.dtype == (jnp.float32 if mla else jnp.dtype(jcfg.dtype))
    assert bool(jnp.isfinite(out).all())
    tree = jax.tree.map(np.asarray, params)
    bparams = params_from_numpy(tcfg, tree, dtype=torch.bfloat16)
    layer0 = bparams["layers"][0]
    mixer = layer0[lm.mixer_kind(layer0)]        # attn, rglru or rwkv
    first = next(t for k, t in mixer.items()
                 if t.dim() == 2 and k not in lm.FP32_KEYS)
    assert first.dtype == torch.bfloat16
    got = lm.forward(tcfg, bparams, torch.from_numpy(tokens), **tkw)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    g, w = got.double().numpy(), np.asarray(out, np.float64)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 2e-2
    tparams = params_from_numpy(tcfg, tree)
    f32 = dataclasses.replace(jcfg, dtype="float32")
    want = np.asarray(jlm.forward(f32, params, jnp.asarray(tokens), **jkw))
    got = lm.forward(dataclasses.replace(tcfg, dtype="float32"), tparams,
                     torch.from_numpy(tokens), **tkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_logits_match(model):
    tokens = np.random.default_rng(0).integers(
        0, model["jcfg"].vocab_size, (2, 12))
    want = np.asarray(jlm.forward(model["jcfg"], model["params"],
                                  jnp.asarray(tokens)))
    got = lm.forward(model["tcfg"], model["tparams"],
                     torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _decode_case(cfg, lens, seed, b=4, mb=6, n_pages=40):
    """q, pools with a NaN page 0, -1 padded tables at the config's head
    layout; live pages never include page 0."""
    rng = np.random.default_rng(seed)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rng.normal(size=(len(lens), hq, d)).astype(np.float32)
    qw = rng.normal(size=(len(lens), 4, hq, d)).astype(np.float32)
    kp = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    kp[1::2] = 0.3 * kp[1::2] + rng.normal(size=(n_pages // 2, 1, hkv, d))
    vp = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    bt = np.full((len(lens), mb), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
    return q, qw, kp, vp, bt, np.asarray(lens, np.int32)


def test_plain_kernels_match_jnp_at_the_head_layout(model):
    """Each kernel's plain version against the JAX package's jnp op at the
    case's head layout (d = 16), with seq_len == 0 and full-table rows."""
    q, qw, kp, vp, bt, sl = _decode_case(model["tcfg"], [0, 5, 24, 13, 16],
                                         seed=3)
    clean, vclean = kp.copy(), vp.copy()  # the JAX ops get page 0 finite
    kp[0] = vp[0] = np.nan
    t = torch.from_numpy
    cbt = np.maximum(bt, 0)         # the JAX compression clamps its tables
    pairs = [
        (ops.ragged_decode_attention(t(q), t(kp), t(vp), t(bt), t(sl)),
         jops.ragged_decode_attention(q, clean, vclean, bt, sl,
                                     backend="jnp")),
        (ops.paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(sl)),
         jops.paged_decode_attention(q, clean, vclean, bt, sl,
                                    backend="jnp")),
        (ops.score_logits(t(qw), t(kp), t(bt), t(sl)),
         jops.score_logits(qw, clean, cbt, sl, backend="jnp")),
        (ops.lightning_redundancy(t(kp), t(bt), t(sl), p_thresh=0.8),
         jops.lightning_redundancy(clean, cbt, sl, p_thresh=0.8,
                                   backend="jnp")),
        (ops.flash_redundancy(t(kp), t(bt), t(sl), p_thresh=0.8),
         jops.flash_redundancy(clean, cbt, sl, p_thresh=0.8, backend="jnp")),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_greedy_streams_match(model):
    ps = prompts(model["jcfg"].vocab_size)
    jo = model["jz"].generate(ps, JSP(max_new_tokens=40))
    tz = Zipage(model["tcfg"], model["tparams"], device="cpu", **SHAPES)
    to = tz.generate(ps, SamplingParams(max_new_tokens=40))
    assert [o.token_ids for o in to] == [o.token_ids for o in jo]
    n_comp = [o.metrics.compression.n_compressions for o in to]
    assert n_comp == [o.metrics.compression.n_compressions for o in jo]
    assert min(n_comp) > 0
    assert tz.num_free_blocks == SHAPES["n_total_blocks"]


def test_seeded_stream_matches(model):
    p = prompts(model["jcfg"].vocab_size, seed=2)[1]
    jo = model["jz"].generate([p], JSP(max_new_tokens=30, **SEEDED))[0]
    to = Zipage(model["tcfg"], model["tparams"], device="cpu", **SHAPES) \
        .generate([p], SamplingParams(max_new_tokens=30, **SEEDED))[0]
    assert to.token_ids == jo.token_ids
    assert to.metrics.compression.n_compressions > 0
    np.testing.assert_allclose(to.logprobs, jo.logprobs, rtol=TOL, atol=TOL)
