"""The port's MoE configs, DeepSeek-V2-Lite-16B (MLA, 64 routed experts
top-6 + 2 shared, the first layer dense) and DBRX-132B (GQA g = 6, 16
experts top-4, layernorm), held against the JAX package on the CPU at
their ``reduced()`` widths (2 layers, d_model 64, 4 experts top-2), fp32,
on weights from ``repro.models.lm.init`` carried over by
``convert.params_from_numpy``; inputs from a numpy seed.

  * ``layers.moe_forward`` against the JAX function, with a ``valid``
    mask parking padding tokens, at 1 and 2 dispatch groups, at the
    configs' capacity, at one that drops token-expert pairs and at a
    drop-free one (8.0), at atol = rtol = 1e-5 wherever the router's
    k-th vs (k+1)-th margin is above TIE_TOL (a near-tie may route to
    another expert under other rounding: ROADMAP §C);
  * ``lm.forward`` and ``lm.init``'s tree against the JAX package's;
  * the paged prefill and decode steps reproduce the port's own forward
    at a drop-free capacity, as tests/test_serve_equivalence.py holds the
    JAX package's (at the configs' capacity the batch's rows compete for
    an expert, so the two paths need not agree);
  * the facade: ``repro_torch.api.Zipage`` and ``repro.api.Zipage``
    (``kernel_backend="jnp"``) on the same weights, compression on, give
    equal greedy streams, finish reasons and per-request compression
    counts, logprobs within 1e-5: at ``decode_steps`` 1 and 4 for both
    configs, and for DeepSeek-V2-Lite on a tight pool with swap-mode
    preemption and with ``cache_compressed_prefixes`` over two rounds that
    share a prefix. The port's serves run under ``chip_smoke.TieRecorder``:
    a stream may part only at a recorded near-tie (a top-2 logit gap,
    survivor margin or router margin under TIE_TOL). Every port engine
    audits its whole state after each step (the sanitizer).
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SamplingParams as JSP
from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariants, serve_model
from repro_torch.models import layers, lm

TOL = 1e-5
TIE_TOL = 1e-4
NAMES = ["deepseek-v2-lite-16b", "dbrx-132b"]
SHAPES = dict(block_size=8, n_total_blocks=64, max_batch=4,
              max_model_len=128, prefill_rows=2, prefill_len=64)
#: tests/test_swap.py's tight pool (10 blocks of 8 for 4 requests)
TIGHT = dict(block_size=8, n_total_blocks=10, max_batch=4, m_qslots=4,
             n_max=3, window=4, max_model_len=256, prefill_rows=2,
             prefill_len=64)
DROP_FREE = 8.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced models' ops are too small to gain
    from more, and beside the suite's other workers threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def sanitized(monkeypatch):
    monkeypatch.setattr(invariants, "enabled", lambda: True)


def _chip_smoke():
    """chip_smoke.py at the repo's root, which holds the near-tie
    recorder; loaded by path, once."""
    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


def configs(name, **kw):
    jcfg = dataclasses.replace(jget_config(name).reduced(), dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **kw)
    return jcfg, tcfg


def build_model(name):
    jcfg, tcfg = configs(name)
    params = jlm.init(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, params=params, tree=tree,
                tparams=params_from_numpy(tcfg, tree))


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    return build_model(request.param)


@pytest.fixture(scope="module")
def deepseek():
    """DeepSeek-V2-Lite alone: the swap and prefix-caching cases."""
    return build_model("deepseek-v2-lite-16b")


def moe_params(model):
    """The first MoE layer's params in both layouts."""
    i = next(i for i, (_, f) in enumerate(lm.layer_specs(model["tcfg"]))
             if f == "moe")
    plan = jlm.build_plan(model["jcfg"])
    if i < len(plan["head"]):
        jp = model["params"]["head"][i]["moe"]
    else:
        jp = jax.tree.map(lambda a: a[0], model["params"]["main"]["0"]["moe"])
    return jp, model["tparams"]["layers"][i]["moe"]


def router_margins(cfg, p, x):
    """Per token, the k-th minus (k+1)-th router probability (B, S)."""
    k = cfg.num_experts_per_tok
    probs = torch.softmax((x.reshape(-1, x.shape[-1]) @ p["router"]).float(),
                          -1)
    top = torch.topk(probs, k + 1, dim=-1)[0]
    return (top[:, k - 1] - top[:, k]).reshape(x.shape[:2])


@pytest.mark.parametrize("capacity", [None, 0.5, DROP_FREE])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_forward_matches_jax(model, groups, capacity):
    """Kept pairs, drops and the combine equal the JAX package's: at 1e-5
    on every token of a group up to its first near-tie (a flip there
    would move the token-major capacity positions of those after it)."""
    cfg = model["tcfg"]
    jp, tp = moe_params(model)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 8, cfg.d_model)).astype(np.float32)
    valid = rng.random((4, 8)) > 0.25
    want = np.asarray(jlayers.moe_forward(
        model["jcfg"], jp, jnp.asarray(x), capacity_factor=capacity,
        valid=jnp.asarray(valid), groups=groups))
    got = layers.moe_forward(cfg, tp, torch.from_numpy(x),
                             capacity_factor=capacity,
                             valid=torch.from_numpy(valid), groups=groups)
    m = router_margins(cfg, tp, torch.from_numpy(x)).reshape(groups, -1)
    clear = torch.cumprod((m > TIE_TOL) | ~torch.from_numpy(valid)
                          .reshape(groups, -1), 1).bool().reshape(4, 8)
    assert int(clear.sum()) >= 24, "too many near-ties for a comparison"
    np.testing.assert_allclose(got[clear].numpy(), want[clear.numpy()],
                               rtol=TOL, atol=TOL)
    if capacity == 0.5:           # C = 4 of 32 pairs an expert: drops
        free = layers.moe_forward(cfg, tp, torch.from_numpy(x),
                                  capacity_factor=DROP_FREE,
                                  valid=torch.from_numpy(valid),
                                  groups=groups)
        assert not torch.allclose(got, free)


def test_forward_matches_jax(model):
    tokens = np.random.default_rng(0).integers(
        0, model["jcfg"].vocab_size, (2, 12))
    want = np.asarray(jlm.forward(model["jcfg"], model["params"],
                                  jnp.asarray(tokens)))
    got = lm.forward(model["tcfg"], model["tparams"],
                     torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), tree.dtype)}


def test_init_tree_matches_jax(model):
    """``lm.init`` makes the tree the JAX package's init carries over to
    (keys, shapes, dtypes: MLA's ``kv_norm`` fp32, the router and experts
    at the compute dtype), at fp32 and at the registered bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(model["tcfg"],
                                  dtype=str(dtype).split(".")[1])
        want = params_from_numpy(cfg, model["tree"], dtype=dtype)
        got = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        assert _shapes(got) == _shapes(want)
        assert lm.param_count(got) == lm.param_count(want)
        assert lm.param_count(got) == jlm_param_count(model["params"])


def jlm_param_count(params):
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))


def test_paged_serve_reproduces_forward(model):
    """Paged prefill + decode of one request reproduce the port's own
    forward logits at a drop-free capacity (the JAX package's
    tests/test_serve_equivalence.py, on the port)."""
    cfg = dataclasses.replace(model["tcfg"], moe_capacity_factor=DROP_FREE)
    params = model["tparams"]
    S_prompt, n_decode, b = 7, 6, 4
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S_prompt + n_decode)))
    ref = lm.forward(cfg, params, tokens)[0]
    spec = serve_model.ServeSpec(n_slots=2, block_size=b, max_blocks=8,
                                 n_total_blocks=64, m_qslots=2, window=4,
                                 prefill_rows=2, prefill_len=16)
    st = serve_model.make_state(cfg, spec, "cpu")
    st["block_tables"][0] = torch.arange(8)
    st["qslot"][0] = 0
    st["seq_lens"][0] = S_prompt
    st["positions"][0] = S_prompt
    i32 = dict(dtype=torch.int32)
    ptoks = torch.zeros((2, 16), dtype=torch.int64)
    ptoks[0, :S_prompt] = tokens[0, :S_prompt]
    got = [serve_model.build_prefill_step(cfg, spec)(
        params, st, ptoks, torch.tensor([0, -1], **i32),
        torch.tensor([S_prompt, 0], **i32), torch.zeros(2, **i32))[0]]
    decode = serve_model.build_decode_step(cfg, spec)
    active = torch.tensor([True, False])
    for pos in range(S_prompt, S_prompt + n_decode - 1):
        got.append(decode(params, st, torch.stack(
            [tokens[0, pos], torch.tensor(0)]), active)[0])
    want = ref[S_prompt - 1:S_prompt + n_decode - 1]
    np.testing.assert_allclose(torch.stack(got).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_configs_serve_at_bf16_on_the_cpu(model):
    """Both configs' registered dtype serves: ``dtype="bfloat16"`` casts
    the weights (the router and experts too, MLA's ``kv_norm`` left
    fp32) and the streams are finite tokens of the vocabulary."""
    z = Zipage(model["tcfg"], model["tparams"], device="cpu",
               dtype="bfloat16", **SHAPES)
    layer = z.engine.params["layers"][-1]
    assert layer["moe"]["router"].dtype == torch.bfloat16
    if "kv_norm" in layer["attn"]:
        assert layer["attn"]["kv_norm"].dtype == torch.float32
    outs = z.generate(prompts(model["tcfg"].vocab_size)[:2],
                      SamplingParams(max_new_tokens=16))
    assert all(len(o.token_ids) == 16 for o in outs)
    assert z.num_free_blocks == SHAPES["n_total_blocks"]


# ----------------------------------------------------------------------
# the facade against the JAX package's


def prompts(vocab, seed=1, lens=(30, 70, 21)):
    """Random prompts (no repeated-token runs, which make survivor
    near-ties), one of them longer than the prefill bucket."""
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, n)] for n in lens]


@pytest.fixture(scope="module")
def jax_facade(model):
    """One JAX facade per config, at SHAPES; its streams are the same at
    any ``decode_steps`` (the JAX package's own tests)."""
    return JZipage(model["jcfg"], model["params"], kernel_backend="jnp",
                   **SHAPES)


def held_equal(port_outs, jax_outs, rec, label):
    """Equal streams, finish reasons and compression counts, logprobs
    within TOL; a stream may part only at a near-tie ``rec`` recorded in
    the port's engine (its first), and then the rest of it is not
    compared."""
    assert len(port_outs) == len(jax_outs)
    for i, (a, b) in enumerate(zip(port_outs, jax_outs)):
        if a.token_ids != b.token_ids:
            pos = _chip_smoke().first_difference(a.token_ids, b.token_ids)
            why = rec.explain(0, a.request_id, pos, TIE_TOL)
            assert why, f"{label}: request {i} parts at token {pos}"
            continue
        assert a.finish_reason == b.finish_reason
        assert a.metrics.compression.n_compressions == \
            b.metrics.compression.n_compressions
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=TOL,
                                   atol=TOL)


def port_generate(z_args, ps, sp, **kw):
    """The port's facade on ``z_args`` serving ``ps`` under a
    TieRecorder; returns (facade, outputs, recorder)."""
    with _chip_smoke().TieRecorder() as rec:
        z = Zipage(*z_args, device="cpu", **kw)
        outs = z.generate(ps, sp)
    return z, outs, rec


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_greedy_streams_match_jax(model, jax_facade, decode_steps):
    ps = prompts(model["jcfg"].vocab_size)
    jo = jax_facade.generate(ps, JSP(max_new_tokens=40, logprobs=True))
    z, to, rec = port_generate(
        (model["tcfg"], model["tparams"]), ps,
        SamplingParams(max_new_tokens=40, logprobs=True),
        decode_steps=decode_steps, **SHAPES)
    held_equal(to, jo, rec, f"{model['name']} decode_steps={decode_steps}")
    n_comp = [o.metrics.compression.n_compressions for o in to]
    assert min(n_comp) > 0
    assert z.num_free_blocks == SHAPES["n_total_blocks"]


def test_swap_on_a_tight_pool_matches_jax(deepseek):
    """DeepSeek-V2-Lite on tests/test_swap.py's tight pool with swap-mode
    preemption, against the JAX facade at the same settings (the same
    preemptions, so the same batches compete for the experts)."""
    model = deepseek
    knobs = dict(TIGHT, preemption_mode="swap", swap_space_blocks=24)
    ps = prompts(model["jcfg"].vocab_size, seed=3, lens=(5, 3, 7, 2))
    jz = JZipage(model["jcfg"], model["params"], kernel_backend="jnp",
                 **knobs)
    jo = jz.generate(ps, JSP(max_new_tokens=28, logprobs=True))
    z, to, rec = port_generate((model["tcfg"], model["tparams"]), ps,
                               SamplingParams(max_new_tokens=28,
                                              logprobs=True), **knobs)
    held_equal(to, jo, rec, "swap")
    assert sum(m["n_swapped_out"] for m in z.metrics) > 0
    assert sum(m["n_swapped_out"] for m in z.metrics) == \
        sum(m["n_swapped_out"] for m in jz.metrics)
    assert len(z.bm.swap_free) == 24 and z.bm.swapped == {}
    assert z.engine._swap_qwin == {}


def test_compressed_prefix_rounds_match_jax(deepseek):
    """DeepSeek-V2-Lite with ``cache_compressed_prefixes``: a 40-token
    prompt served first compresses prompt-pure and registers its
    condensed segment; under the watermark its raw chain is evicted, so
    a second round of two extensions adopts the segment. Both facades
    agree on the streams and on what the cache did."""
    model = deepseek
    knobs = dict(SHAPES, cache_compressed_prefixes=True,
                 prefix_cache_watermark=0.05)
    prefix = prompts(model["jcfg"].vocab_size, seed=4, lens=(40,))[0]
    rounds = [[prefix], [prefix + [7, 8, 9], prefix + [10, 11]]]
    jz = JZipage(model["jcfg"], model["params"], kernel_backend="jnp",
                 **knobs)
    sp = dict(max_new_tokens=16, logprobs=True)
    jo = [jz.generate(r, JSP(**sp)) for r in rounds]
    with _chip_smoke().TieRecorder() as rec:
        z = Zipage(model["tcfg"], model["tparams"], device="cpu", **knobs)
        to = [z.generate(r, SamplingParams(**sp)) for r in rounds]
    for a, b in zip(to, jo):
        held_equal(a, b, rec, "prefix rounds")
    gaps = [z.engine.finished[o.request_id].pos_gap for o in to[1]]
    assert gaps == [jz.engine.finished[o.request_id].pos_gap for o in jo[1]]
    assert min(gaps) > 0, "no extension adopted the segment"
    hits = z.metrics[-1]["prefix_segment_hits"]
    assert hits >= 2 and hits == jz.metrics[-1]["prefix_segment_hits"]
    assert z.num_free_blocks == SHAPES["n_total_blocks"]
