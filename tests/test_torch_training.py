"""Training in the port (``repro_torch.training``, ``lm.lm_loss``, the
training launcher) held against the JAX package's on shared numpy inputs.

The optimizer and schedule at 1e-6; the batches bit for bit; the chunked
loss and its gradient at a relative 1e-5; 20 steps of the eval's training
recipe from the reference's init at 1e-4; accumulation; a checkpoint
restart bit for bit; bf16 steps at the relative L2 of
tests/test_torch_bf16.py. JAX arrays cross into torch only as copies
(``np.array``), never as views of JAX buffers.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.eval import tasks as jax_tasks
from repro.models import lm as jax_lm
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import batch_at as jax_batch_at
from repro.training.train_loop import build_train_step as jax_build_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.eval import tasks
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.train_loop import build_train_step, microbatch

JAX_CFG = dataclasses.replace(jax_get_config("tiny-lm"), dtype="float32")
CFG = dataclasses.replace(get_config("tiny-lm"), dtype="float32")
#: the eval's training recipe (repro.eval.runner.trained_params)
EVAL_ADAMW = dict(lr=3e-3, warmup_steps=20, total_steps=300)
REL_L2_BF16 = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored after: the
    suite runs six workers on a few cores, where torch's default of one
    spinning thread a core makes these small ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A JAX tree as numpy copies (never views of JAX buffers)."""
    return jax.tree.map(lambda a: np.array(a), tree)


def _port_params(jax_params, dtype=torch.float32):
    return convert.params_from_numpy(CFG, _np(jax_params), dtype=dtype)


def _task_batch(i, seq_len=80, batch=16):
    return tasks.train_batch(i, seq_len=seq_len, batch=batch, seed=0)


def _max_abs(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(opt.tree_leaves(a), opt.tree_leaves(b)))


def _rel_l2(a, b):
    return max(float((x.float() - y.float()).norm()
                     / y.float().norm().clamp(min=1e-30))
               for x, y in zip(opt.tree_leaves(a), opt.tree_leaves(b)))


@pytest.fixture(scope="module")
def jax_init():
    return jax_lm.init(JAX_CFG, jax.random.key(0))


# ----------------------------------------------------------------------
# optimizer and schedule

def test_lr_at_matches_reference():
    cfg = dict(lr=1e-2, warmup_steps=7, total_steps=60, min_lr_frac=0.1)
    mine, ref = opt.AdamWConfig(**cfg), jax_opt.AdamWConfig(**cfg)
    for step in list(range(0, 12)) + [20, 33, 59, 60, 61, 90]:
        want = float(jax_opt.lr_at(ref, step))
        assert opt.lr_at(mine, step) == pytest.approx(want, rel=1e-6,
                                                      abs=1e-12), step


def test_adamw_update_matches_reference_with_clipping():
    """Five updates across the end of warm-up (warm-up 3), with gradients
    large enough that clipping by global norm fires at every step."""
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=0.5,
               weight_decay=0.1)
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4)}}
    p_np = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                        shapes, is_leaf=lambda s: isinstance(s, tuple))
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = jax.tree.map(lambda a: torch.tensor(a), p_np)
    jstate, tstate = jax_opt.init_opt_state(jp), opt.init_opt_state(tp)
    for i in range(5):
        g_np = jax.tree.map(lambda a: (3 * rng.standard_normal(a.shape))
                            .astype(np.float32), p_np)
        jp, jstate, jgn = jax_opt.adamw_update(
            jax_opt.AdamWConfig(**cfg), jp, jax.tree.map(jnp.asarray, g_np),
            jstate)
        tp, tstate, tgn = opt.adamw_update(
            opt.AdamWConfig(**cfg), tp,
            jax.tree.map(lambda a: torch.tensor(a), g_np), tstate)
        assert float(jgn) > cfg["grad_clip"]          # clipping fires
        assert float(tgn) == pytest.approx(float(jgn), rel=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        for mine, ref in ((tp, jp), (tstate["m"], jstate["m"]),
                          (tstate["v"], jstate["v"])):
            for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
                np.testing.assert_allclose(a.numpy(), np.array(b),
                                           rtol=1e-6, atol=1e-6)


def test_adamw_update_keeps_param_dtype_and_fp32_state():
    p = {"w": torch.ones(4, 3, dtype=torch.bfloat16),
         "n": torch.ones(3, dtype=torch.float32)}
    st = opt.init_opt_state(p)
    g = {"w": torch.full((4, 3), 0.5, dtype=torch.bfloat16),
         "n": torch.full((3,), 0.5)}
    opt.adamw_update(opt.AdamWConfig(lr=0.1, warmup_steps=1), p, g, st)
    assert p["w"].dtype == torch.bfloat16 and p["n"].dtype == torch.float32
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    assert float(p["w"][0, 0]) < 1.0
    assert torch.is_grad_enabled()


# ----------------------------------------------------------------------
# data

@pytest.mark.parametrize("kind", ["lm", "copy"])
def test_batch_at_bit_for_bit(kind):
    for seed, step in ((0, 0), (3, 17)):
        mine = batch_at(DataConfig(seq_len=33, global_batch=5,
                                   vocab_size=512, seed=seed, kind=kind),
                        step)
        ref = jax_batch_at(JaxDataConfig(seq_len=33, global_batch=5,
                                         vocab_size=512, seed=seed,
                                         kind=kind), step)
        assert mine.keys() == ref.keys()
        for k in ref:
            assert mine[k].dtype == ref[k].dtype
            assert np.array_equal(mine[k], ref[k])


def test_microbatch_splits_the_leading_dim():
    b = {"tokens": torch.arange(24).reshape(6, 4)}
    m = microbatch(b, 3)["tokens"]
    assert m.shape == (3, 2, 4) and torch.equal(m[1], b["tokens"][2:4])


# ----------------------------------------------------------------------
# loss and gradients

def _labels_with_ignores(seq_len, batch):
    b = batch_at(DataConfig(seq_len=seq_len, global_batch=batch,
                            vocab_size=512, seed=5), 0)
    labels = b["labels"].copy()
    labels[:, ::3] = -100
    labels[0, -1] = -100
    return b["tokens"], labels


@pytest.mark.parametrize("what", ["chunked_xent", "lm_loss"])
def test_loss_and_gradient_match_jax(jax_init, what):
    """S = 40 over chunks of 16 (not a multiple) with a third of the
    labels ignored: the loss and every leaf's gradient at a relative
    1e-5 (L2 for the gradients)."""
    tokens, labels = _labels_with_ignores(40, 3)
    chunk = 16
    if what == "chunked_xent":
        hidden_np = np.random.default_rng(1).standard_normal(
            (3, 40, CFG.d_model)).astype(np.float32)

        def jax_fn(p, h):
            s, n = jax_lm.chunked_xent(JAX_CFG, p, h, jnp.asarray(labels),
                                       chunk=chunk)
            return s / n

        jl, (jg, jgh) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
            jax_init, jnp.asarray(hidden_np))
        p = _port_params(jax_init)
        h = torch.tensor(hidden_np, requires_grad=True)
        xs = opt.tree_leaves(p)
        for x in xs:
            x.requires_grad_(True)
        s, n = lm.chunked_xent(CFG, p, h, torch.tensor(labels), chunk=chunk)
        assert int(n) == int((labels != -100).sum())
        loss = s / n
        grads = torch.autograd.grad(loss, xs + [h], allow_unused=True)
        gh = grads[-1]
        np.testing.assert_allclose(gh.numpy(), np.array(jgh), rtol=1e-5,
                                   atol=1e-9)
        grads = grads[:-1]
    else:
        batch = {"tokens": tokens, "labels": labels}
        jl, jg = jax.value_and_grad(
            lambda p: jax_lm.lm_loss(JAX_CFG, p, jax.tree.map(jnp.asarray,
                                                              batch),
                                     vocab_chunk=chunk))(jax_init)
        p = _port_params(jax_init)
        xs = opt.tree_leaves(p)
        for x in xs:
            x.requires_grad_(True)
        loss = lm.lm_loss(CFG, p, {k: torch.tensor(v)
                                   for k, v in batch.items()},
                          vocab_chunk=chunk)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    ref = convert.params_from_numpy(CFG, _np(jg))
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(xs, grads)]
    for key_grad, ref_grad in zip(got, opt.tree_leaves(ref)):
        rel = float((key_grad - ref_grad).norm()
                    / ref_grad.norm().clamp(min=1e-30))
        assert rel < 1e-5 or float(ref_grad.abs().max()) == 0.0


#: the architectures of tests/test_models_smoke.py
SMOKE_ARCHS = [
    "recurrentgemma-2b", "deepseek-v2-lite-16b", "dbrx-132b", "llama3-8b",
    "nemotron-4-15b", "olmo-1b", "qwen2.5-3b", "rwkv6-3b", "whisper-tiny",
    "internvl2-26b",
]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_loss_gradients_match_jax_on_every_architecture(arch):
    """Each architecture's reduced config in fp32, on the JAX package's
    init: the port's ``lm_loss`` and its gradient by every leaf against
    ``jax.value_and_grad`` of the JAX ``lm_loss`` (relative L2 1e-4 per
    leaf), with the frontend's embeddings where the config has one. This
    holds training on the recurrent mixers (RG-LRU, RWKV6), MoE, MLA and
    the encoder-decoder and prefix paths."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16))}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = (0.02 * rng.standard_normal(
            (2, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["frame_embeds"] = (0.02 * rng.standard_normal(
            (2, cfg.cross_seq_len, cfg.d_model))).astype(np.float32)
    params = jax.jit(jax_lm.init, static_argnums=0)(jcfg, jax.random.key(0))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_lm.lm_loss(jcfg, p, jax.tree.map(jnp.asarray, batch),
                                 vocab_chunk=8)))(params)
    p = convert.params_from_numpy(cfg, _np(params))
    xs = opt.tree_leaves(p)
    for x in xs:
        x.requires_grad_(True)
    loss = lm.lm_loss(cfg, p, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, vocab_chunk=8)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    ref = opt.tree_leaves(convert.params_from_numpy(cfg, _np(jg)))
    assert len(ref) == len(xs)
    bad = []
    for i, (g, r) in enumerate(zip(grads, ref)):
        g = torch.zeros_like(r) if g is None else g
        rn = float(r.norm())
        rel = float((g - r).norm()) / rn if rn else float(g.norm())
        if not rel < 1e-4:
            bad.append((i, tuple(r.shape), rel))
    assert bad == []


def test_remat_changes_no_value(jax_init):
    p = _port_params(jax_init)
    tokens = torch.tensor(_labels_with_ignores(24, 2)[0]).long()
    a = lm.forward_hidden(CFG, p, tokens)
    b = lm.forward_hidden(CFG, p, tokens, remat=True)
    assert torch.equal(a, b)


def test_fp32_masters_forward_as_their_bf16_cast(jax_init):
    """At bf16, fp32 master params give the hidden states and the loss
    gradient path of the same params stored at bf16, bit for bit: the
    forward casts them at each use, as the reference's ``astype``."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    p32 = _port_params(jax_init)
    p16 = lm.cast_params(p32, torch.bfloat16)
    tokens = torch.tensor(_labels_with_ignores(24, 2)[0]).long()
    a = lm.forward_hidden(cfg, p32, tokens, remat=True)
    b = lm.forward_hidden(cfg, p16, tokens)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert torch.equal(lm.forward(cfg, p32, tokens),
                       lm.forward(cfg, p16, tokens))


# ----------------------------------------------------------------------
# train steps

def _run_port(params, n, *, accum=1, start=0, state=None, batch=None):
    step = build_train_step(CFG, opt.AdamWConfig(**EVAL_ADAMW),
                            accum_steps=accum, vocab_chunk=64)
    state = opt.init_opt_state(params) if state is None else state
    batch = batch or _task_batch
    losses, gnorms = [], []
    for i in range(start, start + n):
        params, state, _, m = step(params, state, None, batch(i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return params, state, losses, gnorms


def test_twenty_steps_match_the_reference(jax_init):
    """The eval's recipe (lr 3e-3, warm-up 20, its task batches) for 20
    steps from ``repro.models.lm.init(CFG, key(0))``: the reference's
    jitted ``build_train_step`` against the port's."""
    jstep = jax.jit(jax_build_step(JAX_CFG,
                                   jax_opt.AdamWConfig(**EVAL_ADAMW),
                                   vocab_chunk=64))
    jp, jstate = jax_init, jax_opt.init_opt_state(jax_init)
    jlosses = []
    for i in range(20):
        jp, jstate, _, m = jstep(jp, jstate, None,
                                 jax.tree.map(jnp.asarray,
                                              jax_tasks.train_batch(
                                                  i, seq_len=80, batch=16,
                                                  seed=0)))
        jlosses.append(float(m["loss"]))
    p, state, losses, _ = _run_port(_port_params(jax_init), 20)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0] - 1.0          # it learns
    assert _max_abs(p, convert.params_from_numpy(CFG, _np(jp))) < 1e-4
    assert _max_abs(state["m"], convert.params_from_numpy(
        CFG, _np(jstate["m"]))) < 1e-4
    assert int(state["step"]) == 20
    assert torch.is_grad_enabled()


def _lm_batch(i):
    """Unmasked batches: a mean over micro-batches equals the batch's mean
    only when each micro-batch scores as many labels."""
    return batch_at(DataConfig(seq_len=32, global_batch=8,
                               vocab_size=CFG.vocab_size), i)


def test_accumulation_matches_one_big_batch(jax_init):
    """``accum_steps=2`` against 1 on the same batch: the same loss and
    gradient norm, and parameters at the update's scale (Adam's first
    step divides by sqrt(v) ~ |g|, as tests/test_training.py notes)."""
    p1, _, l1, g1 = _run_port(_port_params(jax_init), 1, batch=_lm_batch)
    p2, _, l2, g2 = _run_port(_port_params(jax_init), 1, accum=2,
                              batch=_lm_batch)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    np.testing.assert_allclose(g2, g1, rtol=1e-4)
    assert _max_abs(p1, p2) <= 2 * opt.lr_at(
        opt.AdamWConfig(**EVAL_ADAMW), 1)


def test_accumulation_matches_the_reference(jax_init):
    """``accum_steps=2`` on the eval's masked batches, where the loss is
    the mean of the micro-batches' means, in both packages."""
    jstep = jax.jit(jax_build_step(JAX_CFG,
                                   jax_opt.AdamWConfig(**EVAL_ADAMW),
                                   accum_steps=2, vocab_chunk=64))
    jp, jstate = jax_init, jax_opt.init_opt_state(jax_init)
    for i in range(3):
        jp, jstate, _, m = jstep(jp, jstate, None,
                                 jax.tree.map(jnp.asarray, _task_batch(i)))
    p, _, losses, gnorms = _run_port(_port_params(jax_init), 3, accum=2)
    assert losses[-1] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert gnorms[-1] == pytest.approx(float(m["grad_norm"]), rel=1e-4)
    assert _max_abs(p, convert.params_from_numpy(CFG, _np(jp))) < 1e-4


def test_pod_axis_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        build_train_step(CFG, opt.AdamWConfig(), pod_axis="pod")


def test_train_step_leaves_requires_grad_and_grad_mode_alone(jax_init):
    p = _port_params(jax_init)
    with torch.no_grad():
        _run_port(p, 1)
        assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled()
    _run_port(p, 1)
    assert torch.is_grad_enabled()
    assert not any(x.requires_grad for x in opt.tree_leaves(p))


def _tree_rel_l2(a, b):
    """Relative L2 of two lists of tensors taken as one vector."""
    num = sum(float(((x.float() - y.float()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.float() ** 2).sum()) for y in b)
    return (num / max(den, 1e-30)) ** 0.5


def test_bf16_steps_against_the_reference(jax_init):
    """Eight steps at bf16 from one init, both packages keeping fp32
    master params cast to bf16 at each use: losses and gradient norms at
    the relative L2 of tests/test_torch_bf16.py, the params leaf by leaf,
    and the update the eight steps made (params minus the init) against
    the reference's over the whole tree. The control: the port's update
    one step short of the reference's fails that check, so an update
    that was lost or not applied could not pass it."""
    n = 8
    jcfg = dataclasses.replace(JAX_CFG, dtype="bfloat16")
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jstep = jax.jit(jax_build_step(jcfg, jax_opt.AdamWConfig(**EVAL_ADAMW),
                                   vocab_chunk=64))
    step = build_train_step(cfg, opt.AdamWConfig(**EVAL_ADAMW),
                            vocab_chunk=64)
    jp, jstate = jax_init, jax_opt.init_opt_state(jax_init)
    init = opt.tree_leaves(_port_params(jax_init))
    p = _port_params(jax_init)
    state = opt.init_opt_state(p)
    for i in range(n):
        if i == n - 1:
            short = [a - b for a, b in zip(opt.tree_leaves(p), init)]
        b = _task_batch(i)
        jp, jstate, _, jm = jstep(jp, jstate, None,
                                  jax.tree.map(jnp.asarray, b))
        p, state, _, m = step(p, state, None, b)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=REL_L2_BF16)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=REL_L2_BF16)
    assert p["layers"][0]["attn"]["wq"].dtype == torch.float32
    assert state["m"]["layers"][0]["attn"]["wq"].dtype == torch.float32
    ref = convert.params_from_numpy(CFG, _np(jp))
    assert _rel_l2(p, ref) < REL_L2_BF16
    update = [a - b for a, b in zip(opt.tree_leaves(p), init)]
    want = [a - b for a, b in zip(opt.tree_leaves(ref), init)]
    assert _tree_rel_l2(update, want) < REL_L2_BF16
    assert _tree_rel_l2(short, want) > 5 * REL_L2_BF16     # the control


# ----------------------------------------------------------------------
# checkpoints

def test_restart_from_a_checkpoint_is_bit_for_bit(jax_init, tmp_path):
    """Save at step 10, restore into a fresh tree, run to 20: the same
    bits as the run that never stopped, params and optimizer state."""
    small = functools.partial(_task_batch, seq_len=40, batch=4)
    p, st, _, _ = _run_port(_port_params(jax_init), 10, batch=small)
    ckpt.save(str(tmp_path), 10, {"params": p, "opt": st},
              extra={"data_step": 10})
    p, st, l_b, _ = _run_port(p, 10, start=10, state=st, batch=small)

    fresh = _port_params(jax_init)
    tree = {"params": fresh, "opt": opt.init_opt_state(fresh)}
    digest_before = ckpt.digest(tree)
    tree, extra = ckpt.restore(str(tmp_path), 10, tree)
    assert extra == {"data_step": 10}
    assert ckpt.digest(tree) != digest_before
    p2, st2, l_c, _ = _run_port(tree["params"], 10, start=10,
                                state=tree["opt"], batch=small)
    assert l_c == l_b
    for a, b in zip(opt.tree_leaves({"p": p2, "o": st2}),
                    opt.tree_leaves({"p": p, "o": st})):
        assert torch.equal(a, b)
    assert ckpt.digest({"params": p2, "opt": st2}) == \
        ckpt.digest({"params": p, "opt": st})


def test_checkpoint_keep_atomic_tmp_and_bf16_bits(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.randn(3, 4).to(torch.bfloat16),
            "s": torch.tensor(7, dtype=torch.int32),
            "l": [torch.randn(5)]}
    # a leftover half-written save is neither a step nor in the way
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) is None
    for step in range(1, 6):
        ckpt.save(d, step, tree, extra={"data_step": step}, keep=2)
    assert sorted(x for x in os.listdir(d) if not x.endswith(".tmp")) == \
        ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(d) == 5
    ckpt.save(d, 9, tree, keep=5)
    assert not os.path.exists(os.path.join(d, "step_00000009.tmp"))
    with open(os.path.join(d, "step_00000009", "manifest.json")) as f:
        man = json.load(f)
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(d, "step_00000009",
                                man["leaves"]["w"]["file"])).dtype == np.int16
    like = {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
            "s": torch.tensor(0, dtype=torch.int32), "l": [torch.zeros(5)]}
    out, extra = ckpt.restore(d, 9, like)
    assert out is like and extra == {}
    for a, b in zip(opt.tree_leaves(out), opt.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="checkpoint leaf w"):
        ckpt.restore(d, 9, {"w": torch.zeros(3, 4), "s": like["s"],
                            "l": like["l"]})


# ----------------------------------------------------------------------
# the launcher

def _launch(args, capsys):
    loss = launch_train.main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    return loss, json.loads(lines[-1]), lines


def test_launcher_on_the_cpu_with_a_restart(tmp_path, capsys):
    common = ["--arch", "tiny-lm", "--device", "cpu", "--steps", "8",
              "--seq-len", "24", "--global-batch", "4", "--accum", "2",
              "--vocab-chunk", "16", "--log-every", "2"]
    _, whole, _ = _launch(common, capsys)
    assert whole["device"] == "cpu" and whole["dtype"] == "bfloat16"
    assert whole["param_dtype"] == "float32"         # fp32 masters
    assert len(whole["losses"]) == 8
    assert all(np.isfinite(v) for v in whole["losses"].values())

    d = str(tmp_path / "ck")
    _, first, _ = _launch(common + ["--ckpt-dir", d, "--ckpt-every", "4"],
                          capsys)
    assert first["losses"] == whole["losses"]
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000008"]
    import shutil
    shutil.rmtree(os.path.join(d, "step_00000008"))
    loss, second, lines = _launch(
        common + ["--ckpt-dir", d, "--ckpt-every", "4"], capsys)
    assert second["start_step"] == 4
    restored = [ln for ln in lines if "restored step 4" in ln]
    assert restored and first["saves"]["4"]["digest"] in restored[0]
    # the restarted run sees the never-stopped run's batches and bits
    assert second["losses"] == {k: v for k, v in whole["losses"].items()
                                if int(k) > 4}
    assert second["saves"]["8"]["digest"] == first["saves"]["8"]["digest"]
    assert loss == whole["losses"]["8"]


def test_launcher_pod_meshes_are_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        launch_train.main(["--mesh", "pod1", "--device", "cpu"])
