"""The port's seeded eval (``repro_torch.eval``) against the JAX package's
(``repro.eval``): the tasks bit for bit, ``token_agreement``, and
``run_eval``'s rows on the same weights — the reference's
``trained_params(40, 0)`` carried across as numpy copies — at the 6
requests tests/test_eval.py uses, every field equal unless a recorded
near-tie explains a stream that parts (``chip_smoke.TieRecorder``); and
the eval's engines, which admit at a fixed rate whatever the wall clock
reads.
"""
import copy
import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.eval import runner as jax_runner
from repro.eval import tasks as jax_tasks
from repro_torch import convert
from repro_torch.core import engine as engine_mod
from repro_torch.eval import runner, tasks
from repro_torch.eval.runner import render_report, run_eval, token_agreement
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import build_train_step

SMALL = dict(seed=0, n_requests=6, train_steps=40)


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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored after: the
    suite runs six workers on a few cores, where torch's default of one
    spinning thread a core makes these small ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bridged():
    """The reference's trained weights, copied (``np.array``) into the
    port's layout: nothing the port does can reach the reference's
    process-wide ``_train_cache``."""
    tree = jax_runner.trained_params(SMALL["train_steps"], SMALL["seed"])
    return convert.params_from_numpy(
        runner.CFG, jax.tree.map(lambda a: np.array(a), tree))


# ----------------------------------------------------------------------
# tasks

def test_eval_sets_equal_the_reference_bit_for_bit():
    for n, seed in ((9, 0), (18, 0), (7, 3)):
        assert tasks.eval_set(n, seed) == jax_tasks.eval_set(n, seed)
    for kind in tasks.TASK_KINDS:
        for i in range(4):
            ss = np.random.SeedSequence([11, 1, i])
            assert tasks.make_example(kind, np.random.default_rng(ss)) == \
                jax_tasks.make_example(kind, np.random.default_rng(ss))
    with pytest.raises(ValueError, match="unknown eval task kind"):
        tasks.make_example("sudoku", np.random.default_rng(0))


@pytest.mark.parametrize("step,seq_len,batch,seed", [
    (0, 80, 16, 0), (3, 64, 4, 0), (17, 33, 5, 2)])
def test_train_batches_equal_the_reference_bit_for_bit(step, seq_len, batch,
                                                       seed):
    mine = tasks.train_batch(step, seq_len=seq_len, batch=batch, seed=seed)
    ref = jax_tasks.train_batch(step, seq_len=seq_len, batch=batch,
                                seed=seed)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype
        assert np.array_equal(mine[k], ref[k])


def test_token_agreement_matches_the_reference():
    cases = [([1, 2], [1, 2, 3, 4]), ([5], [5]), ([], []), ([], [1, 2]),
             ([9, 2, 9, 4], [1, 2, 3, 4]), ([1, 2, 3, 4, 5, 6], [1, 2, 3, 4]),
             ([1, 2], [])]
    for pred, ref in cases:
        assert token_agreement(pred, ref) == \
            jax_runner.token_agreement(pred, ref)
    assert token_agreement([1, 2], [1, 2, 3, 4]) == 0.5


# ----------------------------------------------------------------------
# run_eval against the reference

def _rows_with_streams(params, recorder=None):
    examples = tasks.eval_set(SMALL["n_requests"], SMALL["seed"])
    with recorder or _chip_smoke().TieRecorder():
        return runner.serve_rows(params, examples, runner.BUDGETS_SMOKE,
                                 device="cpu")


def test_run_eval_rows_equal_the_reference(bridged):
    """At 6 requests every request is admitted by the second step, so the
    reference's wall-clock admission backoff (ROADMAP §C) cannot move its
    rows."""
    ties = _chip_smoke()
    ref = jax_runner.run_eval(**SMALL)
    mine = run_eval(**SMALL, params=bridged)
    assert mine["schema"] == ref["schema"] == runner.EVAL_SCHEMA
    assert mine["config"] == ref["config"]
    assert [r["name"] for r in mine["results"]] == \
        [r["name"] for r in ref["results"]]
    if render_report(mine) == render_report(ref):
        return
    # rows differ: every difference must be a stream that parts at a
    # recorded near-tie of the port's serve
    examples = tasks.eval_set(SMALL["n_requests"], SMALL["seed"])
    ref_rows = [jax_runner._run_budget(
        jax_runner.trained_params(SMALL["train_steps"], SMALL["seed"]),
        examples, name=n, n_max=k, window=w, quality_aware=qa)
        for n, k, w, qa in jax_runner.BUDGETS_SMOKE]
    rec = ties.TieRecorder()
    rows = _rows_with_streams(bridged, rec)
    unexplained, explained = ties.compare_rows(ref_rows, rows, rec)
    assert unexplained == [], (unexplained, explained)


def test_two_port_runs_render_identical_bytes(bridged):
    a = render_report(run_eval(**SMALL, params=bridged))
    b = render_report(run_eval(**SMALL, params=bridged))
    assert a == b
    report = json.loads(a)
    full = report["results"][0]
    assert full["name"] == "full_kv" and full["compressions"] == 0
    assert full["agreement_vs_full"] == 1.0
    assert any(r["compressions"] > 0 for r in report["results"][1:])
    for row in report["results"]:
        assert not any("time" in k or "us_" in k for k in row)
        assert row["n"] == SMALL["n_requests"]


def test_the_recorder_sees_every_token_and_compression(bridged):
    ties = _chip_smoke()
    rec = ties.TieRecorder()
    rows = _rows_with_streams(bridged, rec)
    assert len(rec.gaps) == len(rows)
    for e, row in enumerate(rows):
        for rid, pred in enumerate(row["_preds"]):
            assert all((rid, pos) in rec.gaps[e] for pos in range(len(pred)))
        n_comp = sum(len(v) for v in rec.margins[e].values())
        assert n_comp == row["compressions"]
    # no patch outlives the recorder
    unexplained, _ = ties.compare_rows(rows, _rows_with_streams(bridged))
    assert unexplained == []


def test_compare_rows_names_what_differs():
    ties = _chip_smoke()
    rec = ties.TieRecorder()
    rec._index(types.SimpleNamespace())
    rec.gaps[0][(1, 2)] = 3e-5
    a = [{"name": "r", "x": 1, "_preds": [[1, 2, 3], [4, 5, 6]]}]
    b = [{"name": "r", "x": 1, "_preds": [[1, 2, 3], [4, 5, 7]]}]
    unexplained, explained = ties.compare_rows(a, b, rec)
    assert unexplained == [] and "top-2 logit gap" in explained[0][1]
    c = [{"name": "r", "x": 2, "_preds": [[1, 9, 3], [4, 5, 6]]}]
    unexplained, _ = ties.compare_rows(a, c, rec)
    assert len(unexplained) == 1 and "request 0 parts at token 1" in \
        unexplained[0][1] and "['x']" in unexplained[0][1]


def _jumpy_clock():
    """A clock whose readings step 10x further each time: every engine
    step reads as a straggler, more than 3x the running average."""
    state = {"n": 0, "t": 0.0}

    def monotonic():
        state["n"] += 1
        state["t"] += 1e-3 * 10.0 ** min(state["n"], 200)
        return state["t"]
    return types.SimpleNamespace(monotonic=monotonic)


@pytest.mark.parametrize("fixed", [True, False])
def test_eval_rows_do_not_read_the_wall_clock(bridged, monkeypatch, fixed):
    """Served under a clock that makes some steps stragglers, the eval's
    rows equal those served under the real clock: its engines admit at a
    fixed rate. The control (``fixed=False``) lets the backoff act, and
    the rows change, so the clock does reach the schedule."""
    # the smoke size's 18 requests take five steps to admit: 6 are in
    # after the second step whatever the admission rate
    examples = tasks.eval_set(18, SMALL["seed"])
    budgets = runner.BUDGETS_SMOKE[1:2]
    calm = runner.serve_rows(bridged, examples, budgets, "cpu")
    monkeypatch.setattr(engine_mod, "time", _jumpy_clock())
    if not fixed:
        monkeypatch.setattr(runner, "_fixed_admission", lambda eng: None)
    jumpy = runner.serve_rows(bridged, examples, budgets, "cpu")
    assert (jumpy == calm) == fixed


# ----------------------------------------------------------------------
# the training cache and the no-aliasing rule

def test_trained_params_returns_copies_keyed_by_device():
    a = runner.trained_params(3, 5, device="cpu")
    digest = ckpt.digest(a)
    a["embed"].add_(1.0)
    b = runner.trained_params(3, 5, device="cpu")
    assert ckpt.digest(b) == digest
    assert (3, 5, "cpu") in runner._train_cache
    assert b["embed"].device.type == "cpu"


def test_training_on_bridged_weights_leaves_the_reference_cache_alone(
        bridged):
    tree = jax_runner.trained_params(SMALL["train_steps"], SMALL["seed"])
    before = jax.tree.map(lambda a: np.array(a), tree)
    params = copy.deepcopy(bridged)
    step = build_train_step(runner.CFG, opt.AdamWConfig(lr=1e-2,
                                                        warmup_steps=1),
                            vocab_chunk=64)
    params, _, _, _ = step(params, opt.init_opt_state(params), None,
                           tasks.train_batch(0, seq_len=32, batch=2,
                                             seed=0))
    assert not torch.equal(params["embed"], bridged["embed"])
    after = jax_runner.trained_params(SMALL["train_steps"], SMALL["seed"])
    for x, y in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        assert np.array_equal(x, np.array(y))
