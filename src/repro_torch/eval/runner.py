"""Eval runner (the port's ``repro.eval.runner``): train tiny-lm on the
task distribution, serve the eval set across compression budgets through
``repro_torch.api.Zipage``, score against Full-KV (docs/EVAL.md).

Every number in the emitted ``zipage-eval/v1`` report is deterministic —
seeded data, greedy decoding, *step-count-based* throughput proxies
(tokens/step, compressions, block utilization) instead of wall-clock, and
engines that admit at a fixed rate (``_fixed_admission``) — so two runs
of ``python -m repro_torch.eval --smoke`` on one device produce
byte-identical JSON, cold or warm, on a loaded host or an idle one.

Training and serving run on the card unless ``device="cpu"`` is given.
``run_eval(params=...)`` serves given weights instead of training its
own, so the same weights can be scored on two devices or in two
packages.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.eval import tasks

EVAL_SCHEMA = "zipage-eval/v1"

CFG = dataclasses.replace(get_config("tiny-lm"), dtype="float32")

#: (row name, n_max, window, quality_aware). Full-KV must stay first —
#: it is the reference the other rows are scored against. The ``_qa`` row
#: runs the same budget with the quality-aware planner on, demonstrating
#: the telemetry feedback loop on the same traces.
BUDGETS_SMOKE: Tuple = (
    ("full_kv", None, 4, False),
    ("n2_w4", 2, 4, False),
    ("n3_w4", 3, 4, False),
    ("n4_w4", 4, 4, False),
    ("n3_w4_qa", 3, 4, True),
)
BUDGETS_FULL: Tuple = BUDGETS_SMOKE + (
    ("n3_w8", 3, 8, False),
    ("n4_w8", 4, 8, False),
)

#: serving config shared by every row (only n_max / window / the quality
#: knobs vary): pool sized so the Full-KV baseline never preempts, prefix
#: caching off so rows share nothing, float32 + greedy for determinism
ENGINE_KW = dict(
    block_size=8, n_total_blocks=192, max_batch=16, m_qslots=16,
    scheduling="hybrid", prefix_caching=False, async_compression=True,
    max_model_len=256, prefill_rows=4, prefill_len=64,
    fuse_sampling=True, decode_steps=4, dtype="float32")

TRAIN_SEQ_LEN = 80
TRAIN_BATCH = 16

_train_cache = {}


def _clone(params):
    if isinstance(params, torch.Tensor):
        return params.clone()
    if isinstance(params, dict):
        return {k: _clone(v) for k, v in params.items()}
    return [_clone(v) for v in params]


def trained_params(train_steps: int = 300, seed: int = 0, device=None):
    """tiny-lm briefly trained on the eval task distribution (disjoint
    seed namespace from the eval set — ``tasks.train_batch``), on
    ``device`` (the card by default). Cached process-wide per (steps,
    seed, device); every call returns a copy, so a caller can never
    change the cached weights."""
    from repro_torch.models import lm
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import build_train_step

    dev = resolve_device(device)
    key = (train_steps, seed, str(dev))
    if key not in _train_cache:
        adamw = opt.AdamWConfig(lr=3e-3, warmup_steps=20,
                                total_steps=train_steps)
        step = build_train_step(CFG, adamw, vocab_chunk=64)
        params = lm.init(CFG, torch.Generator(device=dev).manual_seed(seed),
                         dev)
        state = opt.init_opt_state(params)
        for i in range(train_steps):
            batch = tasks.train_batch(i, seq_len=TRAIN_SEQ_LEN,
                                      batch=TRAIN_BATCH, seed=seed)
            params, state, _, _m = step(params, state, None, batch)
        _train_cache[key] = params
    return _clone(_train_cache[key])


def token_agreement(pred: Sequence[int], ref: Sequence[int]) -> float:
    """Top-1 agreement scored over the *reference* length: positions the
    candidate never produced count as disagreement, so a stream that
    stops early is penalised rather than scored on its shared prefix."""
    if not ref:
        return 1.0
    hits = sum(1 for i, t in enumerate(ref)
               if i < len(pred) and pred[i] == t)
    return hits / len(ref)


def _round(x: float, nd: int = 6) -> float:
    return round(float(x), nd)


def _fixed_admission(engine) -> None:
    """Hold the engine's admission rate at its start. The scheduler's
    straggler-aware backoff halves the rate after a step three times
    slower than the running average: a wall-clock reading (a kernel
    module's first load, a busy host) that would change the schedule, and
    with it the report's step counts and compressions. The JAX package's
    eval keeps the backoff (ROADMAP §C)."""
    engine.scheduler.observe_latency = lambda dt: None


def _run_budget(params, examples, *, name: str, n_max: Optional[int],
                window: int, quality_aware: bool, device=None) -> dict:
    """Serve the eval set under one compression budget; returns the
    result row (reference-relative fields filled in by ``score_rows``)
    with the token streams under ``_preds``."""
    from repro_torch.api import SamplingParams, Zipage

    kw = dict(ENGINE_KW, n_max=n_max, window=window)
    if quality_aware:
        kw.update(quality_aware=True, quality_defer_min_free=8)
    z = Zipage(CFG, params, device=device, **kw)
    _fixed_admission(z.engine)
    prompts = [p for _k, p, _a in examples]
    sp = [SamplingParams(max_new_tokens=len(a), seed=0)
          for _k, _p, a in examples]
    outs = z.generate(prompts, sp, max_steps=20_000)

    per_task = {k: [0, 0] for k in tasks.TASK_KINDS}
    n_correct, tok_hits, tok_total = 0, 0, 0
    preds = []
    for (kind, _prompt, answer), out in zip(examples, outs):
        pred = list(out.token_ids)
        preds.append(pred)
        exact = pred == list(answer)
        n_correct += exact
        per_task[kind][0] += exact
        per_task[kind][1] += 1
        tok_hits += sum(1 for i, t in enumerate(answer)
                        if i < len(pred) and pred[i] == t)
        tok_total += len(answer)
    st = z.scheduler_stats
    finished = z.engine.scheduler.finished
    return {
        "name": name,
        "n_max": n_max,
        "window": window,
        "quality_aware": quality_aware,
        "n": len(examples),
        "n_correct": n_correct,
        "accuracy": _round(n_correct / len(examples)),
        "token_accuracy": _round(tok_hits / max(tok_total, 1)),
        "accuracy_by_task": {
            k: _round(c / max(n, 1)) for k, (c, n) in per_task.items()},
        # deterministic throughput proxies (no wall-clock — docstring)
        "steps": z.step_count,
        "tokens": sum(o.usage.completion_tokens for o in outs),
        "tokens_per_step": _round(
            sum(o.usage.completion_tokens for o in outs) / max(z.step_count, 1), 4),
        "compressions": sum(r.n_compressions for r in finished.values()),
        "n_comp_deferred": st["n_comp_deferred"],
        "block_util": _round(np.mean([m["block_util"]
                                      for m in z.metrics]), 4),
        "_preds": preds,
    }


def serve_rows(params, examples, budgets, device=None) -> List[dict]:
    """One ``_run_budget`` row a budget, Full-KV first."""
    return [_run_budget(params, examples, name=name, n_max=n_max,
                        window=window, quality_aware=qa, device=device)
            for name, n_max, window, qa in budgets]


def score_rows(rows: List[dict]) -> List[dict]:
    """Fill in each row's agreement and accuracy against the first
    (Full-KV) row, and drop the token streams."""
    ref = rows[0]
    for row in rows:
        row["agreement_vs_full"] = _round(float(np.mean(
            [token_agreement(p, rp)
             for p, rp in zip(row["_preds"], ref["_preds"])])))
        row["accuracy_vs_full"] = (
            _round(row["accuracy"] / ref["accuracy"])
            if ref["accuracy"] else None)
    for row in rows:
        del row["_preds"]
    return rows


def make_report(rows, *, seed, n_requests, train_steps, smoke) -> dict:
    return {
        "schema": EVAL_SCHEMA,
        "model": "tiny-lm",
        "smoke": bool(smoke),
        "config": {
            "seed": seed,
            "n_requests": n_requests,
            "train_steps": train_steps,
            "tasks": list(tasks.TASK_KINDS),
            "block_size": ENGINE_KW["block_size"],
        },
        "results": rows,
    }


def run_eval(*, seed: int = 0, n_requests: int = 18,
             train_steps: int = 300, full: bool = False,
             smoke: bool = True, params=None, device=None) -> dict:
    """Train (unless ``params`` are given), serve every budget row, score
    against the Full-KV reference; returns the ``zipage-eval/v1`` report
    dict. Given ``params`` serve on their own device."""
    budgets = BUDGETS_FULL if full else BUDGETS_SMOKE
    examples = tasks.eval_set(n_requests, seed)
    if params is None:
        params = trained_params(train_steps, seed, device)
    else:
        device = params["embed"].device
    rows = score_rows(serve_rows(params, examples, budgets, device))
    return make_report(rows, seed=seed, n_requests=n_requests,
                       train_steps=train_steps, smoke=smoke)


def render_report(report: dict) -> str:
    """Byte-stable JSON serialization (sorted keys, trailing newline)."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


def summary_table(report: dict) -> List[str]:
    lines = ["| budget | acc | tok acc | vs full | agree | tok/step "
             "| compressions |",
             "|---|---|---|---|---|---|---|"]
    for r in report["results"]:
        lines.append(
            f"| {r['name']} | {r['accuracy']} | {r['token_accuracy']} "
            f"| {r['accuracy_vs_full']} | {r['agreement_vs_full']} "
            f"| {r['tokens_per_step']} | {r['compressions']} |")
    return lines
