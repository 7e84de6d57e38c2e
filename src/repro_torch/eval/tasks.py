"""Seeded synthetic reasoning tasks with checkable final answers (the
port's copy of ``repro.eval.tasks``: numpy only, the same eval sets and
training batches bit for bit).

Three generation-task families over tiny-lm's 512-token vocabulary, all
designed so the answer depends on tokens spread across the *whole*
prompt — exactly the KV entries a compression budget puts at risk
(docs/EVAL.md "Task format"):

* ``recall``     — associative recall: key/value pairs early in the
                   prompt, one queried key at the end; the value's KV
                   entry must survive eviction.
* ``chain_add``  — running-sum arithmetic chain: a start digit and
                   marked deltas interleaved with noise; the answer is
                   the *trace* of mod-10 running sums, so step *j* of
                   the answer needs delta *j*'s KV entry deep in the
                   prompt (plus the model's own previous output).
* ``chain_copy`` — copy chain: reproduce a marked digit sequence; token
                   *i* of the answer needs prompt position *i*'s KV.

Everything is driven by ``numpy.random.Generator`` instances seeded from
``SeedSequence`` namespaces, so example streams are deterministic across
processes and platforms; training draws (``train_batch``) and eval draws
(``eval_set``) live in disjoint seed namespaces.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# token-id layout inside the 512-wide vocab (docs/EVAL.md)
COPY, SEP, QUERY, EQ, KMARK, DMARK, VMARK, CMARK = 2, 3, 4, 5, 6, 7, 8, 9
DIGIT0 = 10        # digits 0..9 -> ids 10..19
KEY0, N_KEYS = 100, 100
NOISE0, N_NOISE = 200, 100

TASK_KINDS = ("recall", "chain_add", "chain_copy")

# per-kind shape knobs (smoke defaults; sized so prompts span several
# 8-token blocks and n_max ∈ {2,3,4} budgets actually bite)
RECALL_PAIRS = 12
CHAIN_DELTAS = 9
COPY_LEN = 16


def _digit(d: int) -> int:
    return DIGIT0 + int(d) % 10


def make_example(kind: str, rng: np.random.Generator
                 ) -> Tuple[List[int], List[int]]:
    """One (prompt_tokens, answer_tokens) example of ``kind``."""
    if kind == "recall":
        keys = rng.choice(N_KEYS, size=RECALL_PAIRS, replace=False)
        vals = rng.integers(0, 10, size=RECALL_PAIRS)
        prompt = []
        for k, v in zip(keys, vals):
            prompt += [KMARK, KEY0 + int(k), VMARK, _digit(v)]
        q = int(rng.integers(0, RECALL_PAIRS))
        prompt += [QUERY, KEY0 + int(keys[q]), EQ]
        return prompt, [_digit(vals[q])]
    if kind == "chain_add":
        v0 = int(rng.integers(0, 10))
        deltas = rng.integers(0, 10, size=CHAIN_DELTAS)
        prompt = [CMARK, DMARK, _digit(v0)]
        for d in deltas:
            noise = rng.integers(0, N_NOISE, size=3)
            prompt += [NOISE0 + int(n) for n in noise]
            prompt += [DMARK, _digit(d)]
        prompt += [EQ]
        sums, acc = [], v0
        for d in deltas:
            acc += int(d)
            sums.append(_digit(acc))
        return prompt, sums
    if kind == "chain_copy":
        seq = rng.integers(0, 10, size=COPY_LEN)
        prompt = [COPY] + [_digit(d) for d in seq] + [EQ]
        return prompt, [_digit(d) for d in seq]
    raise ValueError(f"unknown eval task kind {kind!r}; "
                     f"expected one of {TASK_KINDS}")


def eval_set(n: int, seed: int) -> List[Tuple[str, List[int], List[int]]]:
    """``n`` deterministic eval examples, kinds round-robin. Each example
    draws from its own ``SeedSequence([seed, 1, i])`` stream so the set is
    stable under reordering or resizing."""
    out = []
    for i in range(n):
        kind = TASK_KINDS[i % len(TASK_KINDS)]
        rng = np.random.default_rng(np.random.SeedSequence([seed, 1, i]))
        prompt, answer = make_example(kind, rng)
        out.append((kind, prompt, answer))
    return out


IGNORE = -100   # chunked_xent's ignore_id: no loss at that position


def train_batch(step: int, *, seq_len: int, batch: int, seed: int) -> dict:
    """One packed LM training batch ``{"tokens", "labels"}`` (the
    ``repro.training`` batch contract) drawn from the same task
    distribution as ``eval_set`` but in the disjoint
    ``SeedSequence([seed, 0, step, row])`` namespace: rows concatenate
    whole examples (prompt + answer) back-to-back and truncate to
    ``seq_len + 1``. Loss is masked (``IGNORE``) everywhere except
    answer positions — the prompt tokens are high-entropy random draws
    whose irreducible loss would drown the reasoning signal, and eval
    only ever scores answer positions (prompts are forced)."""
    rows = np.zeros((batch, seq_len + 1), np.int32)
    mask = np.zeros((batch, seq_len + 1), bool)
    for b in range(batch):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0, step, b]))
        kind = TASK_KINDS[(step * batch + b) % len(TASK_KINDS)]
        stream: List[int] = []
        answer_pos: List[int] = []
        while len(stream) < seq_len + 1:
            prompt, answer = make_example(kind, rng)
            answer_pos += range(len(stream) + len(prompt),
                                len(stream) + len(prompt) + len(answer))
            stream += prompt + answer + [SEP]
        rows[b] = stream[:seq_len + 1]
        for pos in answer_pos:
            if pos <= seq_len:
                mask[b, pos] = True
    labels = np.where(mask, rows, IGNORE).astype(np.int32)
    return {"tokens": rows[:, :-1], "labels": labels[:, 1:]}
