"""Deterministic, stateless synthetic data pipeline (the port's
``repro.training.data``, numpy only, bit for bit).

Every batch is a pure function of (seed, step): a restored run at step k
regenerates exactly the batches a never-crashed run would have seen.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    kind: str = "lm"            # lm | copy (needle-retrieval for quality tests)


def batch_at(cfg: DataConfig, step: int):
    """Full global batch at a step (host) — numpy, deterministic."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S = cfg.global_batch, cfg.seq_len
    if cfg.kind == "copy":
        # needle retrieval: random prefix, marker, needle; label = the needle
        toks = rng.integers(4, cfg.vocab_size, size=(B, S))
        half = S // 2
        toks[:, half] = 2                       # marker
        toks[:, half + 1:] = toks[:, 1:S - half]
        tokens = toks
    else:
        tokens = rng.integers(0, cfg.vocab_size, size=(B, S))
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    return {"tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32)}
