"""Token sampling: per-request params and the batch sampler.

``SamplingParams`` is the request-scoped contract of the serving API
(re-exported as ``repro_torch.api.SamplingParams``); it and
``matched_stop`` are the JAX package's ``repro.core.sampling`` unchanged.
``sample_batch`` is the engine's device-side sampler: every row carries its
own temperature and top-k/top-p, so one call serves a continuous batch of
heterogeneous requests.

Randomness is an argument: ``sample_batch`` takes one uniform number per
(row, rank), the noise of its Gumbel-max draw, exactly what
``jax.random.categorical`` draws from the JAX key internally. On the
serving path ``sampling_noise`` makes it with the port's copy of JAX's
threefry generator (``repro_torch.core.prng``) from each row's
(seed, counter), as ``fold_in(key(seed), counter)``: a request's token
stream depends only on its own seed and position, and seeded streams are
the JAX package's, on the card and on the CPU alike.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling / termination parameters (vLLM-style).

    temperature <= 0 means greedy (argmax). ``top_k <= 0`` disables the
    top-k filter; ``top_p`` must be in (0, 1], where exactly ``1.0``
    disables nucleus filtering. ``stop`` is a tuple of
    token-id sequences; a match ends the request with finish reason
    ``"stop"`` and the matched tokens are truncated from the output.
    ``eos_ids`` lists token ids that terminate generation (kept in the
    output); ``None`` disables eos detection entirely — there is no ``-1``
    sentinel in this API. ``seed`` drives the per-request PRNG stream;
    ``logprobs`` requests the sampled token's logprob at each position.

    ``compression_policy`` states the request's KV-compression intent
    (docs/EVAL.md): ``"default"`` follows the engine-wide budget,
    ``"protect"`` defers compression and shields the request from
    preemption while memory allows, ``"aggressive"`` compresses at the
    earliest opportunity and volunteers first for preemption.

    OpenAI spellings are accepted where they map cleanly:
    ``max_tokens`` is a validated alias of ``max_new_tokens`` (passing
    both with different values is an error), and ``n`` is accepted but
    must be 1 — parallel sampling is one-request-per-stream here.
    Unknown keyword arguments are rejected with a did-you-mean error
    rather than silently ignored.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_new_tokens: int = 16
    stop: Tuple[Tuple[int, ...], ...] = ()
    eos_ids: Optional[Tuple[int, ...]] = None
    seed: int = 0
    logprobs: bool = False
    compression_policy: str = "default"
    # OpenAI-spelled aliases (docs/SERVING.md): normalized in __post_init__
    # so equality/replace always see the canonical fields
    max_tokens: Optional[int] = None     # alias of max_new_tokens
    n: int = 1                           # only n=1 is supported

    def __post_init__(self):
        if self.n != 1:
            raise ValueError(
                f"n={self.n} (parallel sampling) is not supported: the "
                "engine serves one stream per request. Submit n separate "
                "requests sharing the prompt (one seed each) and fan the "
                "choices in client-side.")
        if self.max_tokens is not None:
            if (self.max_new_tokens != _DEFAULT_MAX_NEW
                    and self.max_new_tokens != self.max_tokens):
                raise ValueError(
                    f"max_tokens={self.max_tokens} conflicts with "
                    f"max_new_tokens={self.max_new_tokens}; max_tokens is "
                    "an alias — pass one or the other")
            object.__setattr__(self, "max_new_tokens", int(self.max_tokens))
            object.__setattr__(self, "max_tokens", None)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.compression_policy not in ("default", "protect",
                                           "aggressive"):
            raise ValueError(
                "compression_policy must be one of "
                "'default' | 'protect' | 'aggressive'")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        # normalize stop/eos to hashable tuples (lists are convenient at
        # call sites; the engine relies on immutability)
        object.__setattr__(self, "stop", tuple(
            tuple(int(t) for t in s) for s in self.stop))
        if self.eos_ids is not None:
            object.__setattr__(self, "eos_ids", tuple(
                int(t) for t in self.eos_ids))

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    @classmethod
    def from_legacy(cls, max_new_tokens: int, eos_id: int = -1,
                    temperature: float = 0.0, seed: int = 0
                    ) -> "SamplingParams":
        """Map the old ``submit(..., eos_id=-1)`` sentinel convention
        (kept for the frozen ``tests/_legacy_engine.py`` oracle)."""
        return cls(temperature=temperature, seed=seed,
                   max_new_tokens=max_new_tokens,
                   eos_ids=None if eos_id < 0 else (eos_id,))


_DEFAULT_MAX_NEW = 16      # must match the field default above
_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(SamplingParams))

# wrap the dataclass-generated __init__ so unknown keyword arguments get a
# did-you-mean error instead of a bare TypeError (callers routinely arrive
# from JSON request bodies where a typo would otherwise read as "ignored")
_dataclass_init = SamplingParams.__init__


def _checked_init(self, *args, **kwargs):
    unknown = [k for k in kwargs if k not in _PARAM_FIELDS]
    if unknown:
        hints = []
        for k in unknown:
            close = difflib.get_close_matches(k, _PARAM_FIELDS, n=1)
            hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                     if close else ""))
        raise TypeError(
            f"unknown SamplingParams field(s) {', '.join(hints)}; known "
            f"fields: {', '.join(_PARAM_FIELDS)}")
    _dataclass_init(self, *args, **kwargs)


_checked_init.__wrapped__ = _dataclass_init
SamplingParams.__init__ = _checked_init


def matched_stop(output: Sequence[int],
                 params: SamplingParams) -> Optional[Tuple[int, ...]]:
    """The stop token-sequence the output currently ends with, if any."""
    for s in params.stop:
        if s and len(output) >= len(s) and tuple(output[-len(s):]) == s:
            return s
    return None


# ----------------------------------------------------------------------
# device-side sampler

def sampling_noise(seeds, counters, vocab_size):
    """(B, V) uniform noise in [``prng.TINY``, 1) for every row: row i's is what
    ``jax.random.categorical`` draws from ``fold_in(key(seeds[i]),
    counters[i])``. ``seeds`` and ``counters`` are (B,) integer tensors on
    the device that is to hold the noise; nothing is read back to the
    host."""
    return prng.row_uniforms(seeds, counters, vocab_size)


def sample_batch(logits, uniforms, temps, top_k, top_p):
    """Per-row temperature / top-k / top-p sampling.

    logits: (B, V) fp32; uniforms: (B, V) noise in (0, 1), indexed by rank
    in the descending sort of each row; temps/top_p: (B,) fp32; top_k:
    (B,) int32 (<= 0 disables). Returns (tokens (B,) int64, logprobs (B,)
    fp32) where logprobs are the log-softmax of the *unfiltered*
    distribution at the chosen token. Rows with temp <= 0 take the argmax.
    Ties sort toward the lower token id, like ``lax.top_k``.
    """
    V = logits.shape[-1]
    greedy_tok = torch.argmax(logits, -1)
    full_logprobs = torch.log_softmax(logits, -1)
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True,
                                           stable=True)
    ranks = torch.arange(V, device=logits.device)[None, :]
    k = torch.where(top_k > 0, top_k, V)[:, None]
    probs = torch.softmax(sorted_logits, -1)
    cum = torch.cumsum(probs, -1)
    # nucleus: keep tokens while the mass *before* them is < top_p, so the
    # highest-probability token always survives
    keep = (ranks < k) & ((cum - probs) < top_p[:, None])
    masked = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, -float("inf")))
    scaled = masked / temps.clamp(min=1e-6)[:, None]
    gumbel = -torch.log(-torch.log(uniforms))
    rank = torch.argmax(scaled + gumbel, -1)
    sampled_tok = torch.gather(sorted_idx, 1, rank[:, None])[:, 0]
    tok = torch.where(temps <= 0.0, greedy_tok, sampled_tok)
    lp = torch.gather(full_logprobs, 1, tok[:, None])[:, 0]
    return tok, lp
