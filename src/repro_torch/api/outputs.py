"""Result objects returned by the ``Zipage`` facade.

Callers never see raw ``repro_torch.core.request.Request`` internals: the facade
translates them into immutable-ish snapshots — ``RequestOutput`` for the
request-level view (batch ``generate()`` and per-step streaming state) and
``CompletionChunk`` for the incremental delta a single ``step()`` produced.

Both carry the fields an OpenAI-protocol layer needs verbatim
(docs/SERVING.md): ``finish_reason`` in ``{"stop", "length", "abort"}``
and a ``UsageInfo`` record (prompt/completion/total token counts), so
``repro_torch.serve`` maps responses 1:1 without recomputing anything.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

from repro_torch.core.request import FinishReason, Request  # noqa: F401 (re-export)


@dataclasses.dataclass(frozen=True)
class UsageInfo:
    """OpenAI-shaped token accounting for one request."""
    prompt_tokens: int
    completion_tokens: int
    total_tokens: int

    @classmethod
    def of(cls, n_prompt: int, n_completion: int) -> "UsageInfo":
        return cls(prompt_tokens=n_prompt, completion_tokens=n_completion,
                   total_tokens=n_prompt + n_completion)


@dataclasses.dataclass(frozen=True)
class CompressionMetrics:
    """Per-request Compressed-PagedAttention accounting (paper §4)."""
    n_compressions: int          # compression events this request underwent
    blocks_freed: int            # pool blocks physically freed by them
    kv_tokens_held: int          # live KV-cache entries at snapshot time
    kv_budget_tokens: Optional[int]  # (n_max-1)*block_size, None = full KV


@dataclasses.dataclass(frozen=True)
class RequestMetrics:
    arrival: float
    t_first_token: Optional[float]
    t_finish: Optional[float]
    preempt_count: int
    n_cached_prompt_tokens: int  # prefix-cache hit tokens at admission
    compression: CompressionMetrics


@dataclasses.dataclass(frozen=True)
class CompletionChunk:
    """Tokens a request gained in one engine step (streaming delta).

    ``finish_reason`` is set (``"stop" | "length" | "abort"``) on the
    chunk that finishes the request — the streaming protocol's terminal
    marker — and ``usage`` rides along on that same final chunk, so an
    SSE layer emits OpenAI's last-chunk usage record without a second
    lookup. Both are None on intermediate chunks.
    """
    request_id: int
    index: int                   # offset of token_ids[0] in the full output
    token_ids: List[int]
    logprobs: Optional[List[float]]
    finish_reason: Optional[str] = None
    usage: Optional[UsageInfo] = None


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Snapshot of one request's progress, vLLM-style.

    ``token_ids`` is the full output so far (stop sequences already
    truncated); ``chunk`` is the delta since the previous emission, when
    the output came from ``Zipage.step()``. ``finish_reason`` is one of
    ``"stop" | "length" | "abort"`` once ``finished``. ``usage`` is the
    OpenAI-shaped token accounting at snapshot time.
    """
    request_id: int
    prompt_token_ids: List[int]
    token_ids: List[int]
    finished: bool
    finish_reason: Optional[str]
    logprobs: Optional[List[float]]
    metrics: RequestMetrics
    usage: Optional[UsageInfo] = None
    chunk: Optional[CompletionChunk] = None

    @property
    def n_tokens(self) -> int:
        """Deprecated: use ``usage.completion_tokens`` (one-release shim)."""
        warnings.warn(
            "RequestOutput.n_tokens is deprecated; read "
            "usage.completion_tokens (the OpenAI-shaped UsageInfo record) "
            "instead", DeprecationWarning, stacklevel=2)
        return len(self.token_ids)


def snapshot_request(r: Request, kv_budget_tokens: Optional[int],
                     chunk: Optional[CompletionChunk] = None
                     ) -> RequestOutput:
    """Build a RequestOutput view of an engine-internal Request."""
    return RequestOutput(
        request_id=r.rid,
        prompt_token_ids=list(r.prompt),
        token_ids=list(r.output),
        finished=r.finish_reason is not None,
        finish_reason=r.finish_reason,
        logprobs=list(r.logprobs) if r.sampling.logprobs else None,
        metrics=RequestMetrics(
            arrival=r.arrival,
            t_first_token=r.t_first_token,
            t_finish=r.t_finish,
            preempt_count=r.preempt_count,
            n_cached_prompt_tokens=r.n_cached,
            compression=CompressionMetrics(
                n_compressions=r.n_compressions,
                blocks_freed=r.comp_blocks_freed,
                kv_tokens_held=r.seq_len,
                kv_budget_tokens=kv_budget_tokens)),
        usage=UsageInfo.of(len(r.prompt), len(r.output)),
        chunk=chunk)
