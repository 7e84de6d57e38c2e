"""Request object and lifecycle states (paper Fig. 2)."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from repro_torch.core.sampling import SamplingParams, matched_stop


class State(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"          # decoding (slot assigned)
    BLOCKED = "blocked"          # in running queue, cannot decode (no block /
    #                              slotless past the b-w boundary)
    COMPRESSING = "compressing"  # async compression in flight, skips decode
    SWAPPED = "swapped"          # preempted to the host swap tier; KV parked
    #                              in CPU memory, awaiting swap-in
    FINISHED = "finished"


class FinishReason:
    STOP = "stop"                # eos token or stop sequence
    LENGTH = "length"            # hit max_new_tokens
    ABORT = "abort"              # cancelled via abort()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    priority: int = 0                  # higher = served first ("priority"
    #                                    scheduler policy; FCFS ignores it)

    state: State = State.WAITING
    output: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    blocks: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    qslot: int = -1
    compressed: bool = False           # has undergone >=1 compression
    seq_len: int = 0                   # cache entries (cache order)
    position: int = 0                  # absolute next position
    n_cached: int = 0                  # prefix-cache hit tokens
    # compressed-prefix adoption (docs/CACHING.md): token position minus
    # cache index. 0 normally; a segment hit sets it to the tokens the
    # compressed payload condensed away (span - k), and the engine's
    # prefill subtracts it when deriving cache-write indices from token
    # positions.
    pos_gap: int = 0
    chain: List[int] = dataclasses.field(default_factory=list)
    n_shared: int = 0                  # shared blocks at admission
    preempt_count: int = 0
    n_swaps: int = 0                   # swap-mode preemptions among those
    win_count: int = 0                 # observation-window entries captured

    # chunked-prefill progress (owned by repro_torch.core.scheduler): tokens of
    # ``full_prompt`` already written to the KV cache vs the admission-time
    # target. Equal once prefill completes; a token-budget-limited step may
    # leave a gap that later steps close.
    n_prefilled: int = 0
    prefill_target: int = 0

    # per-request compression metrics
    n_compressions: int = 0            # compression events undergone
    comp_blocks_freed: int = 0         # blocks released by those events

    # quality telemetry from the last compression launch (written back by
    # the engine one step later, once the stats fetch is free): mean raw
    # redundancy over retained entries and normalized window-attention
    # entropy in [0, 1]. None until the request first compresses. The
    # scheduler's quality-aware planner (docs/EVAL.md) orders candidates
    # and shields eviction victims with these.
    redundancy: Optional[float] = None
    attn_entropy: Optional[float] = None

    # metrics
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None

    @property
    def full_prompt(self) -> List[int]:
        """Effective prompt on (re-)admission: original + generated so far."""
        return self.prompt + self.output

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def prefill_pending(self) -> bool:
        """True while admitted but not yet fully prefilled (chunked prefill
        spread over multiple steps by the scheduler's token budget)."""
        return self.n_prefilled < self.prefill_target

    def remaining_work(self) -> int:
        """Tokens still to process (prefill remainder + decode remainder);
        the shortest-remaining ("srpt") policy key."""
        if self.state == State.WAITING:
            pre = len(self.prompt) + len(self.output)
        else:
            pre = max(0, self.prefill_target - self.n_prefilled)
        return pre + max(0, self.max_new_tokens - len(self.output))

    def tokens_in_last_block(self, block_size: int) -> int:
        r = self.seq_len % block_size
        return block_size if (r == 0 and self.seq_len > 0) else r

    def check_finish(self) -> Optional[str]:
        """Finish reason the request has reached, or None if still going."""
        sp = self.sampling
        if self.output:
            if sp.eos_ids is not None and self.output[-1] in sp.eos_ids:
                return FinishReason.STOP
            if matched_stop(self.output, sp) is not None:
                return FinishReason.STOP
        if len(self.output) >= self.max_new_tokens:
            return FinishReason.LENGTH
        return None

    def done(self) -> bool:
        return self.check_finish() is not None

    def truncate_stop(self) -> None:
        """Drop a matched stop sequence from the tail of the output
        (eos tokens are kept, vLLM-style)."""
        s = matched_stop(self.output, self.sampling)
        if s is not None:
            del self.output[-len(s):]
            del self.logprobs[len(self.output):]
