"""Memory planning for Compressed PagedAttention (paper Eq. 1 / Eq. 2), the
port's copy of ``repro.core.memory_planner``.

The byte counts take the serve dtype's size, ``dtype_bytes``
(``dtype_bytes_of``): 4 at float32, the port's default, and 2 at
bfloat16, the JAX package's default, and at float16; at a given
``dtype_bytes`` every figure equals the JAX package's. That accounting counts the global score
F at ``dtype_bytes`` too, though both packages keep F in fp32: at float32
``bytes_per_kv_block`` is the bytes one block takes in the port's K, V and
F pools (``repro_torch.core.serve_model.make_state``), over all layers (the
sink page is not a block); at the 16-bit dtypes it is below them by
``L * b * h_kv * 2`` bytes, and ``pool_bytes_per_kv_block`` gives the
pools' real figure.

Closed-form solution of the linear program: the maximum concurrency is
``M = floor(m_avail / (m_kv·N_max + m_q))`` with
``N_total = floor((m_avail − M·m_q) / m_kv)`` (global score inflates m_kv by
``1 + 1/(2d)`` per Eq. 2).

Configs outside the paper's setting: a local-window config (RecurrentGemma)
runs without compression, and each request holds its ring of
``local_window / block_size`` blocks from admission, so that ring takes
N_max's place; an attention-free config (RWKV6) has no KV block at all,
and ``plan_memory`` refuses it rather than divide by its zero block bytes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    M: int                # maximum concurrency (query slots)
    N_total: int          # KV pool blocks
    m_kv_block: int       # bytes per block (all layers)
    m_q_req: int          # bytes of query cache per request
    bytes_kv_pool: int
    bytes_q_pool: int


def dtype_bytes_of(dtype: str) -> int:
    """Bytes of one K/V element at a serve dtype."""
    return {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]


def bytes_per_kv_block(cfg, block_size, *, dtype_bytes=4, with_global=True):
    """KV bytes of one block across all attention layers (+ F if global)."""
    L = cfg.num_attn_layers
    per_tok = cfg.kv_entry_dim * dtype_bytes
    if with_global:
        # F: one fp32... paper sizes F at 1/(2d) of K+V => one score per
        # (token, kv head) in the KV dtype; we match that accounting.
        if cfg.attn_type == "mla":
            per_tok += 1 * dtype_bytes
        else:
            per_tok += cfg.num_kv_heads * dtype_bytes
    return L * block_size * per_tok


def pool_bytes_per_kv_block(cfg, block_size, *, dtype_bytes=4):
    """The bytes one block really takes in the port's pools, over all
    layers: K and V (or MLA's latent entries) at ``dtype_bytes``, F in
    fp32, one score per kv head (GQA) or one per token (MLA)."""
    f_width = 1 if cfg.attn_type == "mla" else cfg.num_kv_heads
    return cfg.num_attn_layers * block_size * (
        cfg.kv_entry_dim * dtype_bytes + f_width * 4)


def bytes_q_per_request(cfg, window, *, dtype_bytes=4):
    L = cfg.num_attn_layers
    if cfg.attn_type == "mla":
        dq = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        dq = cfg.head_dim
    return L * window * cfg.num_heads * dq * dtype_bytes


def plan_memory(cfg, m_available: int, n_max: int, *, block_size,
                window=16, with_global=True, dtype_bytes=4) -> MemoryPlan:
    if cfg.num_attn_layers == 0:
        raise ValueError(f"{cfg.name} is attention-free: it has no KV block "
                         "to plan (its per-request state is fixed)")
    if cfg.local_window:
        n_max = -(-cfg.local_window // block_size)   # the ring, held whole
    m_kv = bytes_per_kv_block(cfg, block_size, dtype_bytes=dtype_bytes,
                              with_global=with_global)
    m_q = bytes_q_per_request(cfg, window, dtype_bytes=dtype_bytes)
    M = int(m_available // (m_kv * n_max + m_q))
    if M <= 0:
        raise ValueError("not enough memory for a single request at this "
                         f"N_max: avail={m_available}, need={m_kv * n_max + m_q}")
    N_total = int((m_available - M * m_q) // m_kv)
    # constraint M <= N_total / N_max holds by construction; assert anyway
    assert M <= N_total / n_max + 1e-9
    return MemoryPlan(M=M, N_total=N_total, m_kv_block=m_kv, m_q_req=m_q,
                      bytes_kv_pool=N_total * m_kv, bytes_q_pool=M * m_q)
