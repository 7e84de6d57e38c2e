"""Architecture config system (the port's own copy).

Every architecture is a frozen ``ArchConfig``; ``repro_torch.models`` builds
the network from this description. The fields, defaults and derived
properties are those of the JAX package's ``repro.configs.base`` so that one
config name means the same network in both packages. ``reduced()`` derives
the family-preserving tiny config used by CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Layer mixer kinds appearing in ``block_pattern``.
MIX_ATTN = "attn"
MIX_RGLRU = "rglru"
MIX_RWKV = "rwkv"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    attn_type: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 0            # >0: sliding-window attention
    qk_norm: bool = False

    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # leading dense layers before MoE stack
    moe_capacity_factor: float = 1.25

    # --- layer mixing pattern (cycled across layers) ---
    block_pattern: Tuple[str, ...] = (MIX_ATTN,)
    lru_width: int = 0               # RG-LRU recurrence width
    conv1d_width: int = 4            # temporal conv width for rglru blocks

    # --- FFN / norms ---
    ffn_act: str = "silu_glu"        # silu_glu | gelu_glu | sq_relu | gelu
    norm_type: str = "rmsnorm"       # rmsnorm | nonparam_ln | layernorm

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0          # >0 => enc-dec; decoder = num_layers
    cross_seq_len: int = 1500        # stub encoder output length

    # --- modality frontend stubs ---
    frontend: str = "none"           # none | audio_stub | vision_stub
    num_prefix_embeds: int = 0       # VLM: number of injected patch embeddings

    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return all(m != MIX_ATTN for m in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode cost is independent of total context length."""
        return self.attention_free or (
            self.local_window > 0 and MIX_ATTN in self.block_pattern
            and all(m in (MIX_ATTN, MIX_RGLRU, MIX_RWKV) for m in self.block_pattern)
            and (self.local_window > 0)
        )

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def kv_entry_dim(self) -> int:
        """Per-token per-layer KV width stored in one paged cache entry."""
        if self.attn_type == "mla":
            # latent c_kv + decoupled rope key, shared across heads
            return self.kv_lora_rank + self.qk_rope_head_dim
        return 2 * self.num_kv_heads * self.head_dim  # K and V

    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind per layer, cycling block_pattern."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for k in self.layer_kinds() if k == MIX_ATTN)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.layer_kinds():
            if kind == MIX_ATTN:
                if self.attn_type == "mla":
                    r, dr = self.kv_lora_rank, self.qk_rope_head_dim
                    hq, dh, dv = self.num_heads, self.head_dim, self.v_head_dim
                    n += d * hq * (dh + dr)          # q proj (nope + rope)
                    n += d * (r + dr)                # kv down proj
                    n += r * hq * (dh + dv)          # kv up proj
                    n += hq * dv * d                 # out proj
                else:
                    hq, hkv, dh = self.num_heads, self.num_kv_heads, self.head_dim
                    n += d * hq * dh + 2 * d * hkv * dh + hq * dh * d
            elif kind == MIX_RGLRU:
                w = self.lru_width or d
                n += 2 * d * w + w * d               # in (x,gate) + out proj
                n += self.conv1d_width * w + 2 * w   # conv + lru gates (approx)
                n += 2 * w * (w // max(1, self.num_heads))  # input/rec gate proj (block diag)
            elif kind == MIX_RWKV:
                n += 6 * d * d                       # r,k,v,g,o,w projections (approx)
            # FFN
            gated = self.ffn_act.endswith("_glu")
            ff_mult = 3 if gated else 2
            if self.num_experts > 0:
                n += d * self.num_experts            # router
                n += self.num_experts * ff_mult * d * self.moe_d_ff
                n += self.num_shared_experts * ff_mult * d * self.moe_d_ff
            else:
                n += ff_mult * d * self.d_ff
        if self.encoder_layers:
            hq, hkv, dh = self.num_heads, self.num_kv_heads, self.head_dim
            gated = self.ffn_act.endswith("_glu")
            ff_mult = 3 if gated else 2
            per = d * hq * dh + 2 * d * hkv * dh + hq * dh * d + ff_mult * d * self.d_ff
            n += self.encoder_layers * per
            # decoder cross-attention
            n += self.num_layers * (d * hq * dh + 2 * d * hkv * dh + hq * dh * d)
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        dense = dataclasses.replace(self, num_experts=0, num_shared_experts=0)
        n = dense.param_count()
        gated = self.ffn_act.endswith("_glu")
        ff_mult = 3 if gated else 2
        moe_layers = self.num_layers - self.first_dense_layers
        # remove the dense FFN we counted, add router + active experts
        n -= moe_layers * ff_mult * self.d_model * self.d_ff
        act = self.num_experts_per_tok + self.num_shared_experts
        n += moe_layers * (self.d_model * self.num_experts
                           + act * ff_mult * self.d_model * self.moe_d_ff)
        return n

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        pat = len(self.block_pattern)
        num_layers = max(pat, 2 if pat == 1 else pat)
        d_model = 64
        head_dim = 16
        num_heads = 0 if self.num_heads == 0 else 4
        if self.attn_type == "mla":
            kv_heads = num_heads
        elif self.num_kv_heads and self.num_heads:
            kv_heads = max(1, num_heads * self.num_kv_heads // self.num_heads)
        else:
            kv_heads = 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=kv_heads,
            head_dim=head_dim,
            d_ff=128,
            vocab_size=256,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            num_experts=4 if self.num_experts else 0,
            num_experts_per_tok=min(2, self.num_experts_per_tok) if self.num_experts else 0,
            num_shared_experts=min(1, self.num_shared_experts),
            moe_d_ff=32 if self.moe_d_ff else 0,
            first_dense_layers=min(1, self.first_dense_layers),
            lru_width=64 if self.lru_width else 0,
            local_window=32 if self.local_window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            cross_seq_len=8 if self.encoder_layers else self.cross_seq_len,
            num_prefix_embeds=4 if self.num_prefix_embeds else 0,
        )


_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # Import all config modules lazily on first miss.
        from repro_torch import configs as _c  # noqa
        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_arch_names():
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)
