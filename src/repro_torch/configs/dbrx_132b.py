"""DBRX-132B [hf:databricks/dbrx-base]: fine-grained MoE, 16 experts top-4."""
from repro_torch.configs.base import ArchConfig, register

DBRX_132B = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,           # dense-equivalent (unused: all layers MoE)
    vocab_size=100352,
    attn_type="gqa",
    rope_theta=500_000.0,
    num_experts=16,
    num_experts_per_tok=4,
    moe_d_ff=10752,
    ffn_act="silu_glu",
    norm_type="layernorm",
))
