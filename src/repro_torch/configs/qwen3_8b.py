"""Qwen3-8B-like — the paper's primary evaluation model (Zipage §5).

Not part of the assigned pool; included so the paper's own experiments have a
first-class config. Dims follow the public Qwen3-8B card.
"""
from repro_torch.configs.base import ArchConfig, register

QWEN3_8B = register(ArchConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    attn_type="gqa",
    qk_norm=True,
    rope_theta=1_000_000.0,
    ffn_act="silu_glu",
    norm_type="rmsnorm",
))
