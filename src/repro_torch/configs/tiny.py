"""Tiny LM for CPU examples, engine tests and quality-proxy benchmarks."""
from repro_torch.configs.base import ArchConfig, register

TINY_LM = register(ArchConfig(
    name="tiny-lm",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    attn_type="gqa",
    ffn_act="silu_glu",
    norm_type="rmsnorm",
))
