"""Llama-3 8B [arXiv:2407.21783]: dense GQA, 128k vocab."""
from repro_torch.configs.base import ArchConfig, register

LLAMA3_8B = register(ArchConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    attn_type="gqa",
    rope_theta=500_000.0,
    ffn_act="silu_glu",
    norm_type="rmsnorm",
))
