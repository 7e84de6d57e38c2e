"""Qwen2.5-3B [hf:Qwen/Qwen2.5]: dense GQA (kv=2) with QKV bias."""
from repro_torch.configs.base import ArchConfig, register

QWEN2_5_3B = register(ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    attn_type="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    ffn_act="silu_glu",
    norm_type="rmsnorm",
    tie_embeddings=True,
))
