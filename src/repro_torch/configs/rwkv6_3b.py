"""RWKV-6 (Finch) 3B [arXiv:2404.05892]: attention-free, data-dependent decay.

d_model=2560, head_dim=64 => 40 wkv heads. Decode state is O(1) per request
(no paged KV; Zipage eviction inapplicable).
"""
from repro_torch.configs.base import ArchConfig, register

RWKV6_3B = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,             # wkv heads (d_model / 64)
    num_kv_heads=0,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attn_type="none",
    block_pattern=("rwkv",),
    ffn_act="sq_relu",        # rwkv channel-mix uses relu^2
    norm_type="layernorm",
))
