"""Nemotron-4 15B [arXiv:2402.16819]: dense GQA, squared-ReLU FFN, 256k vocab."""
from repro_torch.configs.base import ArchConfig, register

NEMOTRON_4_15B = register(ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    attn_type="gqa",
    ffn_act="sq_relu",
    norm_type="layernorm",
))
