"""RecurrentGemma-2B [arXiv:2402.19427]: RG-LRU + local attention, 1 attn : 2 lru.

26 layers cycling (rglru, rglru, attn); local window 2048; MQA (kv=1);
sub-quadratic => runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, register

RECURRENTGEMMA_2B = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attn_type="gqa",
    local_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    conv1d_width=4,
    ffn_act="gelu_glu",
    norm_type="rmsnorm",
    tie_embeddings=True,
))
