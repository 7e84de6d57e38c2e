"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: MLA (kv_lora=512) + 64-expert MoE top-6.

The public V2-Lite: 64 routed experts, 2 shared, top-6, expert d_ff=1408,
the first layer dense (the full V2 has 160 routed experts).
"""
from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_V2_LITE = register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,          # MLA: latent shared; heads expanded from latent
    head_dim=128,             # qk_nope_head_dim
    d_ff=10944,               # dense FFN of the first layer
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    ffn_act="silu_glu",
    norm_type="rmsnorm",
))
