"""InternVL2-26B [arXiv:2404.16821]: InternViT frontend (a stub) +
InternLM2-20B LM.

Only the LM backbone is modelled: the forward and the prefill take
precomputed, already-projected patch embeddings as a prefix
(``prefix_embeds``); the serving engine serves the backbone on text.
"""
from repro_torch.configs.base import ArchConfig, register

INTERNVL2_26B = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attn_type="gqa",
    ffn_act="silu_glu",
    norm_type="rmsnorm",
    frontend="vision_stub",
    num_prefix_embeds=256,    # one ViT tile worth of patch embeddings
))
