"""Whisper-tiny [arXiv:2212.04356]: the encoder-decoder backbone; the
conv/mel frontend is a stub.

Only the transformer backbone is modelled: the encoder takes precomputed
frame embeddings (the serving engine passes zeros, as the JAX package's
does). Decoder self-attention KV is paged and compressed; the
cross-attention KV is static, one (cross_seq_len, h_kv, d) entry a slot
and layer. The decoder's self-attention uses RoPE positions.
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_TINY = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,             # decoder layers
    encoder_layers=4,
    cross_seq_len=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    attn_type="gqa",
    ffn_act="gelu",
    norm_type="layernorm",
    frontend="audio_stub",
    tie_embeddings=True,
))
