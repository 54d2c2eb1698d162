"""Whisper-medium — enc-dec, conv frontend stubbed.  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio", num_layers=24, enc_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096,
    vocab_size=51865, rope="none", norm="layernorm", mlp="gelu",
    attn_bias=True, encdec=True, tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-medium-smoke", family="audio", num_layers=2, enc_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256, rope="none", norm="layernorm", mlp="gelu",
    attn_bias=True, encdec=True, tie_embeddings=True,
)
