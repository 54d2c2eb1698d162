"""Llama-3.2-3B (small Llama3).  [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
    num_heads=24, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=128256,
    rope="standard", rope_theta=5e5, mlp="swiglu", tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="llama3.2-3b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    rope="standard", mlp="swiglu", tie_embeddings=True,
)
