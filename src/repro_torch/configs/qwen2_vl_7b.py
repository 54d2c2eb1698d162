"""Qwen2-VL-7B — M-RoPE; vision frontend stubbed (patch embeds precomputed).
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, head_dim=128, d_ff=18944, vocab_size=152064,
    rope="mrope", rope_theta=1e6, mlp="swiglu", attn_bias=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-7b-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    rope="mrope", mlp="swiglu", attn_bias=True,
)
