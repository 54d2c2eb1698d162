"""Zamba2-7B — Mamba2 backbone + weight-shared attention every 6 layers.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, num_kv_heads=32, head_dim=112, d_ff=14336, vocab_size=32000,
    mixer="mamba2", ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid=HybridConfig(attn_every=6), subquadratic=True,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid", num_layers=5, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    mixer="mamba2", ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    hybrid=HybridConfig(attn_every=2), subquadratic=True,
)
