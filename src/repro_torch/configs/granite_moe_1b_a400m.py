"""Granite-3.0-1B-A400M — 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
    rope="standard", mlp="swiglu", tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-1b-a400m-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
    rope="standard", mlp="swiglu", tie_embeddings=True,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=32, capacity_factor=4.0),
)
