"""RWKV6-7B (Finch) — attention-free, data-dependent decay.  [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", num_layers=32, d_model=4096,
    num_heads=64, num_kv_heads=64, d_ff=14336, vocab_size=65536,
    mixer="rwkv6", rope="none", norm="layernorm", ssm_head_dim=64,
    subquadratic=True,
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-7b-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    mixer="rwkv6", rope="none", norm="layernorm", ssm_head_dim=16,
    subquadratic=True,
)
