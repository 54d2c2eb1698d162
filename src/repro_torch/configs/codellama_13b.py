"""Code Llama-13B (paper Table 1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codellama-13b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=40, head_dim=128, d_ff=13824, vocab_size=32016,
    rope="standard", rope_theta=1e6, mlp="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="codellama-13b-smoke", family="dense", num_layers=6, d_model=160,
    num_heads=5, num_kv_heads=5, head_dim=32, d_ff=320, vocab_size=512,
    rope="standard", rope_theta=1e6, mlp="swiglu",
)
