"""Code Llama-7B — the paper's primary eval model (Llama2 arch)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codellama-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008, vocab_size=32016,
    rope="standard", rope_theta=1e6, mlp="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="codellama-7b-smoke", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    rope="standard", rope_theta=1e6, mlp="swiglu",
)
