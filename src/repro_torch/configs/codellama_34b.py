"""Code Llama-34B — the paper's headline deployment target (GQA kv=8)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codellama-34b", family="dense", num_layers=48, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22016, vocab_size=32016,
    rope="standard", rope_theta=1e6, mlp="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="codellama-34b-smoke", family="dense", num_layers=8, d_model=192,
    num_heads=6, num_kv_heads=2, head_dim=32, d_ff=384, vocab_size=512,
    rope="standard", rope_theta=1e6, mlp="swiglu",
)
