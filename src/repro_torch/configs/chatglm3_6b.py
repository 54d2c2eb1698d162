"""ChatGLM3-6B — RoPE-2d, GQA kv=2.  [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", num_layers=28, d_model=4096,
    num_heads=32, num_kv_heads=2, head_dim=128, d_ff=13696, vocab_size=65024,
    rope="2d", mlp="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="chatglm3-6b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    rope="2d", mlp="swiglu",
)
