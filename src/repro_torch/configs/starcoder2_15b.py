"""StarCoder2-15B — GQA kv=4, LayerNorm + biases, GELU MLP.  [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense", num_layers=40, d_model=6144,
    num_heads=48, num_kv_heads=4, head_dim=128, d_ff=24576, vocab_size=49152,
    rope="standard", rope_theta=1e5, mlp="gelu", norm="layernorm", attn_bias=True,
)

SMOKE_CONFIG = ModelConfig(
    name="starcoder2-15b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    rope="standard", mlp="gelu", norm="layernorm", attn_bias=True,
)
