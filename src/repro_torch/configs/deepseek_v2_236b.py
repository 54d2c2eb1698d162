"""DeepSeek-V2-236B — MLA (kv_lora=512) + MoE 160e top-6, 2 shared experts.
[arXiv:2405.04434; hf]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    num_heads=128, num_kv_heads=128, d_ff=1536, vocab_size=102400,
    mixer="mla", rope="standard", mlp="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536, num_shared_experts=2),
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-236b-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=32, vocab_size=256,
    mixer="mla", rope="standard", mlp="swiglu",
    mla=MLAConfig(kv_lora_rank=16, q_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=32, num_shared_experts=1,
                  capacity_factor=4.0),
)
