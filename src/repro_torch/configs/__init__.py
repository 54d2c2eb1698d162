"""Config registry (port of ``repro/configs/__init__.py``).

The paper's own Code Llama family, the dense decoders (Llama-3.2,
Mistral-Large, ChatGLM3 with RoPE-2d, StarCoder2 with LayerNorm, GELU and
biases, Qwen2-VL with M-RoPE and the patch-embedding stub), the Granite MoE,
DeepSeek-V2 (MLA, shared experts), Zamba2 (Mamba2 plus a weight-shared
attention block), RWKV6 and the Whisper encoder-decoder are ported: every
architecture of the reference's registry.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (HybridConfig,  # noqa: F401
                                     MLAConfig, ModelConfig, MoEConfig,
                                     QuantConfig)

ARCH_IDS = ("codellama-7b", "codellama-13b", "codellama-34b",
            "llama3.2-3b", "mistral-large-123b", "chatglm3-6b",
            "starcoder2-15b", "qwen2-vl-7b",
            "granite-moe-1b-a400m", "deepseek-v2-236b", "zamba2-7b",
            "rwkv6-7b", "whisper-medium")

# the reference registry's architectures the port lacks (none left)
NOT_PORTED = ()


def _modname(arch_id: str) -> str:
    """The reference's module name: ``llama3.2-3b`` → ``llama3_2_3b``."""
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; ported: "
            f"{ARCH_IDS} (see ROADMAP.md queue A)")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_modname(arch_id)}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
