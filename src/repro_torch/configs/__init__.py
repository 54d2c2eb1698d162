"""Config registry (port of ``repro/configs/__init__.py``).

The paper's own Code Llama family, the Granite MoE and DeepSeek-V2 (MLA,
shared experts) are ported; every
other architecture of the reference registry raises a clear "not ported
yet" error.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (MLAConfig, ModelConfig,  # noqa: F401
                                     MoEConfig, QuantConfig)

ARCH_IDS = ("codellama-7b", "codellama-13b", "codellama-34b",
            "granite-moe-1b-a400m", "deepseek-v2-236b")

# the reference registry's other architectures (see ROADMAP.md queue A)
NOT_PORTED = (
    "mistral-large-123b", "chatglm3-6b", "llama3.2-3b", "starcoder2-15b",
    "zamba2-7b", "qwen2-vl-7b", "rwkv6-7b", "whisper-medium",
)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; ported: "
            f"{ARCH_IDS} (see ROADMAP.md queue A)")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
