"""Dense SwiGLU MLP (port of ``repro/models/mlp.py:init_mlp/apply_mlp``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    return {"gate": L.init_linear(gen, d, f, dt),
            "up": L.init_linear(gen, d, f, dt),
            "down": L.init_linear(gen, f, d, dt)}


def apply_mlp(p: Dict[str, Any], x: torch.Tensor, *, act: str = "a16"
              ) -> torch.Tensor:
    h = L.swiglu(L.apply_linear(p["gate"], x, act=act),
                 L.apply_linear(p["up"], x, act=act))
    return L.apply_linear(p["down"], h, act=act)
