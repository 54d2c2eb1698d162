"""Primitive layers (port of ``repro/models/layers.py``, the decoder subset).

A linear parameter is ``{"w": Tensor[Ci, Co]}`` or, after SmoothQuant+ PTQ,
``{"w": QuantizedTensor}``; :func:`apply_linear` dispatches on the leaf type,
so the same model code serves the fp and W4A16 paths.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import calibration as _calib
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]


def _randn(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------- linear ----
def init_linear(gen: torch.Generator, ci: int, co: int, dtype) -> Params:
    return {"w": _randn(gen, (ci, co), ci ** -0.5, dtype)}


def apply_linear(p: Params, x: torch.Tensor, *, act: str = "a16"
                 ) -> torch.Tensor:
    w = p["w"]
    col = _calib.current_collector()
    if col is not None:
        col.record_input(w, x)
    if isinstance(w, QuantizedTensor):
        return kops.w4a16_matmul(x, w, act=act)
    # fp linear in the input dtype, like the reference's bf16-output dot
    return torch.matmul(x, w.to(x.dtype))


# ----------------------------------------------------------------- norms ----
def init_norm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32, cast back to the input dtype."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ------------------------------------------------------------- embedding ----
def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"table": _randn(gen, (vocab, d), 0.02, dtype)}


def apply_embedding(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def logits_from_embedding(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied head: ``x @ table.T`` with f32 products and sums (the
    reference's ``preferred_element_type=f32``)."""
    return torch.matmul(x.to(torch.float32),
                        p["table"].to(x.dtype).to(torch.float32).T)


# ------------------------------------------------------------------ RoPE ----
@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta^(2i / Dh)`` in f32, computed on the CPU once per device:
    building it per call would copy ``theta`` host→device and stall the
    stream twice per layer and step."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                            exps)).to(device)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 1e4) -> torch.Tensor:
    """Standard rotary embedding; x[B, T, H, Dh], positions[B, T]."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[..., None] * inv      # [B, T, Dh/2]
    return _rotate(x, ang[:, :, None, :])


# ------------------------------------------------------------------ misc ----
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up
