"""Primitive layers (port of ``repro/models/layers.py``, the decoder subset).

A linear parameter is ``{"w": Tensor[Ci, Co]}`` (plus ``"b": Tensor[Co]``
where the config has biases) or, after SmoothQuant+ PTQ, ``{"w":
QuantizedTensor, ...}``; :func:`apply_linear` dispatches on the leaf type,
so the same model code serves the fp and W4A16 paths.  A norm is RMSNorm
``{"scale"}`` or LayerNorm ``{"scale", "bias"}``; RoPE comes in the
reference's ``standard``, ``2d`` (ChatGLM) and ``mrope`` (Qwen2-VL)
variants, and ``none`` (the encoder-decoder adds sinusoids instead).  Norms, biases, GELU and RoPE are plain PyTorch ops: the
reference computes them outside any Pallas kernel.
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


class MetaGenerator:
    """Stands in for a ``torch.Generator`` when params are built on the
    meta device: shapes and dtypes only, nothing drawn or allocated (a CPU
    generator cannot draw meta tensors)."""
    device = torch.device("meta")


def _randn(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------- linear ----
def init_linear(gen: torch.Generator, ci: int, co: int, dtype,
                bias: bool = False) -> Params:
    p = {"w": _randn(gen, (ci, co), ci ** -0.5, dtype)}
    if bias:
        p["b"] = torch.zeros(co, dtype=dtype, device=gen.device)
    return p


def apply_linear(p: Params, x: torch.Tensor, *, act: str = "a16"
                 ) -> torch.Tensor:
    w = p["w"]
    col = _calib.current_collector()
    if col is not None:
        col.record_input(w, x)
    if isinstance(w, QuantizedTensor):
        y = kops.w4a16_matmul(x, w, act=act)
    else:
        # fp linear in the input dtype, like the reference's bf16-output dot
        y = torch.matmul(x, w.to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ----------------------------------------------------------------- norms ----
def init_norm(d: int, dtype, device, kind: str = "rmsnorm") -> Params:
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (a ``"bias"`` leaf) or RMSNorm, computed in f32 and cast
    back to the input dtype."""
    xf = x.to(torch.float32)
    if "bias" in p:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ------------------------------------------------------------- embedding ----
def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"table": _randn(gen, (vocab, d), 0.02, dtype)}


def apply_embedding(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens`` (``F.embedding``: the same gather as
    indexing, and the op ``DTensor`` partitions over a vocab-sharded table
    without gathering it)."""
    return F.embedding(tokens.long(), p["table"])


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
               theta: float = 1e4, variant: str = "standard") -> torch.Tensor:
    """Rotary embedding of x[B, T, H, Dh] at positions[B, T] (``mrope``
    also takes ``[3, B, T]``: one stream each for t, h, w).

    ``standard`` rotates the two halves of Dh; ``2d`` (ChatGLM) rotates the
    first half of Dh only, with the half's own frequencies; ``mrope``
    (Qwen2-VL) splits the Dh/2 frequencies into sections (Dh/4, Dh/8,
    Dh/8), each turned by its own stream (text positions: three equal
    streams, which is the standard rotation)."""
    dh = x.shape[-1]
    if variant == "none":
        return x
    if variant == "standard":
        inv = rope_freqs(dh, theta, x.device)
        ang = positions.to(torch.float32)[..., None] * inv  # [B, T, Dh/2]
        return _rotate(x, ang[:, :, None, :])
    if variant == "2d":
        half = dh // 2
        inv = rope_freqs(half, theta, x.device)
        ang = positions.to(torch.float32)[..., None] * inv
        return torch.cat([_rotate(x[..., :half], ang[:, :, None, :]),
                          x[..., half:]], dim=-1)
    if variant == "mrope":
        if positions.ndim == 2:
            positions = positions[None].expand(3, *positions.shape)
        inv = rope_freqs(dh, theta, x.device)               # [Dh/2]
        parts, start = [], 0
        for s, sec in enumerate((dh // 4, dh // 8, dh // 8)):
            parts.append(positions[s].to(torch.float32)[..., None]
                         * inv[start:start + sec])
            start += sec
        if start < inv.shape[0]:
            parts.append(positions[0].to(torch.float32)[..., None]
                         * inv[start:])
        ang = torch.cat(parts, dim=-1)                      # [B, T, Dh/2]
        return _rotate(x, ang[:, :, None, :])
    raise ValueError(f"unknown rope variant {variant!r}")


# ------------------------------------------------------------------ misc ----
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU in f32, cast back (the reference's
    ``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)
