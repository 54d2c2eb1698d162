"""Group-wise asymmetric 4-bit round-to-nearest, as SmoothQuant+ §2.1
(eq. 1) states it, in plain PyTorch.

A weight ``W[..., Ci, Co]`` is cut into groups of ``G`` consecutive input
rows; each (group, output column) gets ``scale = (max - min) / 15`` (1 where
that is 0) and an integer ``zero = round(-min / scale)``; the code is
``clamp(round(W / scale) + zero, 0, 15)`` and the served weight ``(code -
zero) * scale``.  Rounding is half to even (``torch.round``).
"""
from __future__ import annotations

import torch

QMAX = 15


def fake_quant(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """The f32 weight that the 4-bit codes of ``w`` stand for."""
    *lead, ci, co = w.shape
    if ci % group_size:
        raise ValueError(f"Ci={ci} is not a multiple of G={group_size}")
    wg = w.to(torch.float32).reshape(*lead, ci // group_size, group_size, co)
    hi, lo = wg.amax(dim=-2, keepdim=True), wg.amin(dim=-2, keepdim=True)
    scale = (hi - lo) / QMAX
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zero = torch.round(-lo / scale)
    code = torch.clamp(torch.round(wg / scale) + zero, 0, QMAX)
    return ((code - zero) * scale).reshape(w.shape)
