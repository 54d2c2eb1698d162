"""K1 (W4A16) and B5 (W4A8) group-wise GEMMs — the CUDA kernels' wrappers
and their plain PyTorch versions.

K1 replaces the Pallas TPU kernel ``repro/kernels/w4a16_matmul.py:_kernel``
(A16 body), source ``csrc/w4a16_matmul.cu``; its plain version is the
reference's ``ref.w4a16_matmul_ref``: dequantize the whole weight to f32,
one f32 matmul, cast to ``x``'s dtype.

B5 replaces ``_kernel_a8`` (with ``_dequant_block_i8``), source
``csrc/w4a8_matmul.cu``; its plain version is the reference's exact oracle
``ref.w4a8_matmul_ref``: per-token int8 activations, zero-folded int8 weight
codes, an integer contraction within each group (in f32, exact below 2^24),
then ``sum(part · scale) · xs``.  The B5 wrapper quantizes the activations
with PyTorch ops before the launch.  Each source's header says what bounds
the kernel on the card and how it is laid out.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import (QuantizedTensor, dequantize,
                                      quantize_acts_per_token, unpack_codes)
from repro_torch.kernels import _build as B

_DTYPES = {torch.float32: B.DTYPE_F32, torch.bfloat16: B.DTYPE_BF16}
_T_TILE = 8              # token rows per block (csrc kTTile)
_MAX_GRID_Y = 65535


def w4a16_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x[..., Ci] @ dequant(qt)[Ci, Co]`` in f32, returned in x.dtype."""
    w = dequantize(qt, torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def _folded_int_codes(qt: QuantizedTensor) -> torch.Tensor:
    """Zero-folded integer weight codes ``[*lead, G#, G, Co]`` (f32, integer
    valued): ``clip(code − round(zero), −128, 127)``, as B5/B7 fold them."""
    q = unpack_codes(qt.packed, qt.group_size).to(torch.float32)
    *lead, ci, co = q.shape
    g = qt.scales.shape[-2]
    z = torch.round(qt.zeros.to(torch.float32))
    return torch.clamp(q.reshape(*lead, g, ci // g, co) - z[..., None, :],
                       -128, 127)


def w4a8_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """B5's function: per-token int8 ``x[..., Ci]`` against the zero-folded
    int8 weight codes, one exact integer sum per (token, group), then
    ``sum(part · scale) · xs``; returned in x.dtype."""
    ci = x.shape[-1]
    xq, xs = quantize_acts_per_token(x.reshape(-1, ci))
    wq = _folded_int_codes(qt)                          # [G#, G, Co]
    g = wq.shape[0]
    xg = xq.to(torch.float32).reshape(-1, g, ci // g)
    part = torch.einsum("tgi,gio->tgo", xg, wq)
    y = (part * qt.scales.to(torch.float32)[None]).sum(dim=1) * xs
    return y.to(x.dtype).reshape(*x.shape[:-1], qt.shape[-1])


_C, _I = ctypes.c_void_p, ctypes.c_int
_W4A16_ARGS = [_C, _I, _C, _C, _C, _I, _C, _I, _I, _I, _I, _C]
_W4A8_ARGS = [_C, _C, _C, _C, _C, _I, _C, _I, _I, _I, _I, _I, _C]


def _check_operands(name: str, x: torch.Tensor, qt: QuantizedTensor,
                    group_multiple: int, stacked: bool = False) -> int:
    """Raise on anything K1/B5 (a 2-D weight, ``x[..., Ci]``) or B6/B7 (a
    stacked ``[E, Ci, Co]`` weight, ``x[E, C, Ci]``) do not take; returns
    the row count of ``x``."""
    if not x.is_cuda or qt.packed.device != x.device \
            or qt.scales.device != x.device or qt.zeros.device != x.device:
        raise ValueError(f"{name}: x and the weight must be CUDA tensors on "
                         "one device")
    if stacked:
        if qt.ndim != 3 or x.ndim != 3 or x.shape[0] != qt.shape[0]:
            raise ValueError(f"{name} takes x[E, C, Ci] and a stacked "
                             f"[E, Ci, Co] weight, got {tuple(x.shape)} and "
                             f"{qt.shape}")
    elif qt.ndim != 2:
        raise ValueError(f"{name} takes a 2-D weight, got {qt.shape}")
    if x.dtype not in _DTYPES or qt.scales.dtype not in _DTYPES \
            or qt.zeros.dtype != qt.scales.dtype \
            or qt.packed.dtype != torch.uint8:
        raise ValueError(
            f"{name}: unsupported dtypes x={x.dtype} "
            f"packed={qt.packed.dtype} scales={qt.scales.dtype} "
            f"zeros={qt.zeros.dtype}")
    ci, co = qt.shape[-2:]
    g = qt.group_size
    if x.shape[-1] != ci:
        raise ValueError(f"x Ci={x.shape[-1]} != weight Ci={ci}")
    if ci % g or g % group_multiple:
        raise ValueError(f"{name}: Ci={ci} must be a multiple of the group "
                         f"{g}, itself a multiple of {group_multiple}")
    if co % 4:
        raise ValueError(f"Co={co} must be a multiple of 4 (uint32 reads)")
    for nm, t in (("x", x), ("packed", qt.packed), ("scales", qt.scales),
                  ("zeros", qt.zeros)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")
    if qt.packed.data_ptr() % 4:
        raise ValueError(f"{name}: packed is not 4-byte aligned")
    t = x.numel() // ci
    # the grid's y axis: one block row per 8 rows (per expert when stacked)
    tiles = (qt.shape[0] * -(-x.shape[1] // _T_TILE) if stacked
             else -(-t // _T_TILE))
    if tiles > _MAX_GRID_Y:
        raise ValueError(f"{name}: {tuple(x.shape)} exceeds the grid")
    return t


def w4a16_matmul_cuda(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Launch K1 on ``x``'s device (current stream).  Raises on anything the
    kernel does not take; never falls back to the plain version."""
    t = _check_operands("w4a16_matmul_cuda", x, qt, 2)
    ci, co = qt.shape
    y = torch.empty(*x.shape[:-1], co, dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    err = B.cfunc("w4a16_matmul", _W4A16_ARGS)(
        B.vp(x), _DTYPES[x.dtype], B.vp(qt.packed), B.vp(qt.scales),
        B.vp(qt.zeros), _DTYPES[qt.scales.dtype], B.vp(y), t, ci, co,
        qt.group_size, B.stream_ptr(x.device))
    B.check(err, "w4a16_matmul")
    w4a16_matmul_cuda.launches += 1
    return y


def w4a8_matmul_cuda(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Quantize ``x`` per token (PyTorch ops on the card), then launch B5.
    Raises on anything the kernel does not take (it needs G % 8 == 0);
    never falls back."""
    t = _check_operands("w4a8_matmul_cuda", x, qt, 8)
    ci, co = qt.shape
    y = torch.empty(*x.shape[:-1], co, dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    xq, xs = quantize_acts_per_token(x.reshape(t, ci))
    err = B.cfunc("w4a8_matmul", _W4A8_ARGS)(
        B.vp(xq), B.vp(xs), B.vp(qt.packed), B.vp(qt.scales), B.vp(qt.zeros),
        _DTYPES[qt.scales.dtype], B.vp(y), _DTYPES[x.dtype], t, ci, co,
        qt.group_size, B.stream_ptr(x.device))
    B.check(err, "w4a8_matmul")
    w4a8_matmul_cuda.launches += 1
    return y


w4a16_matmul_cuda.launches = 0
w4a8_matmul_cuda.launches = 0
