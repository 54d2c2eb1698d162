"""B6 (grouped W4A16) and B7 (grouped W4A8) expert GEMMs — the CUDA
kernels' wrappers and their plain PyTorch versions.

``x[E, C, D] @ dequant(qt)[E, D, F] → [E, C, F]`` over stacked ``[E, Ci,
Co]`` weights (the MoE experts), one independent product per expert.

B6 replaces the Pallas TPU kernel ``repro/kernels/w4a16_grouped.py:_kernel``,
source ``csrc/w4a16_grouped.cu`` on K1's tensor-core tile
(``csrc/w4a16_tile.cuh``); its plain version is the reference's
``ref.w4a16_grouped_ref``: dequantize the stacked weight to f32, one batched
f32 product, cast to ``x``'s dtype.  Both take an optional per-expert live
row count ``rows: int32[E]`` (on ``x``'s device): rows ``>= rows[e]`` come
out zero, and the kernel reads no weight of an expert with ``rows[e] == 0``
(the MoE's experts no token was routed to).  The MoE's capacity rows past
the routed count are zero rows anyway, so ``rows`` leaves its function
unchanged.

B7 replaces ``_kernel_a8``, source ``csrc/w4a8_grouped.cu``; its plain
version is the reference's exact oracle ``ref.w4a8_grouped_ref``:
per-(expert, row) int8 activations, zero-folded int8 weight codes, an
integer contraction within each group (in f32, exact below 2^24), then
``sum(part · scale) · xs``.  The B7 wrapper quantizes the activations with
PyTorch ops before the launch, as B5's does.

Capacity rows that no token was dispatched to are zero rows; both kernels
give exact zero output rows for them (B7 takes no ``rows``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.quantize import (QuantizedTensor, dequantize,
                                      quantize_acts_per_token)
from repro_torch.kernels import _build as B
from repro_torch.kernels.w4a16_matmul import (_DTYPES, _a16_plan, _aligned,
                                              _check_common, _check_operands,
                                              _folded_int_codes)


def w4a16_grouped_plain(x: torch.Tensor, qt: QuantizedTensor,
                        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[E, C, Ci] @ dequant(qt)[E, Ci, Co]`` in f32, returned in
    x.dtype; with ``rows``, output rows ``>= rows[e]`` are zero."""
    w = dequantize(qt, torch.float32)
    y = torch.bmm(x.to(torch.float32), w)
    if rows is not None:
        live = torch.arange(x.shape[1], device=x.device)[None, :] \
            < rows.to(x.device)[:, None]
        y = torch.where(live[..., None], y, 0.0)
    return y.to(x.dtype)


def w4a8_grouped_plain(x: torch.Tensor, qt: QuantizedTensor
                       ) -> torch.Tensor:
    """B7's function: per-(expert, row) int8 ``x`` against the zero-folded
    int8 weight codes, one exact integer sum per (row, group), then
    ``sum(part · scale) · xs``; returned in x.dtype."""
    e, c, d = x.shape
    xq, xs = quantize_acts_per_token(x)                 # [E,C,D], [E,C,1]
    wq = _folded_int_codes(qt)                          # [E, G#, G, Co]
    g = wq.shape[-3]
    xg = xq.to(torch.float32).reshape(e, c, g, d // g)
    part = torch.einsum("ecgi,egio->ecgo", xg, wq)
    y = (part * qt.scales.to(torch.float32)[:, None]).sum(dim=2) * xs
    return y.to(x.dtype)


_C, _I = ctypes.c_void_p, ctypes.c_int
_A16_ARGS = [_C, _I, _C, _C, _C, _I, _C, _C, _C, _I, _I, _I, _I, _I, _I,
             _I, _C]
_A8_ARGS = [_C, _C, _C, _C, _C, _I, _C, _I, _I, _I, _I, _I, _I, _C]


def w4a16_grouped_cuda(x: torch.Tensor, qt: QuantizedTensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch B6 on ``x``'s device (current stream): the tile kernel and,
    when split over groups, the kernel that sums the split partials.
    ``rows`` (int32[E] on the device, optional) is read by the kernel, with
    no host sync.  Raises on anything the kernel does not take (it needs
    G % 16 == 0); never falls back to the plain version."""
    name = "w4a16_grouped_cuda"
    _check_common(name, x, qt, 16, True)
    e, c, ci = x.shape
    co = qt.shape[-1]
    if rows is not None and (rows.device != x.device
                             or rows.dtype != torch.int32
                             or tuple(rows.shape) != (e,)
                             or not rows.is_contiguous()):
        raise ValueError(f"{name}: rows must be a contiguous int32[{e}] on "
                         f"{x.device}, got {rows.dtype}{tuple(rows.shape)} on "
                         f"{rows.device}")
    y = torch.empty(e, c, co, dtype=x.dtype, device=x.device)
    if c == 0 or e == 0:
        return y
    tile, splits = _a16_plan(name, x, qt, c, e)
    part = (torch.empty(splits, e, c, co, dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    xa = _aligned(x)
    err = B.cfunc("w4a16_grouped", _A16_ARGS)(
        B.vp(xa), _DTYPES[x.dtype], B.vp(qt.packed), B.vp(qt.scales),
        B.vp(qt.zeros), _DTYPES[qt.scales.dtype], B.vp(rows), B.vp(y),
        B.vp(part), e, c, ci, co, qt.group_size, tile, splits,
        B.stream_ptr(x.device))
    B.check(err, "w4a16_grouped")
    w4a16_grouped_cuda.launches += 1
    return y


def w4a8_grouped_cuda(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Quantize ``x`` per (expert, row) (PyTorch ops on the card), then launch
    B7.  Raises on anything the kernel does not take (it needs G % 8 == 0);
    never falls back."""
    _check_operands("w4a8_grouped_cuda", x, qt, 8, stacked=True)
    e, c, ci = x.shape
    co = qt.shape[-1]
    y = torch.empty(e, c, co, dtype=x.dtype, device=x.device)
    if c == 0:
        return y
    xq, xs = quantize_acts_per_token(x)
    err = B.cfunc("w4a8_grouped", _A8_ARGS)(
        B.vp(xq), B.vp(xs), B.vp(qt.packed), B.vp(qt.scales), B.vp(qt.zeros),
        _DTYPES[qt.scales.dtype], B.vp(y), _DTYPES[x.dtype], e, c, ci, co,
        qt.group_size, B.stream_ptr(x.device))
    B.check(err, "w4a8_grouped")
    w4a8_grouped_cuda.launches += 1
    return y


w4a16_grouped_cuda.launches = 0
w4a8_grouped_cuda.launches = 0
