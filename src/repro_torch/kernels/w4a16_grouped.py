"""B6 (grouped W4A16) and B7 (grouped W4A8) expert GEMMs — the CUDA
kernels' wrappers and their plain PyTorch versions.

``x[E, C, D] @ dequant(qt)[E, D, F] → [E, C, F]`` over stacked ``[E, Ci,
Co]`` weights (the MoE experts), one independent product per expert.

B6 replaces the Pallas TPU kernel ``repro/kernels/w4a16_grouped.py:_kernel``,
source ``csrc/w4a16_grouped.cu`` on K1's tensor-core tile
(``csrc/w4a16_tile.cuh``); its plain version is the reference's
``ref.w4a16_grouped_ref``: dequantize the stacked weight to f32, one batched
f32 product, cast to ``x``'s dtype.

B7 replaces ``_kernel_a8``, source ``csrc/w4a8_grouped.cu`` on B5's int8
tensor-core tile (``csrc/w4a8_tile.cuh``); its plain version is the
reference's exact oracle ``ref.w4a8_grouped_ref``: per-(expert, row) int8
activations, zero-folded int8 weight codes, an integer contraction within
each group (in f32, exact below 2^24), then ``sum(part · scale) · xs``.
The B7 wrapper quantizes the activations with PyTorch ops before the
launch, as B5's does.

Both take an optional per-expert live row count ``rows: int32[E]`` (on
``x``'s device): rows ``>= rows[e]`` come out zero, and the kernels read no
weight of an expert with ``rows[e] == 0`` (the MoE's experts no token was
routed to) and run no MMA for a row tile past ``rows[e]``.  The MoE's
capacity rows past the routed count are zero rows anyway, so ``rows``
leaves its function unchanged; without ``rows`` both kernels give exact
zero output rows for zero rows too.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.quantize import (QuantizedTensor, dequantize,
                                      quantize_acts_per_token)
from repro_torch.kernels import _build as B
from repro_torch.kernels.w4a16_matmul import (_DTYPES, _aligned,
                                              _check_common,
                                              _folded_int_codes, _plan)


def w4a16_grouped_plain(x: torch.Tensor, qt: QuantizedTensor,
                        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[E, C, Ci] @ dequant(qt)[E, Ci, Co]`` in f32, returned in
    x.dtype; with ``rows``, output rows ``>= rows[e]`` are zero."""
    w = dequantize(qt, torch.float32)
    return _live_rows(torch.bmm(x.to(torch.float32), w), rows).to(x.dtype)


def w4a8_grouped_plain(x: torch.Tensor, qt: QuantizedTensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7's function: per-(expert, row) int8 ``x`` against the zero-folded
    int8 weight codes, one exact integer sum per (row, group), then
    ``sum(part · scale) · xs``; returned in x.dtype.  With ``rows``, output
    rows ``>= rows[e]`` are zero."""
    e, c, d = x.shape
    xq, xs = quantize_acts_per_token(x)                 # [E,C,D], [E,C,1]
    wq = _folded_int_codes(qt)                          # [E, G#, G, Co]
    g = wq.shape[-3]
    xg = xq.to(torch.float32).reshape(e, c, g, d // g)
    part = torch.einsum("ecgi,egio->ecgo", xg, wq)
    y = (part * qt.scales.to(torch.float32)[:, None]).sum(dim=2) * xs
    return _live_rows(y, rows).to(x.dtype)


def _live_rows(y: torch.Tensor, rows: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """``y[E, C, Co]`` with rows ``>= rows[e]`` zeroed (``rows`` None: y)."""
    if rows is None:
        return y
    live = torch.arange(y.shape[1], device=y.device)[None, :] \
        < rows.to(y.device)[:, None]
    return torch.where(live[..., None], y, 0.0)


_C, _I = ctypes.c_void_p, ctypes.c_int
_A16_ARGS = [_C, _I, _C, _C, _C, _I, _C, _C, _C, _I, _I, _I, _I, _I, _I,
             _I, _C]
_A8_ARGS = [_C, _C, _C, _C, _C, _I, _C, _C, _I, _C, _I, _I, _I, _I, _I, _I,
            _I, _C]


def _check_rows(name: str, x: torch.Tensor,
                rows: Optional[torch.Tensor]) -> None:
    e = x.shape[0]
    if rows is not None and (rows.device != x.device
                             or rows.dtype != torch.int32
                             or tuple(rows.shape) != (e,)
                             or not rows.is_contiguous()):
        raise ValueError(f"{name}: rows must be a contiguous int32[{e}] on "
                         f"{x.device}, got {rows.dtype}{tuple(rows.shape)} on "
                         f"{rows.device}")


def w4a16_grouped_cuda(x: torch.Tensor, qt: QuantizedTensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch B6 on ``x``'s device (current stream): the tile kernel and,
    when split over groups, the kernel that sums the split partials.
    ``rows`` (int32[E] on the device, optional) is read by the kernel, with
    no host sync.  Raises on anything the kernel does not take (it needs
    G % 8 == 0); never falls back to the plain version."""
    name = "w4a16_grouped_cuda"
    _check_common(name, x, qt, True)
    _check_rows(name, x, rows)
    e, c, ci = x.shape
    co = qt.shape[-1]
    y = torch.empty(e, c, co, dtype=x.dtype, device=x.device)
    if c == 0 or e == 0:
        return y
    tile, splits = _plan(name, x, qt, c, e)
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


def w4a8_grouped_cuda(x: torch.Tensor, qt: QuantizedTensor,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize ``x`` per (expert, row) (PyTorch ops on the card), then
    launch B7: the tile kernel and, when split over groups, the kernel that
    sums the split partials and applies the row scales.  ``rows`` as B6's.
    Raises on anything the kernel does not take (it needs G % 8 == 0);
    never falls back."""
    name = "w4a8_grouped_cuda"
    _check_common(name, x, qt, True)
    _check_rows(name, x, rows)
    e, c, ci = x.shape
    co = qt.shape[-1]
    y = torch.empty(e, c, co, dtype=x.dtype, device=x.device)
    if c == 0 or e == 0:
        return y
    tile, splits = _plan(name, x, qt, c, e, a8=True)
    part = (torch.empty(splits, e, c, co, dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    xq, xs = quantize_acts_per_token(x)
    err = B.cfunc("w4a8_grouped", _A8_ARGS)(
        B.vp(xq), B.vp(xs), B.vp(qt.packed), B.vp(qt.scales), B.vp(qt.zeros),
        _DTYPES[qt.scales.dtype], B.vp(rows), B.vp(y), _DTYPES[x.dtype],
        B.vp(part), e, c, ci, co, qt.group_size, tile, splits,
        B.stream_ptr(x.device))
    B.check(err, "w4a8_grouped")
    w4a8_grouped_cuda.launches += 1
    return y


w4a16_grouped_cuda.launches = 0
w4a8_grouped_cuda.launches = 0
