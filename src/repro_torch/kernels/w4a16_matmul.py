"""K1 (W4A16) and B5 (W4A8) group-wise GEMMs — the CUDA kernels' wrappers
and their plain PyTorch versions.

K1 replaces the Pallas TPU kernel ``repro/kernels/w4a16_matmul.py:_kernel``
(A16 body), source ``csrc/w4a16_matmul.cu`` on the tensor-core tile of
``csrc/w4a16_tile.cuh`` (shared with B6); its plain version is the
reference's ``ref.w4a16_matmul_ref``: dequantize the whole weight to f32,
one f32 matmul, cast to ``x``'s dtype.

B5 replaces ``_kernel_a8`` (with ``_dequant_block_i8``), source
``csrc/w4a8_matmul.cu`` on the int8 tensor-core tile of
``csrc/w4a8_tile.cuh`` (shared with B7); its plain version is the
reference's exact oracle ``ref.w4a8_matmul_ref``: per-token int8
activations, zero-folded int8 weight codes, an integer contraction within
each group (in f32, exact below 2^24), then ``sum(part · scale) · xs``.
The B5 wrapper quantizes the activations with PyTorch ops before the
launch.

Both tiles stream the weights through one shared-memory ring
(``csrc/w4_ring.cuh``) in chunks of at most 128 weight rows, so every group
size G with G % 8 == 0 and Ci % G == 0 is taken.  The wrappers pick the
tile and the split-K count (:func:`_plan`) and allocate the split partials.
Each source's header says what bounds the kernel on the card and how it is
laid out.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import (QuantizedTensor, dequantize,
                                      quantize_acts_per_token, unpack_codes)
from repro_torch.kernels import _build as B

_DTYPES = {torch.float32: B.DTYPE_F32, torch.bfloat16: B.DTYPE_BF16}
_MAX_GRID_Y = 65535
# The tiles (csrc/w4a16_tile.cuh, w4a8_tile.cuh): K1/B6 up to
# _A16_DECODE_ROWS rows per expert take 8 rows and 128 output columns (tile
# 0); above it, and B5/B7 always, 64 rows and 256 columns (tile 2) where Co
# is a multiple of 256, else 128 (tile 1).  Split-K when the blocks would
# fill fewer than 2 per SM for K1/B6, fewer than half a block per SM for
# B5/B7 (measured on an H100: the partials cost B5 more than they save at a
# T=512 chunk of 128 blocks, and save 2-4x at a T=64 one), to up to 4 blocks
# per SM; and for K1/B6 at decode so that a block walks at most
# _A16_DECODE_GROUPS groups (a MoE's idle experts leave most of its blocks
# empty); at most 16 splits
_A16_DECODE_ROWS = 16
_A16_DECODE_GROUPS = 16
_MAX_SPLITS = 16
#: every quantization group the W4 kernels take is a multiple of this (the
#: shared ring pads a chunk of a group to whole k-steps)
GROUP_MULTIPLE = 8


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
_W4A16_ARGS = [_C, _I, _C, _C, _C, _I, _C, _C, _I, _I, _I, _I, _I, _I, _C]
_W4A8_ARGS = [_C, _C, _C, _C, _C, _I, _C, _I, _C, _I, _I, _I, _I, _I, _I,
              _C]


def _check_common(name: str, x: torch.Tensor, qt: QuantizedTensor,
                  stacked: bool) -> int:
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
    if ci % g or g % GROUP_MULTIPLE:
        raise ValueError(f"{name}: Ci={ci} must be a multiple of the group "
                         f"{g}, itself a multiple of {GROUP_MULTIPLE}")
    if co % 4:
        raise ValueError(f"Co={co} must be a multiple of 4 (uint32 reads)")
    for nm, t in (("x", x), ("packed", qt.packed), ("scales", qt.scales),
                  ("zeros", qt.zeros)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")
    if qt.packed.data_ptr() % 4:
        raise ValueError(f"{name}: packed is not 4-byte aligned")
    return x.numel() // ci


def _plan(name: str, x: torch.Tensor, qt: QuantizedTensor, rows: int,
          experts: int, a8: bool = False) -> tuple:
    """The tile for ``rows`` rows per expert, K1/B6 or (``a8``) B5/B7:
    (tile, split count).  Raises on what the tiles do not take (scales not
    4-byte aligned, the grid)."""
    ci, co = qt.shape[-2:]
    if qt.scales.data_ptr() % 4 or qt.zeros.data_ptr() % 4:
        raise ValueError(f"{name}: scales/zeros are not 4-byte aligned")
    decode = not a8 and rows <= _A16_DECODE_ROWS
    tile = 0 if decode else (2 if co % 256 == 0 else 1)
    bn, bm = (8, 128) if decode else (64, 256 if tile == 2 else 128)
    row_tiles = -(-rows // bn)
    blocks = -(-co // bm) * row_tiles * experts
    sms = B.sm_count(x.device)
    n_groups = ci // qt.group_size
    splits = -(-n_groups // _A16_DECODE_GROUPS) if decode else 1
    if blocks < (sms // 2 if a8 else 2 * sms):
        splits = max(splits, -(-4 * sms // blocks))
    splits = max(1, min(splits, n_groups, _MAX_SPLITS))
    if row_tiles * splits > _MAX_GRID_Y or experts > _MAX_GRID_Y:
        raise ValueError(f"{name}: {tuple(x.shape)} exceeds the grid")
    return tile, splits


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or an aligned copy when its storage offset leaves it off the
    16-byte boundary the tile's cp.async copies need."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def w4a16_matmul_cuda(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Launch K1 on ``x``'s device (current stream): the tile kernel and,
    when split over groups, the kernel that sums the split partials.
    Raises on anything the kernel does not take (it needs G % 8 == 0);
    never falls back to the plain version."""
    t = _check_common("w4a16_matmul_cuda", x, qt, False)
    ci, co = qt.shape
    y = torch.empty(*x.shape[:-1], co, dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    tile, splits = _plan("w4a16_matmul_cuda", x, qt, t, 1)
    part = (torch.empty(splits, t, co, dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    xa = _aligned(x)
    err = B.cfunc("w4a16_matmul", _W4A16_ARGS)(
        B.vp(xa), _DTYPES[x.dtype], B.vp(qt.packed),
        B.vp(qt.scales), B.vp(qt.zeros), _DTYPES[qt.scales.dtype], B.vp(y),
        B.vp(part), t, ci, co, qt.group_size, tile, splits,
        B.stream_ptr(x.device))
    B.check(err, "w4a16_matmul")
    w4a16_matmul_cuda.launches += 1
    return y


def w4a8_matmul_cuda(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Quantize ``x`` per token (PyTorch ops on the card), then launch B5:
    the tile kernel and, when split over groups, the kernel that sums the
    split partials and applies the token scales.  Raises on anything the
    kernel does not take (it needs G % 8 == 0); never falls back."""
    name = "w4a8_matmul_cuda"
    t = _check_common(name, x, qt, False)
    ci, co = qt.shape
    y = torch.empty(*x.shape[:-1], co, dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    tile, splits = _plan(name, x, qt, t, 1, a8=True)
    part = (torch.empty(splits, t, co, dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    xq, xs = quantize_acts_per_token(x.reshape(t, ci))
    err = B.cfunc("w4a8_matmul", _W4A8_ARGS)(
        B.vp(xq), B.vp(xs), B.vp(qt.packed), B.vp(qt.scales), B.vp(qt.zeros),
        _DTYPES[qt.scales.dtype], B.vp(y), _DTYPES[x.dtype], B.vp(part), t,
        ci, co, qt.group_size, tile, splits, B.stream_ptr(x.device))
    B.check(err, "w4a8_matmul")
    w4a8_matmul_cuda.launches += 1
    return y


w4a16_matmul_cuda.launches = 0
w4a8_matmul_cuda.launches = 0
