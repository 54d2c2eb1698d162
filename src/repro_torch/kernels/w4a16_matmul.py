"""K1: W4A16 group-wise dequant-inside-GEMM — the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/w4a16_matmul.py:_kernel``
(A16 body).  The kernel source is ``csrc/w4a16_matmul.cu``; its header says
what bounds it on the card and how it is laid out.  The plain version is the
reference's ``ref.w4a16_matmul_ref``: dequantize the whole weight to f32,
one f32 matmul, cast to ``x``'s dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import QuantizedTensor, dequantize
from repro_torch.kernels import _build as B

_DTYPES = {torch.float32: B.DTYPE_F32, torch.bfloat16: B.DTYPE_BF16}
_T_TILE = 8              # token rows per block (csrc kTTile)
_MAX_GRID_Y = 65535


def w4a16_matmul_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x[..., Ci] @ dequant(qt)[Ci, Co]`` in f32, returned in x.dtype."""
    w = dequantize(qt, torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def _fn():
    fn = B.load("w4a16_matmul").repro_w4a16_matmul
    if fn.argtypes is None:
        c, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [c, i, c, c, c, i, c, i, i, i, i, c]
        fn.restype = i
    return fn


def w4a16_matmul_cuda(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Launch K1 on ``x``'s device (current stream).  Raises on anything the
    kernel does not take; never falls back to the plain version."""
    if not x.is_cuda or qt.packed.device != x.device \
            or qt.scales.device != x.device or qt.zeros.device != x.device:
        raise ValueError("w4a16_matmul_cuda: x and the weight must be CUDA "
                         "tensors on one device")
    if qt.ndim != 2:
        raise ValueError(f"w4a16_matmul_cuda takes a 2-D weight, got "
                         f"{qt.shape}")
    if x.dtype not in _DTYPES or qt.scales.dtype not in _DTYPES \
            or qt.zeros.dtype != qt.scales.dtype \
            or qt.packed.dtype != torch.uint8:
        raise ValueError(
            f"w4a16_matmul_cuda: unsupported dtypes x={x.dtype} "
            f"packed={qt.packed.dtype} scales={qt.scales.dtype} "
            f"zeros={qt.zeros.dtype}")
    ci, co = qt.shape
    g = qt.group_size
    if x.shape[-1] != ci:
        raise ValueError(f"x Ci={x.shape[-1]} != weight Ci={ci}")
    if ci % g or g % 2:
        raise ValueError(f"Ci={ci} must be a multiple of an even group {g}")
    if co % 4:
        raise ValueError(f"Co={co} must be a multiple of 4 (uint32 reads)")
    for name, t in (("x", x), ("packed", qt.packed), ("scales", qt.scales),
                    ("zeros", qt.zeros)):
        if not t.is_contiguous():
            raise ValueError(f"w4a16_matmul_cuda: {name} is not contiguous")
    if qt.packed.data_ptr() % 4:
        raise ValueError("w4a16_matmul_cuda: packed is not 4-byte aligned")
    t = x.numel() // ci
    if t > _T_TILE * _MAX_GRID_Y:
        raise ValueError(f"w4a16_matmul_cuda: T={t} exceeds the grid")
    y = torch.empty(*x.shape[:-1], co, dtype=x.dtype, device=x.device)
    if t == 0:
        return y
    err = _fn()(B.vp(x), _DTYPES[x.dtype], B.vp(qt.packed), B.vp(qt.scales),
                B.vp(qt.zeros), _DTYPES[qt.scales.dtype], B.vp(y), t, ci, co,
                g, B.stream_ptr(x.device))
    B.check(err, "w4a16_matmul")
    w4a16_matmul_cuda.launches += 1
    return y


w4a16_matmul_cuda.launches = 0
