"""B4: flash attention over a full sequence — the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:_kernel``
(source ``csrc/flash_attention.cu`` on the tensor-core tile of
``csrc/attn_tile.cuh``, whose headers say what bounds it on the card).
``cfg.attn_impl="flash"`` routes full-sequence attention here (the
calibration passes of quantize-on-load and the teacher-forced forward).
Any head width runs: the tile pads D to a multiple of 16, and widths whose
tile does not fit in shared memory take a CUDA-core kernel, chosen by shape
(:func:`flash_route`).

Contract, the reference's: ``q[B, T, H, D]``, ``k/v[B, S, Hkv, D]``, query
head ``h`` reads KV head ``h // (H / Hkv)``, scale ``D**-0.5``; when
``causal``, key ``j`` is valid for query ``t`` iff ``j <= t`` (index
positions).  The output has q's dtype, from f32 softmax state, and is
``acc / max(l, 1e-30)``.  As in the reference, non-causal attention needs S
to be a multiple of the KV block ``min(512, S)``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build as B

NEG_INF = -1e30
DEFAULT_BLOCK_KV = 512   # the reference's KV block (non-causal contract)
_DTYPES = {torch.float32: B.DTYPE_F32, torch.bfloat16: B.DTYPE_BF16}
_ROWS = 64            # query rows of the flattened T*grp axis per tile block
_GRID_YZ = 65535      # the grid's y (batch) and z (row tiles) limit


def _check_contract(q, k, v, causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash attention takes q[B,T,H,D] and k/v[B,S,Hkv,"
                         f"D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    t, h = q.shape[1], q.shape[2]
    s, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"H={h} not a multiple of Hkv={hkv}")
    if causal and s < t:
        raise ValueError(f"causal flash attention needs S >= T, got S={s} "
                         f"T={t}")
    if not causal and s % min(DEFAULT_BLOCK_KV, s):
        raise ValueError("non-causal flash requires S divisible by block_kv")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """One masked softmax over all keys in f32 (masked scores -1e30 weigh
    exactly 0), ``acc / max(l, 1e-30)``, in q's dtype."""
    _check_contract(q, k, v, causal)
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(b, t, hkv, h // hkv, d)
    sc = torch.einsum("bthgd,bshd->bhgts", qf, k.to(torch.float32)) \
        * d ** -0.5
    if causal:
        valid = torch.arange(s, device=q.device)[None, :] \
            <= torch.arange(t, device=q.device)[:, None]
        sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    else:
        valid = torch.ones(t, s, dtype=torch.bool, device=q.device)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32)) \
        / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, h, d).to(q.dtype)


_C, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _C]


@functools.lru_cache(maxsize=None)
def _route(code: int, d: int) -> int:
    fn = B.load("flash_attention").repro_flash_attention_route
    fn.argtypes = [_I, _I]
    fn.restype = _I
    return fn(code, d)


def flash_route(dtype: torch.dtype, d: int) -> str:
    """``"tile"`` where B4 runs the tensor-core tile for q/k/v of ``dtype``
    and head width ``d``, ``"general"`` where one tile stage does not fit
    in shared memory and the CUDA-core kernel runs.  The rule is
    ``csrc/flash_attention.cu``'s, asked of the built library; raises for a
    width neither kernel takes (a row wider than the CUDA-core kernel's
    shared memory, D > 29056)."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash attention: no kernel for {dtype}")
    code = _route(_DTYPES[dtype], int(d))
    if code < 0:
        raise ValueError(f"flash attention: head dim {d} too wide for the "
                         "kernels' shared memory")
    return "tile" if code else "general"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch B4 on ``q``'s device (current stream).  Raises on anything the
    kernel does not take; never falls back to the plain version."""
    name = "flash_attention_cuda"
    _check_contract(q, k, v, causal)
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be CUDA tensors on one "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one of f32/bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    grp = h // hkv
    if max(b, hkv, -(-t * grp // _ROWS)) > _GRID_YZ:
        raise ValueError(f"{name}: B={b} / Hkv={hkv} / T*grp={t * grp} "
                         "exceed the grid")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    flash_route(q.dtype, d)          # raises for a width no kernel takes
    err = B.cfunc("flash_attention", _ARGS)(
        B.vp(q), B.vp(k), B.vp(v), B.vp(out), _DTYPES[q.dtype], b, t, s, hkv,
        grp, d, float(d ** -0.5), int(causal), B.stream_ptr(q.device))
    B.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
