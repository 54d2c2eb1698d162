"""Public kernel entry points, dispatched by the tensors' device (port of
``repro/kernels/ops.py``).

There is no backend string: a CPU tensor takes the kernel's plain PyTorch
version, a CUDA tensor launches the hand-written kernel or raises.  Nothing
falls back from the kernel to the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import w4a16_grouped as _w4g
from repro_torch.kernels import w4a16_matmul as _w4

# W4A8 token-count gate, kept from the reference: below this many rows the
# GEMM is memory-bound (decode batches, tail chunks) and stays A16 even when
# A8 is requested.
A8_MIN_TOKENS = 16


def _resolve_act(act: str, qt: QuantizedTensor, rows: int) -> str:
    """The caller asks (``act="a8"``), the calibration verdict rides on the
    weight (``qt.a8``), and the row count keeps decode on the A16 body."""
    if act not in ("a16", "a8"):
        raise ValueError(f"act must be 'a16' or 'a8', got {act!r}")
    if act == "a8" and qt.a8 and rows >= A8_MIN_TOKENS:
        return "a8"
    return "a16"


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def w4a16_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                 act: str = "a16") -> torch.Tensor:
    """Quantized linear contraction ``x @ dequant(qt)``: K1, or B5 (per-token
    int8 activations) where :func:`_resolve_act` grants A8."""
    a8 = _resolve_act(act, qt, math.prod(x.shape[:-1])) == "a8"
    if _route(x) == "cpu":
        return (_w4.w4a8_matmul_plain if a8 else _w4.w4a16_matmul_plain)(x, qt)
    return (_w4.w4a8_matmul_cuda if a8 else _w4.w4a16_matmul_cuda)(x, qt)


def w4a16_grouped_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                         act: str = "a16",
                         rows: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Expert-batched contraction ``x[E, C, D] @ dequant(qt)[E, D, F]``: B6,
    or B7 where :func:`_resolve_act` grants A8 with the per-expert row count
    ``C`` as the token count (decode's capacity stays A16).  ``rows``
    (int32[E], optional) is the count of live leading rows of each expert;
    the rows past it must be zero rows of ``x``.  Both kernels then skip
    the idle experts' weights and the row tiles past ``rows``."""
    if qt.ndim != 3:
        raise ValueError(f"grouped matmul needs stacked [E, Ci, Co] weights; "
                         f"got {qt.shape}")
    if x.ndim != 3:
        raise ValueError(f"expected x[E, C, D], got shape {tuple(x.shape)}")
    if _resolve_act(act, qt, x.shape[1]) == "a8":
        if _route(x) == "cpu":
            return _w4g.w4a8_grouped_plain(x, qt, rows)
        return _w4g.w4a8_grouped_cuda(x, qt, rows)
    if _route(x) == "cpu":
        return _w4g.w4a16_grouped_plain(x, qt, rows)
    return _w4g.w4a16_grouped_cuda(x, qt, rows)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (B4): q[B,T,H,D], k/v[B,S,Hkv,D] → [B,T,H,D]
    in q's dtype."""
    if _route(q) == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal)
    return _fa.flash_attention_cuda(q, k, v, causal=causal)


def gqa_paged_attention(q, k_pool, v_pool, table, lengths, k_scale=None,
                        v_scale=None, *, sm_scale: float) -> torch.Tensor:
    """Paged GQA decode attention (K2): q[B,Hkv,grp,Dh] → f32 [B,Hkv,grp,Dv].
    With ``k_scale``/``v_scale`` the pools are int8 (K2's int8 branch)."""
    if _route(q) == "cpu":
        return _pa.gqa_paged_attention_plain(q, k_pool, v_pool, table,
                                             lengths, k_scale, v_scale,
                                             sm_scale=sm_scale)
    if k_scale is None:
        return _pa.gqa_paged_attention_cuda(q, k_pool, v_pool, table, lengths,
                                            sm_scale=sm_scale)
    return _pa.gqa_paged_attention_int8_cuda(q, k_pool, v_pool, table,
                                             lengths, k_scale, v_scale,
                                             sm_scale=sm_scale)


def gqa_paged_prefill(q, k_suf, v_suf, k_pool, v_pool, table, prefix_len,
                      chunk_len, k_scale=None, v_scale=None, *,
                      sm_scale: float) -> torch.Tensor:
    """Paged GQA chunked-prefill attention (K3): q[B,T,Hkv,grp,Dh] → f32
    [B,T,Hkv,grp,Dv].  With ``k_scale``/``v_scale`` the pools are int8 (K3's
    int8 branch); the chunk's own K/V stay raw fp."""
    args = (q, k_suf, v_suf, k_pool, v_pool, table, prefix_len, chunk_len)
    if _route(q) == "cpu":
        return _pa.gqa_paged_prefill_plain(*args, k_scale, v_scale,
                                           sm_scale=sm_scale)
    if k_scale is None:
        return _pa.gqa_paged_prefill_cuda(*args, sm_scale=sm_scale)
    return _pa.gqa_paged_prefill_int8_cuda(*args, k_scale, v_scale,
                                           sm_scale=sm_scale)


def mla_paged_attention(q_lat, q_pe, ckv_pool, kpe_pool, table, lengths,
                        ckv_scale=None, kpe_scale=None, *,
                        sm_scale: float) -> torch.Tensor:
    """Absorbed MLA paged decode (B8): q_lat[B,H,r], q_pe[B,H,dr] → f32
    o_lat[B,H,r].  With ``ckv_scale``/``kpe_scale`` the latent pools are
    int8 (B8's int8 branch)."""
    args = (q_lat, q_pe, ckv_pool, kpe_pool, table, lengths)
    if _route(q_lat) == "cpu":
        return _pa.mla_paged_attention_plain(*args, ckv_scale, kpe_scale,
                                             sm_scale=sm_scale)
    if ckv_scale is None:
        return _pa.mla_paged_attention_cuda(*args, sm_scale=sm_scale)
    return _pa.mla_paged_attention_int8_cuda(*args, ckv_scale, kpe_scale,
                                             sm_scale=sm_scale)


def mla_paged_prefill(q_lat, q_pe, ckv_suf, kpe_suf, ckv_pool, kpe_pool,
                      table, prefix_len, chunk_len, ckv_scale=None,
                      kpe_scale=None, *, sm_scale: float) -> torch.Tensor:
    """Absorbed MLA chunked prefill (B9): q_lat[B,T,H,r], q_pe[B,T,H,dr]
    against the cached latent pages and the chunk's raw latents ckv_suf[B,T,r]
    / kpe_suf[B,T,dr] → f32 o_lat[B,T,H,r].  With ``ckv_scale``/
    ``kpe_scale`` the pools are int8 (B9's int8 branch)."""
    args = (q_lat, q_pe, ckv_suf, kpe_suf, ckv_pool, kpe_pool, table,
            prefix_len, chunk_len)
    if _route(q_lat) == "cpu":
        return _pa.mla_paged_prefill_plain(*args, ckv_scale, kpe_scale,
                                           sm_scale=sm_scale)
    if ckv_scale is None:
        return _pa.mla_paged_prefill_cuda(*args, sm_scale=sm_scale)
    return _pa.mla_paged_prefill_int8_cuda(*args, ckv_scale, kpe_scale,
                                           sm_scale=sm_scale)
