"""K2/K3: paged GQA decode and chunked-prefill attention — the CUDA kernels'
wrappers and their plain PyTorch versions.

Replace the Pallas TPU kernels ``repro/kernels/paged_attention.py``
``_gqa_kernel`` (decode) and ``_gqa_prefill_kernel`` (chunked prefill), both
branches: fp pools and int8 pools with per-(position, head) f32 scales
``[NP, PS, Hkv]`` (``kv_quant``).  Sources: ``csrc/gqa_paged_decode.cu`` and
``csrc/gqa_paged_prefill.cu``; their headers say what bounds each on the
card.  The int8 launches have wrappers (and launch counters) of their own,
so a run shows which branch ran.

Contract (shared with ``serving/kv_cache.py``): ``table[B, P]`` maps each
slot's logical pages to pool pages, dead entries pointing at the trash page
0; decode ``lengths[B]`` count valid rows *including* the token written this
step.  With int8 pools a score is ``q·k_codes · sm_scale · k_scale[row]``,
the softmax sum takes the unscaled exp, and only the value weights are
scaled by ``v_scale[row]``.  Outputs are f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B

NEG_INF = -1e30
_FP_POOLS = {torch.float32: B.DTYPE_F32, torch.bfloat16: B.DTYPE_BF16}


# ------------------------------------------------------------ plain versions
def _gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    g = pool[table.long()]                      # [B, P, PS, ...]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def _softmax_av(s, valid, v, eq: str, v_rows=None) -> torch.Tensor:
    """The kernels' masked softmax in one pass: masked scores take -1e30 and
    contribute exactly 0; a row with no valid key gives 0, not NaN.  With
    ``v_rows`` (int8 pools) the value weights are scaled per key, the sum
    is not."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if v_rows is not None:
        p = torch.where(valid, p * v_rows, torch.zeros_like(p))
    return torch.einsum(eq, p, v) / torch.clamp_min(l, 1e-30)


def _row_scales(scale_pool, table) -> torch.Tensor:
    """Gathered per-row scales ``[B, Hkv, S]`` of an int8 pool."""
    return _gather(scale_pool, table).to(torch.float32).permute(0, 2, 1)


def gqa_paged_attention_plain(q, k_pool, v_pool, table, lengths,
                              k_scale=None, v_scale=None, *,
                              sm_scale: float) -> torch.Tensor:
    """q[B, Hkv, grp, Dh] → out[B, Hkv, grp, Dv] f32."""
    k = _gather(k_pool, table).to(torch.float32)        # [B, S, Hkv, Dh]
    v = _gather(v_pool, table).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32), k) * sm_scale
    vs = None
    if k_scale is not None:
        s = s * _row_scales(k_scale, table)[:, :, None, :]
        vs = _row_scales(v_scale, table)[:, :, None, :]
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]
    return _softmax_av(s, valid[:, None, None], v, "bhgs,bshd->bhgd", vs)


def gqa_paged_prefill_plain(q, k_suf, v_suf, k_pool, v_pool, table,
                            prefix_len, chunk_len, k_scale=None, v_scale=None,
                            *, sm_scale: float) -> torch.Tensor:
    """q[B, T, Hkv, grp, Dh] → out[B, T, Hkv, grp, Dv] f32: cached prefix
    keys valid where ``kv < prefix_len``, chunk keys where ``j <= t`` and
    ``j < chunk_len``.  Int8 scales apply to the prefix rows only: the
    chunk's own K/V are raw fp."""
    b, t = q.shape[:2]
    kp = _gather(k_pool, table).to(torch.float32)       # [B, S, Hkv, Dh]
    vp = _gather(v_pool, table).to(torch.float32)
    k = torch.cat([kp, k_suf.to(torch.float32)], dim=1)
    v = torch.cat([vp, v_suf.to(torch.float32)], dim=1)
    s = torch.einsum("bthgd,bshd->bthgs", q.to(torch.float32), k) * sm_scale
    vs = None
    if k_scale is not None:
        ones = torch.ones(b, k_suf.shape[2], t, device=q.device)
        ks = torch.cat([_row_scales(k_scale, table), ones], dim=-1)
        s = s * ks[:, None, :, None, :]
        vs = torch.cat([_row_scales(v_scale, table), ones],
                       dim=-1)[:, None, :, None, :]
    dev = q.device
    kv = torch.arange(kp.shape[1], device=dev)
    j = torch.arange(t, device=dev)
    pre = kv[None, None, :] < prefix_len.to(dev).long()[:, None, None]
    suf = (j[None, None, :] <= j[None, :, None]) \
        & (j[None, None, :] < chunk_len.to(dev).long()[:, None, None])
    valid = torch.cat([pre.expand(b, t, -1), suf], dim=-1)[:, :, None, None]
    return _softmax_av(s, valid, v, "bthgs,bshd->bthgd", vs)


# ------------------------------------------------------------ CUDA wrappers
_C, _I = ctypes.c_void_p, ctypes.c_int
_DECODE_ARGS = [_C] * 5 + [_I] + [_C] * 3 + [_I] * 7 + [ctypes.c_float, _C]
_PREFILL_ARGS = [_C] * 3 + [_I] + [_C] * 4 + [_I] + [_C] * 4 + [_I] * 8 \
    + [ctypes.c_float, _C]


def _check_pools(name, q, tensors, table, k_pool, v_pool, k_scale, v_scale,
                 quant: bool):
    """Raise on anything the kernels do not take; returns the pool's dtype
    code (the fp wrappers take f32/bf16 pools, the int8 wrappers int8 pools
    with f32 scales ``[NP, PS, Hkv]``)."""
    dev = q.device
    tensors = [t for t in tensors if t is not None]
    if not q.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be CUDA tensors on one "
                         "device")
    if q.dtype != torch.float32:
        raise ValueError(f"{name}: q must be f32, got {q.dtype}")
    if table.dtype != torch.int32:
        raise ValueError(f"{name}: table must be int32, got {table.dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be contiguous")
    if v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"{name}: k_pool {tuple(k_pool.shape)} and v_pool "
                         f"{tuple(v_pool.shape)} disagree")
    if not quant:
        if k_pool.dtype not in _FP_POOLS or v_pool.dtype != k_pool.dtype:
            raise ValueError(f"{name}: fp pools must be f32 or bf16, got "
                             f"{k_pool.dtype}/{v_pool.dtype}")
        return _FP_POOLS[k_pool.dtype]
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(f"{name}: int8 pools expected, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    for sc in (k_scale, v_scale):
        if sc is None or sc.dtype != torch.float32 \
                or sc.shape != k_pool.shape[:3]:
            raise ValueError(f"{name}: int8 pools need f32 scales of shape "
                             f"{tuple(k_pool.shape[:3])}")
    if k_pool.shape[-1] % 4 or v_pool.shape[-1] % 4 \
            or k_pool.data_ptr() % 4 or v_pool.data_ptr() % 4:
        raise ValueError(f"{name}: int8 rows are read 4 codes at a time: "
                         "Dh and Dv must be multiples of 4, the pools 4-byte "
                         "aligned")
    return B.DTYPE_I8


def _decode(name, q, k_pool, v_pool, table, lengths, k_scale, v_scale,
            sm_scale, quant):
    b, hkv, grp, dh = q.shape
    _, ps, hkv_p, dh_p = k_pool.shape
    dv = v_pool.shape[-1]
    p_ = table.shape[1]
    scales = (k_scale, v_scale) if quant else ()
    code = _check_pools(name, q, (q, k_pool, v_pool, table, lengths, *scales),
                        table, k_pool, v_pool, k_scale, v_scale, quant)
    if (hkv_p, dh_p) != (hkv, dh) or table.shape[0] != b \
            or tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: inconsistent shapes "
                         f"q={tuple(q.shape)} k_pool={tuple(k_pool.shape)} "
                         f"v_pool={tuple(v_pool.shape)} table="
                         f"{tuple(table.shape)} lengths={tuple(lengths.shape)}")
    out = torch.empty(b, hkv, grp, dv, dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    null = ctypes.c_void_p(None)
    err = B.cfunc("gqa_paged_decode", _DECODE_ARGS)(
        B.vp(q), B.vp(k_pool), B.vp(v_pool),
        B.vp(k_scale) if quant else null, B.vp(v_scale) if quant else null,
        code, B.vp(table), B.vp(lengths), B.vp(out), b, hkv, grp, dh, dv, ps,
        p_, float(sm_scale), B.stream_ptr(q.device))
    B.check(err, name)
    return out


def gqa_paged_attention_cuda(q, k_pool, v_pool, table, lengths, *,
                             sm_scale: float) -> torch.Tensor:
    """Launch K2 on fp pools.  Raises on anything the kernel does not take."""
    out = _decode("gqa_paged_attention_cuda", q, k_pool, v_pool, table,
                  lengths, None, None, sm_scale, False)
    gqa_paged_attention_cuda.launches += 1
    return out


def gqa_paged_attention_int8_cuda(q, k_pool, v_pool, table, lengths, k_scale,
                                  v_scale, *, sm_scale: float) -> torch.Tensor:
    """Launch K2's int8 branch (int8 pools + f32 row scales)."""
    out = _decode("gqa_paged_attention_int8_cuda", q, k_pool, v_pool, table,
                  lengths, k_scale, v_scale, sm_scale, True)
    gqa_paged_attention_int8_cuda.launches += 1
    return out


def _prefill(name, q, k_suf, v_suf, k_pool, v_pool, table, prefix_len,
             chunk_len, k_scale, v_scale, sm_scale, quant):
    b, t, hkv, grp, dh = q.shape
    _, ps, hkv_p, dh_p = k_pool.shape
    dv = v_pool.shape[-1]
    p_ = table.shape[1]
    scales = (k_scale, v_scale) if quant else ()
    code = _check_pools(name, q, (q, k_suf, v_suf, k_pool, v_pool, table,
                                  prefix_len, chunk_len, *scales),
                        table, k_pool, v_pool, k_scale, v_scale, quant)
    suf_ok = (k_suf.dtype in _FP_POOLS if quant
              else k_suf.dtype == k_pool.dtype)
    if (hkv_p, dh_p) != (hkv, dh) \
            or tuple(k_suf.shape) != (b, t, hkv, dh) \
            or tuple(v_suf.shape) != (b, t, hkv, dv) \
            or not suf_ok or v_suf.dtype != k_suf.dtype \
            or table.shape[0] != b \
            or tuple(prefix_len.shape) != (b,) \
            or tuple(chunk_len.shape) != (b,) \
            or prefix_len.dtype != torch.int32 \
            or chunk_len.dtype != torch.int32:
        raise ValueError(f"{name}: inconsistent shapes/dtypes "
                         f"q={tuple(q.shape)} k_suf={tuple(k_suf.shape)} "
                         f"{k_suf.dtype} k_pool={tuple(k_pool.shape)} "
                         f"{k_pool.dtype} table={tuple(table.shape)}")
    out = torch.empty(b, t, hkv, grp, dv, dtype=torch.float32,
                      device=q.device)
    if b == 0 or t == 0:
        return out
    null = ctypes.c_void_p(None)
    err = B.cfunc("gqa_paged_prefill", _PREFILL_ARGS)(
        B.vp(q), B.vp(k_suf), B.vp(v_suf), _FP_POOLS[k_suf.dtype],
        B.vp(k_pool), B.vp(v_pool),
        B.vp(k_scale) if quant else null, B.vp(v_scale) if quant else null,
        code, B.vp(table), B.vp(prefix_len), B.vp(chunk_len), B.vp(out), b, t,
        hkv, grp, dh, dv, ps, p_, float(sm_scale), B.stream_ptr(q.device))
    B.check(err, name)
    return out


def gqa_paged_prefill_cuda(q, k_suf, v_suf, k_pool, v_pool, table,
                           prefix_len, chunk_len, *,
                           sm_scale: float) -> torch.Tensor:
    """Launch K3 on fp pools.  Raises on anything the kernel does not take."""
    out = _prefill("gqa_paged_prefill_cuda", q, k_suf, v_suf, k_pool, v_pool,
                   table, prefix_len, chunk_len, None, None, sm_scale, False)
    gqa_paged_prefill_cuda.launches += 1
    return out


def gqa_paged_prefill_int8_cuda(q, k_suf, v_suf, k_pool, v_pool, table,
                                prefix_len, chunk_len, k_scale, v_scale, *,
                                sm_scale: float) -> torch.Tensor:
    """Launch K3's int8 branch: int8 prefix pages + f32 row scales, raw fp
    suffix."""
    out = _prefill("gqa_paged_prefill_int8_cuda", q, k_suf, v_suf, k_pool,
                   v_pool, table, prefix_len, chunk_len, k_scale, v_scale,
                   sm_scale, True)
    gqa_paged_prefill_int8_cuda.launches += 1
    return out


gqa_paged_attention_cuda.launches = 0
gqa_paged_attention_int8_cuda.launches = 0
gqa_paged_prefill_cuda.launches = 0
gqa_paged_prefill_int8_cuda.launches = 0
