"""K2/K3: paged GQA decode and chunked-prefill attention — the CUDA kernels'
wrappers and their plain PyTorch versions.

Replace the Pallas TPU kernels ``repro/kernels/paged_attention.py``
``_gqa_kernel`` (decode) and ``_gqa_prefill_kernel`` (chunked prefill), fp
pools.  Sources: ``csrc/gqa_paged_decode.cu`` and
``csrc/gqa_paged_prefill.cu``; their headers say what bounds each on the
card.  The int8-pool branches of both Pallas kernels (``kv_quant``) are not
ported yet and the wrappers raise for int8 pools.

Contract (shared with ``serving/kv_cache.py``): ``table[B, P]`` maps each
slot's logical pages to pool pages, dead entries pointing at the trash page
0; decode ``lengths[B]`` count valid rows *including* the token written this
step.  Outputs are f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B

NEG_INF = -1e30
_POOL_DTYPES = {torch.float32: B.DTYPE_F32, torch.bfloat16: B.DTYPE_BF16}


# ------------------------------------------------------------ plain versions
def _gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    g = pool[table.long()]                      # [B, P, PS, ...]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def _softmax_av(s, valid, v, eq: str) -> torch.Tensor:
    """The kernels' masked softmax in one pass: masked scores take -1e30 and
    contribute exactly 0; a row with no valid key gives 0, not NaN."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum(eq, p, v) / torch.clamp_min(l, 1e-30)


def gqa_paged_attention_plain(q, k_pool, v_pool, table, lengths, *,
                              sm_scale: float) -> torch.Tensor:
    """q[B, Hkv, grp, Dh] → out[B, Hkv, grp, Dv] f32."""
    k = _gather(k_pool, table).to(torch.float32)        # [B, S, Hkv, Dh]
    v = _gather(v_pool, table).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32), k) * sm_scale
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]
    return _softmax_av(s, valid[:, None, None], v, "bhgs,bshd->bhgd")


def gqa_paged_prefill_plain(q, k_suf, v_suf, k_pool, v_pool, table,
                            prefix_len, chunk_len, *,
                            sm_scale: float) -> torch.Tensor:
    """q[B, T, Hkv, grp, Dh] → out[B, T, Hkv, grp, Dv] f32: cached prefix
    keys valid where ``kv < prefix_len``, chunk keys where ``j <= t`` and
    ``j < chunk_len``."""
    b, t = q.shape[:2]
    kp = _gather(k_pool, table).to(torch.float32)       # [B, S, Hkv, Dh]
    vp = _gather(v_pool, table).to(torch.float32)
    k = torch.cat([kp, k_suf.to(torch.float32)], dim=1)
    v = torch.cat([vp, v_suf.to(torch.float32)], dim=1)
    s = torch.einsum("bthgd,bshd->bthgs", q.to(torch.float32), k) * sm_scale
    dev = q.device
    kv = torch.arange(kp.shape[1], device=dev)
    j = torch.arange(t, device=dev)
    pre = kv[None, None, :] < prefix_len.to(dev).long()[:, None, None]
    suf = (j[None, None, :] <= j[None, :, None]) \
        & (j[None, None, :] < chunk_len.to(dev).long()[:, None, None])
    valid = torch.cat([pre.expand(b, t, -1), suf], dim=-1)[:, :, None, None]
    return _softmax_av(s, valid, v, "bthgs,bshd->bthgd")


# ------------------------------------------------------------ CUDA wrappers
def _fn(lib: str, sym: str, n_ptr_front: int, n_ints: int):
    """The C launcher ``sym`` with its ctypes signature: ``n_ptr_front``
    pointers, the pool dtype code, then ``n_ptr_front == 5 ? 4 : 3`` more
    pointers (table, lengths…, out), ``n_ints`` ints, scale, stream."""
    fn = getattr(B.load(lib), sym)
    if fn.argtypes is None:
        c, i = ctypes.c_void_p, ctypes.c_int
        n_back = 4 if n_ptr_front == 5 else 3
        fn.argtypes = [c] * n_ptr_front + [i] + [c] * n_back + [i] * n_ints \
            + [ctypes.c_float, c]
        fn.restype = i
    return fn


def _check_common(name, q, tensors, table, k_pool, v_pool):
    dev = q.device
    if not q.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be CUDA tensors on one "
                         "device")
    if q.dtype != torch.float32:
        raise ValueError(f"{name}: q must be f32, got {q.dtype}")
    if k_pool.dtype not in _POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise NotImplementedError(
            f"{name}: pools of {k_pool.dtype}/{v_pool.dtype} — int8 (kv_quant) "
            "pools are not ported yet; f32 and bf16 are")
    if table.dtype != torch.int32:
        raise ValueError(f"{name}: table must be int32, got {table.dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be contiguous")


def gqa_paged_attention_cuda(q, k_pool, v_pool, table, lengths, *,
                             sm_scale: float) -> torch.Tensor:
    """Launch K2.  Raises on anything the kernel does not take."""
    b, hkv, grp, dh = q.shape
    _, ps, hkv_p, dh_p = k_pool.shape
    dv = v_pool.shape[-1]
    p_ = table.shape[1]
    _check_common("gqa_paged_attention_cuda", q,
                  (q, k_pool, v_pool, table, lengths), table, k_pool, v_pool)
    if (hkv_p, dh_p) != (hkv, dh) or v_pool.shape[:3] != k_pool.shape[:3] \
            or table.shape[0] != b or tuple(lengths.shape) != (b,) \
            or lengths.dtype != torch.int32:
        raise ValueError("gqa_paged_attention_cuda: inconsistent shapes "
                         f"q={tuple(q.shape)} k_pool={tuple(k_pool.shape)} "
                         f"v_pool={tuple(v_pool.shape)} table="
                         f"{tuple(table.shape)} lengths={tuple(lengths.shape)}")
    out = torch.empty(b, hkv, grp, dv, dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    fn = _fn("gqa_paged_decode", "repro_gqa_paged_decode", 3, 7)
    err = fn(B.vp(q), B.vp(k_pool), B.vp(v_pool), _POOL_DTYPES[k_pool.dtype],
             B.vp(table), B.vp(lengths), B.vp(out), b, hkv, grp, dh, dv, ps,
             p_, float(sm_scale), B.stream_ptr(q.device))
    B.check(err, "gqa_paged_attention")
    gqa_paged_attention_cuda.launches += 1
    return out


def gqa_paged_prefill_cuda(q, k_suf, v_suf, k_pool, v_pool, table,
                           prefix_len, chunk_len, *,
                           sm_scale: float) -> torch.Tensor:
    """Launch K3.  Raises on anything the kernel does not take."""
    b, t, hkv, grp, dh = q.shape
    _, ps, hkv_p, dh_p = k_pool.shape
    dv = v_pool.shape[-1]
    p_ = table.shape[1]
    _check_common("gqa_paged_prefill_cuda", q,
                  (q, k_suf, v_suf, k_pool, v_pool, table, prefix_len,
                   chunk_len), table, k_pool, v_pool)
    if (hkv_p, dh_p) != (hkv, dh) or v_pool.shape[:3] != k_pool.shape[:3] \
            or tuple(k_suf.shape) != (b, t, hkv, dh) \
            or tuple(v_suf.shape) != (b, t, hkv, dv) \
            or k_suf.dtype != k_pool.dtype or v_suf.dtype != k_pool.dtype \
            or table.shape[0] != b \
            or tuple(prefix_len.shape) != (b,) \
            or tuple(chunk_len.shape) != (b,) \
            or prefix_len.dtype != torch.int32 \
            or chunk_len.dtype != torch.int32:
        raise ValueError("gqa_paged_prefill_cuda: inconsistent shapes/dtypes "
                         f"q={tuple(q.shape)} k_suf={tuple(k_suf.shape)} "
                         f"{k_suf.dtype} k_pool={tuple(k_pool.shape)} "
                         f"{k_pool.dtype} table={tuple(table.shape)}")
    out = torch.empty(b, t, hkv, grp, dv, dtype=torch.float32,
                      device=q.device)
    if b == 0 or t == 0:
        return out
    fn = _fn("gqa_paged_prefill", "repro_gqa_paged_prefill", 5, 8)
    err = fn(B.vp(q), B.vp(k_suf), B.vp(v_suf), B.vp(k_pool), B.vp(v_pool),
             _POOL_DTYPES[k_pool.dtype], B.vp(table), B.vp(prefix_len),
             B.vp(chunk_len), B.vp(out), b, t, hkv, grp, dh, dv, ps, p_,
             float(sm_scale), B.stream_ptr(q.device))
    B.check(err, "gqa_paged_prefill")
    gqa_paged_prefill_cuda.launches += 1
    return out


gqa_paged_attention_cuda.launches = 0
gqa_paged_prefill_cuda.launches = 0
