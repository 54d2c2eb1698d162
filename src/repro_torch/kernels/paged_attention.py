"""Paged decode and chunked-prefill attention — the CUDA kernels' wrappers
and their plain PyTorch versions, GQA (K2/K3) and MLA (B8/B9).

Replace the Pallas TPU kernels of ``repro/kernels/paged_attention.py``:
``_gqa_kernel`` (decode) and ``_gqa_prefill_kernel`` (chunked prefill) over
``[NP, PS, Hkv, D]`` K/V pools, and ``_mla_kernel`` / ``_mla_prefill_kernel``,
their absorbed Multi-head Latent Attention forms over the latent pools
``ckv[NP, PS, r]`` / ``kpe[NP, PS, dr]``; each in both branches: fp pools and
int8 pools with f32 row scales (``kv_quant``: ``[NP, PS, Hkv]`` for GQA,
``[NP, PS]`` for MLA).  Sources: ``csrc/gqa_paged_decode.cu``,
``csrc/gqa_paged_prefill.cu``, ``csrc/mla_paged_decode.cu`` and
``csrc/mla_paged_prefill.cu`` (B8/B9 on the shared tensor-core tile of
``csrc/mla_tile.cuh``); their headers say what bounds each on the card.
The int8 launches have wrappers (and launch counters) of their own, so a
run shows which branch ran.

Contract (shared with ``serving/kv_cache.py``): ``table[B, P]`` maps each
slot's logical pages to pool pages, dead entries pointing at the trash page
0; decode ``lengths[B]`` count valid rows *including* the token written this
step.  With int8 pools a score is ``q·k_codes · sm_scale · k_scale[row]``,
the softmax sum takes the unscaled exp, and only the value weights are
scaled by ``v_scale[row]``.  MLA scores a latent row as ``(q_lat·ckv ·
ckv_scale[row] + q_pe·kpe · kpe_scale[row]) · sm_scale`` (scales 1 for fp
pools) and sums ``p · ckv_scale[row] · ckv`` into its latent output.
Outputs are f32.
"""
from __future__ import annotations

import ctypes
import functools

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


def _mla_scores(q_lat, q_pe, ckv, kpe, cs, ps, sm_scale, eq: str):
    """``(q_lat·ckv · cs + q_pe·kpe · ps) · sm_scale`` in the reference's
    order; ``cs``/``ps`` (int8 pools) broadcast over the key axis."""
    s_lat = torch.einsum(eq, q_lat.to(torch.float32), ckv)
    s_pe = torch.einsum(eq, q_pe.to(torch.float32), kpe)
    if cs is not None:
        s_lat, s_pe = s_lat * cs, s_pe * ps
    return (s_lat + s_pe) * sm_scale


def mla_paged_attention_plain(q_lat, q_pe, ckv_pool, kpe_pool, table,
                              lengths, ckv_scale=None, kpe_scale=None, *,
                              sm_scale: float) -> torch.Tensor:
    """Absorbed MLA decode: q_lat[B, H, r], q_pe[B, H, dr] against the live
    latent rows ``pos < lengths[b]`` → o_lat[B, H, r] f32."""
    ckv = _gather(ckv_pool, table).to(torch.float32)     # [B, S, r]
    kpe = _gather(kpe_pool, table).to(torch.float32)     # [B, S, dr]
    cs = ps = None
    if ckv_scale is not None:
        cs = _gather(ckv_scale, table).to(torch.float32)[:, None, :]
        ps = _gather(kpe_scale, table).to(torch.float32)[:, None, :]
    s = _mla_scores(q_lat, q_pe, ckv, kpe, cs, ps, sm_scale, "bhr,bsr->bhs")
    pos = torch.arange(ckv.shape[1], device=q_lat.device)
    valid = pos[None, :] < lengths.to(q_lat.device).long()[:, None]
    return _softmax_av(s, valid[:, None, :], ckv, "bhs,bsr->bhr", cs)


def mla_paged_prefill_plain(q_lat, q_pe, ckv_suf, kpe_suf, ckv_pool,
                            kpe_pool, table, prefix_len, chunk_len,
                            ckv_scale=None, kpe_scale=None, *,
                            sm_scale: float) -> torch.Tensor:
    """Absorbed MLA chunked prefill: q_lat[B, T, H, r], q_pe[B, T, H, dr]
    → o_lat[B, T, H, r] f32.  Cached latent rows are valid where ``kv <
    prefix_len``, chunk rows (raw, never scaled) where ``j <= t`` and ``j <
    chunk_len``."""
    b, t = q_lat.shape[:2]
    dev = q_lat.device
    cp = _gather(ckv_pool, table).to(torch.float32)      # [B, S, r]
    kp = _gather(kpe_pool, table).to(torch.float32)
    ckv = torch.cat([cp, ckv_suf.to(torch.float32)], dim=1)
    kpe = torch.cat([kp, kpe_suf.to(torch.float32)], dim=1)
    cs = ps = None
    if ckv_scale is not None:
        ones = torch.ones(b, t, device=dev)
        cs = torch.cat([_gather(ckv_scale, table).to(torch.float32), ones],
                       dim=1)[:, None, None, :]
        ps = torch.cat([_gather(kpe_scale, table).to(torch.float32), ones],
                       dim=1)[:, None, None, :]
    s = _mla_scores(q_lat, q_pe, ckv, kpe, cs, ps, sm_scale,
                    "bthr,bsr->bths")
    kv = torch.arange(cp.shape[1], device=dev)
    j = torch.arange(t, device=dev)
    pre = kv[None, None, :] < prefix_len.to(dev).long()[:, None, None]
    suf = (j[None, None, :] <= j[None, :, None]) \
        & (j[None, None, :] < chunk_len.to(dev).long()[:, None, None])
    valid = torch.cat([pre.expand(b, t, -1), suf], dim=-1)[:, :, None, :]
    return _softmax_av(s, valid, ckv, "bths,bsr->bthr", cs)


# ------------------------------------------------------------ CUDA wrappers
_C, _I = ctypes.c_void_p, ctypes.c_int
_DECODE_ARGS = [_C] * 5 + [_I] + [_C] * 4 + [_I] * 9 + [ctypes.c_float, _C]
#: K2 aims at this many blocks per SM (bytes in flight), in at most
#: _DECODE_MAX_SPLITS splits of each slot's pages
_DECODE_BLOCKS_PER_SM = 4
_DECODE_MAX_SPLITS = 32
#: query heads one K2 block holds in registers (csrc/gqa_paged_decode.cu)
_DECODE_MAX_HEADS = 8


@functools.lru_cache(maxsize=None)      # asked at every decode launch
def gqa_decode_splits(b: int, hkv: int, grp: int, pages: int,
                      sms: int) -> tuple:
    """K2's split-KV rule: ``(splits, pages per split)`` for a batch of
    ``b`` slots, ``hkv`` KV heads of ``grp`` query heads and ``pages``
    table pages a slot, on a card of ``sms`` SMs.  Static shapes only —
    never the slots' lengths — so the launch needs no host sync and can be
    captured in a CUDA graph.  Enough splits for ``_DECODE_BLOCKS_PER_SM``
    blocks per SM, at most one a page; split s takes pages ``[s * pps,
    (s + 1) * pps)`` and the last split is never empty of pages."""
    blocks = max(1, b * hkv * -(-grp // _DECODE_MAX_HEADS))
    want = -(-_DECODE_BLOCKS_PER_SM * sms // blocks)
    splits = max(1, min(want, pages, _DECODE_MAX_SPLITS))
    pps = max(1, -(-pages // splits))
    return max(1, -(-pages // pps)), pps
_PREFILL_ARGS = [_C] * 3 + [_I] + [_C] * 4 + [_I] + [_C] * 4 + [_I] * 8 \
    + [ctypes.c_float, _C]


def _check_pools(name, qs, tensors, table, k_pool, v_pool, k_scale, v_scale,
                 quant: bool):
    """Raise on anything the paged-attention kernels do not take; returns
    the pools' dtype code.  ``qs`` are the query tensors (f32); the two
    pools (K/V, or MLA's ckv/kpe) share every dim but their row width; the
    fp wrappers take f32/bf16 pools, the int8 wrappers int8 pools with f32
    row scales of the pools' shape without the row (``[NP, PS, Hkv]`` for
    GQA, ``[NP, PS]`` for MLA)."""
    dev = qs[0].device
    tensors = [t for t in tensors if t is not None]
    if not qs[0].is_cuda or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be CUDA tensors on one "
                         "device")
    if any(q.dtype != torch.float32 for q in qs):
        raise ValueError(f"{name}: queries must be f32, got "
                         f"{[q.dtype for q in qs]}")
    if table.dtype != torch.int32:
        raise ValueError(f"{name}: table must be int32, got {table.dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be contiguous")
    lead = k_pool.shape[:-1]
    if v_pool.shape[:-1] != lead:
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)} and "
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
        if sc is None or sc.dtype != torch.float32 or sc.shape != lead:
            raise ValueError(f"{name}: int8 pools need f32 scales of shape "
                             f"{tuple(lead)}")
    if k_pool.shape[-1] % 4 or v_pool.shape[-1] % 4 \
            or k_pool.data_ptr() % 4 or v_pool.data_ptr() % 4:
        raise ValueError(f"{name}: int8 rows are read 4 codes at a time: "
                         "their widths must be multiples of 4, the pools "
                         "4-byte aligned")
    return B.DTYPE_I8


def _decode(name, q, k_pool, v_pool, table, lengths, k_scale, v_scale,
            sm_scale, quant):
    b, hkv, grp, dh = q.shape
    _, ps, hkv_p, dh_p = k_pool.shape
    dv = v_pool.shape[-1]
    p_ = table.shape[1]
    scales = (k_scale, v_scale) if quant else ()
    code = _check_pools(name, (q,), (q, k_pool, v_pool, table, lengths,
                                      *scales),
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
    splits, pps = gqa_decode_splits(b, hkv, grp, p_, B.sm_count(q.device))
    # the splits' partial states (m, l, acc[Dv]) per query row
    part = (torch.empty(b * hkv * grp * splits * (2 + dv),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    null = ctypes.c_void_p(None)
    err = B.cfunc("gqa_paged_decode", _DECODE_ARGS)(
        B.vp(q), B.vp(k_pool), B.vp(v_pool),
        B.vp(k_scale) if quant else null, B.vp(v_scale) if quant else null,
        code, B.vp(table), B.vp(lengths), B.vp(part), B.vp(out), b, hkv, grp,
        dh, dv, ps, p_, splits, pps, float(sm_scale), B.stream_ptr(q.device))
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
    code = _check_pools(name, (q,), (q, k_suf, v_suf, k_pool, v_pool, table,
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


# ---------------------------------------------------------- MLA wrappers ---
_MLA_DECODE_ARGS = [_C] * 6 + [_I] + [_C] * 4 + [_I] * 8 + [ctypes.c_float,
                                                           _C]
_MLA_PREFILL_ARGS = [_C] * 4 + [_I] + [_C] * 4 + [_I] + [_C] * 4 + [_I] * 7 \
    + [ctypes.c_float, _C]
#: query heads one B8 tile block holds and latent rows of one key tile
#: (csrc/mla_tile.cuh kRows, kKeys); a block holds up to 227 KB of shared
#: memory, so one fits an SM
_MLA_ROWS, _MLA_KEYS = 64, 32
_DTYPE_CODES = {torch.float32: B.DTYPE_F32, torch.bfloat16: B.DTYPE_BF16,
                torch.int8: B.DTYPE_I8}


@functools.lru_cache(maxsize=None)      # asked at every decode launch
def mla_decode_splits(b: int, h: int, pages: int, ps: int,
                      sms: int) -> tuple:
    """B8's split-KV rule: ``(splits, pages per split)`` for a batch of
    ``b`` slots of ``h`` query heads and ``pages`` table pages of ``ps``
    rows a slot, on a card of ``sms`` SMs.  Static shapes only — never the
    slots' lengths — so the launch needs no host sync and can be captured
    in a CUDA graph.  One wave of one block per SM, ``sms // blocks``
    splits, each of at least one 32-key tile (both warps of a row group
    score keys), at most ``_DECODE_MAX_SPLITS``; split s takes pages ``[s
    * pps, (s + 1) * pps)`` and the last split is never empty of pages."""
    blocks = max(1, b * -(-h // _MLA_ROWS))
    min_pps = -(-_MLA_KEYS // max(ps, 1))
    splits = max(1, min(sms // blocks, -(-pages // min_pps),
                        _DECODE_MAX_SPLITS))
    pps = max(1, -(-pages // splits))
    return max(1, -(-pages // pps)), pps


@functools.lru_cache(maxsize=None)
def _mla_route(lib: str, *codes) -> str:
    fn = getattr(B.load(lib), f"repro_{lib}_route")
    fn.argtypes = [_I] * len(codes)
    fn.restype = _I
    code = fn(*codes)
    if code < 0:
        raise ValueError(f"{lib}: no kernel for element types {codes[:-2]}")
    return "tile" if code else "general"


def mla_decode_route(pool_dtype: torch.dtype, r: int, dr: int) -> str:
    """``"tile"`` where B8 runs the tensor-core tile for these latent pools
    and widths, ``"general"`` where one tile stage does not fit in shared
    memory and the CUDA-core kernel runs.  The rule is
    ``csrc/mla_tile.cuh``'s ``make_geo``, asked of the built library."""
    return _mla_route("mla_paged_decode", _DTYPE_CODES[pool_dtype], r, dr)


def mla_prefill_route(suf_dtype: torch.dtype, pool_dtype: torch.dtype,
                      r: int, dr: int) -> str:
    """B9's route (as :func:`mla_decode_route`) for chunk latents of
    ``suf_dtype`` and latent pools of ``pool_dtype``."""
    return _mla_route("mla_paged_prefill", _DTYPE_CODES[suf_dtype],
                      _DTYPE_CODES[pool_dtype], r, dr)


def _mla_decode(name, q_lat, q_pe, ckv_pool, kpe_pool, table, lengths,
                ckv_scale, kpe_scale, sm_scale, quant):
    b, h, r = q_lat.shape
    dr = q_pe.shape[-1]
    ps = ckv_pool.shape[1]
    p_ = table.shape[1]
    scales = (ckv_scale, kpe_scale) if quant else ()
    code = _check_pools(name, (q_lat, q_pe),
                        (q_lat, q_pe, ckv_pool, kpe_pool, table, lengths,
                         *scales),
                        table, ckv_pool, kpe_pool, ckv_scale, kpe_scale, quant)
    if tuple(q_pe.shape) != (b, h, dr) or ckv_pool.ndim != 3 \
            or ckv_pool.shape[-1] != r \
            or kpe_pool.shape[-1] != dr or table.shape[0] != b \
            or tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: inconsistent shapes q_lat="
                         f"{tuple(q_lat.shape)} q_pe={tuple(q_pe.shape)} "
                         f"ckv_pool={tuple(ckv_pool.shape)} kpe_pool="
                         f"{tuple(kpe_pool.shape)} table={tuple(table.shape)} "
                         f"lengths={tuple(lengths.shape)}")
    dev = q_lat.device
    out = torch.empty(b, h, r, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    splits, pps = (mla_decode_splits(b, h, p_, ps, B.sm_count(dev))
                   if mla_decode_route(ckv_pool.dtype, r, dr) == "tile"
                   else (1, max(p_, 1)))
    # the splits' partial states (m, l, acc[r]) per query head
    part = (torch.empty(b * h * splits * (2 + r), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    null = ctypes.c_void_p(None)
    err = B.cfunc("mla_paged_decode", _MLA_DECODE_ARGS)(
        B.vp(q_lat), B.vp(q_pe), B.vp(ckv_pool), B.vp(kpe_pool),
        B.vp(ckv_scale) if quant else null,
        B.vp(kpe_scale) if quant else null, code, B.vp(table), B.vp(lengths),
        B.vp(part), B.vp(out), b, h, r, dr, ps, p_, splits, pps,
        float(sm_scale), B.stream_ptr(dev))
    B.check(err, name)
    return out


def mla_paged_attention_cuda(q_lat, q_pe, ckv_pool, kpe_pool, table, lengths,
                             *, sm_scale: float) -> torch.Tensor:
    """Launch B8 on fp latent pools.  Raises on anything the kernel does not
    take."""
    out = _mla_decode("mla_paged_attention_cuda", q_lat, q_pe, ckv_pool,
                      kpe_pool, table, lengths, None, None, sm_scale, False)
    mla_paged_attention_cuda.launches += 1
    return out


def mla_paged_attention_int8_cuda(q_lat, q_pe, ckv_pool, kpe_pool, table,
                                  lengths, ckv_scale, kpe_scale, *,
                                  sm_scale: float) -> torch.Tensor:
    """Launch B8's int8 branch (int8 latent pools + f32 row scales)."""
    out = _mla_decode("mla_paged_attention_int8_cuda", q_lat, q_pe, ckv_pool,
                      kpe_pool, table, lengths, ckv_scale, kpe_scale,
                      sm_scale, True)
    mla_paged_attention_int8_cuda.launches += 1
    return out


def _mla_prefill(name, q_lat, q_pe, ckv_suf, kpe_suf, ckv_pool, kpe_pool,
                 table, prefix_len, chunk_len, ckv_scale, kpe_scale, sm_scale,
                 quant):
    b, t, h, r = q_lat.shape
    dr = q_pe.shape[-1]
    ps = ckv_pool.shape[1]
    p_ = table.shape[1]
    scales = (ckv_scale, kpe_scale) if quant else ()
    code = _check_pools(name, (q_lat, q_pe),
                        (q_lat, q_pe, ckv_suf, kpe_suf, ckv_pool, kpe_pool,
                         table, prefix_len, chunk_len, *scales),
                        table, ckv_pool, kpe_pool, ckv_scale, kpe_scale, quant)
    suf_ok = (ckv_suf.dtype in _FP_POOLS if quant
              else ckv_suf.dtype == ckv_pool.dtype)
    if tuple(q_pe.shape) != (b, t, h, dr) \
            or tuple(ckv_suf.shape) != (b, t, r) \
            or tuple(kpe_suf.shape) != (b, t, dr) \
            or not suf_ok or kpe_suf.dtype != ckv_suf.dtype \
            or ckv_pool.ndim != 3 or ckv_pool.shape[-1] != r \
            or kpe_pool.shape[-1] != dr \
            or table.shape[0] != b \
            or tuple(prefix_len.shape) != (b,) \
            or tuple(chunk_len.shape) != (b,) \
            or prefix_len.dtype != torch.int32 \
            or chunk_len.dtype != torch.int32:
        raise ValueError(f"{name}: inconsistent shapes/dtypes q_lat="
                         f"{tuple(q_lat.shape)} q_pe={tuple(q_pe.shape)} "
                         f"ckv_suf={tuple(ckv_suf.shape)} {ckv_suf.dtype} "
                         f"ckv_pool={tuple(ckv_pool.shape)} {ckv_pool.dtype} "
                         f"table={tuple(table.shape)}")
    out = torch.empty(b, t, h, r, dtype=torch.float32, device=q_lat.device)
    if b == 0 or t == 0:
        return out
    null = ctypes.c_void_p(None)
    err = B.cfunc("mla_paged_prefill", _MLA_PREFILL_ARGS)(
        B.vp(q_lat), B.vp(q_pe), B.vp(ckv_suf), B.vp(kpe_suf),
        _FP_POOLS[ckv_suf.dtype], B.vp(ckv_pool), B.vp(kpe_pool),
        B.vp(ckv_scale) if quant else null,
        B.vp(kpe_scale) if quant else null, code, B.vp(table),
        B.vp(prefix_len), B.vp(chunk_len), B.vp(out), b, t, h, r, dr, ps, p_,
        float(sm_scale), B.stream_ptr(q_lat.device))
    B.check(err, name)
    return out


def mla_paged_prefill_cuda(q_lat, q_pe, ckv_suf, kpe_suf, ckv_pool, kpe_pool,
                           table, prefix_len, chunk_len, *,
                           sm_scale: float) -> torch.Tensor:
    """Launch B9 on fp latent pools.  Raises on anything the kernel does not
    take."""
    out = _mla_prefill("mla_paged_prefill_cuda", q_lat, q_pe, ckv_suf,
                       kpe_suf, ckv_pool, kpe_pool, table, prefix_len,
                       chunk_len, None, None, sm_scale, False)
    mla_paged_prefill_cuda.launches += 1
    return out


def mla_paged_prefill_int8_cuda(q_lat, q_pe, ckv_suf, kpe_suf, ckv_pool,
                                kpe_pool, table, prefix_len, chunk_len,
                                ckv_scale, kpe_scale, *,
                                sm_scale: float) -> torch.Tensor:
    """Launch B9's int8 branch: int8 prefix pages + f32 row scales, raw fp
    chunk latents."""
    out = _mla_prefill("mla_paged_prefill_int8_cuda", q_lat, q_pe, ckv_suf,
                       kpe_suf, ckv_pool, kpe_pool, table, prefix_len,
                       chunk_len, ckv_scale, kpe_scale, sm_scale, True)
    mla_paged_prefill_int8_cuda.launches += 1
    return out


mla_paged_attention_cuda.launches = 0
mla_paged_attention_int8_cuda.launches = 0
mla_paged_prefill_cuda.launches = 0
mla_paged_prefill_int8_cuda.launches = 0
