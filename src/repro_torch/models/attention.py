"""GQA and Multi-head Latent Attention (port of ``repro/models/attention.py``:
GQA, and MLA's paged absorbed forms).

Caches: the contiguous decode cache is ``{"k"/"v": [B, S, Hkv, Dh],
"lens": [B]}``; the paged pools are ``{"k"/"v": [num_pages, page_size, Hkv,
Dh]}`` shared across slots, addressed through ``table_rows[B, P]`` (dead
entries point at the trash page 0).  Under ``cfg.kv_quant`` the pools hold
int8 codes plus ``{"k_s"/"v_s": [num_pages, page_size, Hkv]}`` f32 scales
(:func:`kv_quantize_rows`).  MLA pages only its compressed latent:
``{"ckv": [num_pages, page_size, r], "kpe": [num_pages, page_size, dr]}``,
plus ``{"ckv_s"/"kpe_s": [num_pages, page_size]}`` under ``kv_quant``.

Where the reference scatters functionally and relies on ``donate_argnums``
so XLA reuses the pool buffers, the port writes the new KV rows into the
pool tensors in place.

``cfg.paged_attn_impl``: ``"auto"`` runs the paged-attention kernels through
``kernels.ops`` (their plain versions for CPU tensors); ``"gather"`` is the
dense page-gather oracle, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

NEG_INF = -1e30


def init_gqa(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    d, h, hkv, dh, dt = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.hdim, cfg.tdtype)
    return {"wq": L.init_linear(gen, d, h * dh, dt),
            "wk": L.init_linear(gen, d, hkv * dh, dt),
            "wv": L.init_linear(gen, d, hkv * dh, dt),
            "wo": L.init_linear(gen, h * dh, d, dt)}


def _qkv(p, x, positions, cfg: ModelConfig):
    b, t, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    act = cfg.act_kernel
    q = L.apply_linear(p["wq"], x, act=act).reshape(b, t, h, dh)
    k = L.apply_linear(p["wk"], x, act=act).reshape(b, t, hkv, dh)
    v = L.apply_linear(p["wv"], x, act=act).reshape(b, t, hkv, dh)
    q = L.apply_rope(q, positions, theta=cfg.rope_theta)
    k = L.apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, q_pos, k_pos, k_valid=None, *,
                      causal: bool = True, q_chunk: int = 2048,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over ``[q_chunk, kv_chunk]`` score blocks.
    q[B,T,H,Dh], k/v[B,S,Hkv,D*] → [B,T,H,Dv] in q's dtype."""
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    grp = h // hkv
    scale = dh ** -0.5
    if k_valid is None:
        k_valid = torch.ones(b, s, dtype=torch.bool, device=q.device)
    q_chunk, kv_chunk = min(q_chunk, t), min(kv_chunk, s)
    outs = []
    for q0 in range(0, t, q_chunk):
        qq = q[:, q0:q0 + q_chunk].to(torch.float32)
        qc = qq.shape[1]
        qq = qq.reshape(b, qc, hkv, grp, dh)
        qp = q_pos[:, q0:q0 + q_chunk]
        m = torch.full((b, hkv, grp, qc), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, grp, qc), device=q.device)
        acc = torch.zeros((b, hkv, grp, qc, dv), device=q.device)
        for k0 in range(0, s, kv_chunk):
            kk = k[:, k0:k0 + kv_chunk].to(torch.float32)
            vv = v[:, k0:k0 + kv_chunk].to(torch.float32)
            mask = k_valid[:, None, None, None, k0:k0 + kv_chunk]
            if causal:
                kp = k_pos[:, k0:k0 + kv_chunk]
                mask = mask & (kp[:, None, None, None, :]
                               <= qp[:, None, None, :, None])
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qq, kk) * scale
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                       p, vv)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))         # [B,qc,Hkv,grp,Dv]
    return torch.cat(outs, dim=1).reshape(b, t, h, dv).to(q.dtype)


def _full_attention(q, k, v, positions, cfg: ModelConfig, causal: bool):
    """Full-sequence attention: the flash kernel (B4) under
    ``cfg.attn_impl="flash"`` (index positions, as the reference's kernel),
    else the chunked online-softmax PyTorch path."""
    if cfg.attn_impl == "flash":
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal)
    return chunked_attention(q, k, v, positions, positions, causal=causal)


def gqa_prefill(p, x, positions, cfg: ModelConfig, *, causal: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (calibration / teacher-forced forward)."""
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    out = _full_attention(q, k, v, positions, cfg, causal)
    y = L.apply_linear(p["wo"], out.reshape(b, t, -1), act=cfg.act_kernel)
    lens = torch.full((b,), t, dtype=torch.int32, device=x.device)
    return y, {"k": k, "v": v, "lens": lens}


def _attend_rows(qh, k_rows, v_rows, valid, scale, k_s=None, v_s=None):
    """One-token attention of qh[B,Hkv,grp,Dh] against k/v[B,S,Hkv,D*].
    With int8 rows, ``k_s``/``v_s[B,S,Hkv]`` scale the score and the
    probability rows (no dense dequantized copy)."""
    sc = torch.einsum("bhgd,bshd->bhgs", qh.to(torch.float32),
                      k_rows.to(torch.float32)) * scale
    if k_s is not None:
        sc = sc * k_s.to(torch.float32).permute(0, 2, 1)[:, :, None, :]
    sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    pattn = torch.softmax(sc, dim=-1)
    if v_s is not None:
        pattn = pattn * v_s.to(torch.float32).permute(0, 2, 1)[:, :, None, :]
    return torch.einsum("bhgs,bshd->bhgd", pattn, v_rows.to(torch.float32))


def gqa_decode(p, x, positions, cache, cfg: ModelConfig):
    """One-token decode against a contiguous [B, Smax] cache (updated in
    place).  x: [B, 1, D]."""
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    q, k, v = _qkv(p, x, positions, cfg)
    slot = cache["lens"].long()
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    kpos = torch.arange(cache["k"].shape[1], device=x.device)
    valid = kpos[None, :] <= slot[:, None]
    out = _attend_rows(q.reshape(b, hkv, h // hkv, dh), cache["k"],
                       cache["v"], valid, dh ** -0.5)
    cache["lens"] += 1
    y = L.apply_linear(p["wo"], out.reshape(b, 1, h * dh).to(x.dtype),
                       act=cfg.act_kernel)
    return y, cache


def init_gqa_cache(cfg: ModelConfig, batch: int, smax: int, device):
    shp = (batch, smax, cfg.num_kv_heads, cfg.hdim)
    return {"k": torch.zeros(shp, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shp, dtype=cfg.tdtype, device=device),
            "lens": torch.zeros(batch, dtype=torch.int32, device=device)}


# ------------------------------------------------------------------ paged ---
def gather_pages(pool: torch.Tensor, table_rows: torch.Tensor) -> torch.Tensor:
    """pool[NP, PS, ...] + table_rows[B, P] → dense [B, P*PS, ...] rows in
    logical order (the reference gather; the kernels never build this)."""
    g = pool[table_rows.long()]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def _gathered_rows(pool, name: str, table_rows, kv_quant: bool
                   ) -> torch.Tensor:
    """Dense [B, P*PS, ...] rows of ``pool[name]``, dequantized with
    ``pool[name + "_s"]`` under ``kv_quant`` (the gather oracle)."""
    rows = gather_pages(pool[name], table_rows)
    if not kv_quant:
        return rows
    scales = gather_pages(pool[name + "_s"], table_rows)
    return rows.to(torch.float32) * scales.to(torch.float32)[..., None]


def _chunk_positions(start_len: torch.Tensor, t: int) -> torch.Tensor:
    return start_len.long()[:, None] + torch.arange(
        t, device=start_len.device)[None, :]


def _store_rows(pool, name: str, idx, rows, kv_quant: bool) -> None:
    """Write KV rows into ``pool[name]`` at the pool index ``idx`` in place:
    int8 codes plus their scales under ``kv_quant``, else in the pool's
    dtype."""
    if kv_quant:
        codes, scl = kv_quantize_rows(rows)
        pool[name][idx] = codes
        pool[name + "_s"][idx] = scl
    else:
        pool[name][idx] = rows.to(pool[name].dtype)


def _scatter_chunk(pool, updates, table_rows, start_len, chunk_len,
                   kv_quant: bool):
    """Write a [B, T, ...] chunk of raw KV rows into the pools in place at
    logical positions start_len[b] + t (quantized per row under
    ``kv_quant``); padded rows (t >= chunk_len[b]) land on the trash
    page."""
    b, t = next(iter(updates.values())).shape[:2]
    ps = pool[next(iter(updates))].shape[1]
    n_pages = table_rows.shape[1]
    pos = _chunk_positions(start_len, t)
    valid = torch.arange(t, device=pos.device)[None, :] \
        < chunk_len.long()[:, None]
    lpage = torch.clamp(pos // ps, max=n_pages - 1)
    pg = torch.where(valid, table_rows.long().gather(1, lpage),
                     torch.zeros_like(lpage))
    off = pos % ps
    for name, rows in updates.items():
        _store_rows(pool, name, (pg, off), rows, kv_quant)


def gqa_prefill_chunk(p, x, pool, table_rows, start_len, chunk_len,
                      cfg: ModelConfig):
    """Chunked prefill straight against the paged pools: row b's token t sits
    at position start_len[b] + t.  The chunk's KV is written into the pages
    first; attention reads the start_len prefix rows from the pools and the
    chunk's own K/V raw (never quantized).  Returns (y, pool)."""
    b, t, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    grp = h // hkv
    positions = _chunk_positions(start_len, t)
    q, k, v = _qkv(p, x, positions, cfg)
    _scatter_chunk(pool, {"k": k, "v": v}, table_rows, start_len, chunk_len,
                   cfg.kv_quant)
    scale = dh ** -0.5
    if cfg.paged_attn_impl == "auto":
        out = kops.gqa_paged_prefill(
            q.reshape(b, t, hkv, grp, dh).to(torch.float32).contiguous(),
            k.contiguous(), v.contiguous(), pool["k"], pool["v"], table_rows,
            start_len, chunk_len, pool.get("k_s"), pool.get("v_s"),
            sm_scale=scale).reshape(b, t, h, -1)
    else:
        pk = _gathered_rows(pool, "k", table_rows, cfg.kv_quant)
        pv = _gathered_rows(pool, "v", table_rows, cfg.kv_quant)
        s = pk.shape[1]
        kpos_pre = torch.arange(s, device=x.device)[None].expand(b, s)
        tt = torch.arange(t, device=x.device)[None, :]
        k_valid = torch.cat([kpos_pre < start_len.long()[:, None],
                             tt < chunk_len.long()[:, None]], dim=1)
        out = chunked_attention(
            q, torch.cat([pk.to(k.dtype), k], dim=1),
            torch.cat([pv.to(v.dtype), v], dim=1), positions,
            torch.cat([kpos_pre, positions], dim=1), k_valid, causal=True)
    y = L.apply_linear(p["wo"], out.reshape(b, t, -1).to(x.dtype).contiguous(),
                       act=cfg.act_kernel)
    return y, pool


def gqa_decode_paged(p, x, positions, pool, table_rows, write_pos,
                     cfg: ModelConfig):
    """One-token decode against the paged pools; write_pos[B] is the logical
    position the new token lands at.  Returns (y, pool)."""
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    q, k, v = _qkv(p, x, positions, cfg)
    ps = pool["k"].shape[1]
    wp = write_pos.long()
    bidx = torch.arange(b, device=x.device)
    pg = table_rows.long()[bidx, wp // ps]
    off = wp % ps
    # idle slots' table rows all point at the trash page: their writes
    # collide there harmlessly
    _store_rows(pool, "k", (pg, off), k[:, 0], cfg.kv_quant)
    _store_rows(pool, "v", (pg, off), v[:, 0], cfg.kv_quant)
    qh = q.reshape(b, hkv, h // hkv, dh)
    scale = dh ** -0.5
    if cfg.paged_attn_impl == "auto":
        out = kops.gqa_paged_attention(
            qh.to(torch.float32).contiguous(), pool["k"], pool["v"],
            table_rows, (write_pos + 1).to(torch.int32), pool.get("k_s"),
            pool.get("v_s"), sm_scale=scale)
    else:
        k_rows = gather_pages(pool["k"], table_rows)
        v_rows = gather_pages(pool["v"], table_rows)
        valid = torch.arange(k_rows.shape[1], device=x.device)[None, :] \
            <= wp[:, None]
        out = _attend_rows(
            qh, k_rows, v_rows, valid, scale,
            gather_pages(pool["k_s"], table_rows) if cfg.kv_quant else None,
            gather_pages(pool["v_s"], table_rows) if cfg.kv_quant else None)
    y = L.apply_linear(p["wo"], out.reshape(b, 1, h * dh).to(x.dtype),
                       act=cfg.act_kernel)
    return y, pool


def init_gqa_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                       device) -> Dict[str, torch.Tensor]:
    shp = (num_pages, page_size, cfg.num_kv_heads, cfg.hdim)
    if cfg.kv_quant:
        return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shp[:3], dtype=torch.float32,
                                   device=device),
                "v_s": torch.zeros(shp[:3], dtype=torch.float32,
                                   device=device)}
    return {"k": torch.zeros(shp, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shp, dtype=cfg.tdtype, device=device)}


def kv_quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 over the trailing dim: ``x[..., D]`` →
    ``(int8[..., D], f32 scale[...])``.  The reference's operation order
    (``amax = max|x| + 1e-8``, ``round(x / amax · 127)``, scale
    ``amax / 127``) — not the activation quantizer's — so the codes match it
    bit for bit."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1) + 1e-8
    q = torch.clamp(torch.round(xf / amax[..., None] * 127.0), -127, 127)
    return q.to(torch.int8), amax / 127.0


# ===================================================================== MLA ==
def init_mla(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    m, d, h, dt = cfg.mla, cfg.d_model, cfg.num_heads, cfg.tdtype
    dev = gen.device
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": L.init_linear(gen, d, m.q_lora_rank, dt),
        "norm_q": L.init_norm(m.q_lora_rank, dt, dev),
        "wq_b": L.init_linear(gen, m.q_lora_rank, h * qk_dim, dt),
        "wkv_a": L.init_linear(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                               dt),
        "norm_kv": L.init_norm(m.kv_lora_rank, dt, dev),
        "wkv_b": L.init_linear(gen, m.kv_lora_rank,
                               h * (m.qk_nope_head_dim + m.v_head_dim), dt),
        "wo": L.init_linear(gen, h * m.v_head_dim, d, dt),
    }


def _mla_q(p, x, positions, cfg: ModelConfig):
    m = cfg.mla
    b, t, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = L.apply_linear(p["wq_a"], x, act=cfg.act_kernel)
    q = L.apply_norm(p["norm_q"], q)
    q = L.apply_linear(p["wq_b"], q, act=cfg.act_kernel).reshape(
        b, t, cfg.num_heads, qk)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, L.apply_rope(q_pe, positions, theta=cfg.rope_theta)


def _mla_latent(p, x, positions, cfg: ModelConfig):
    m = cfg.mla
    kv = L.apply_linear(p["wkv_a"], x, act=cfg.act_kernel)
    ckv, k_pe = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    ckv = L.apply_norm(p["norm_kv"], ckv)
    k_pe = L.apply_rope(k_pe[:, :, None, :], positions,
                        theta=cfg.rope_theta)[:, :, 0, :]
    return ckv, k_pe


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_prefill(p, x, positions, cfg: ModelConfig, *, causal: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expanded MLA over a full sequence (calibration / teacher-forced
    forward): ``wkv_b`` re-inflates per-head keys and values and
    :func:`chunked_attention` attends them (``dh = nope + rope`` for q/k,
    ``v_head_dim`` for v); returns the latent as the cache."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    q_nope, q_pe = _mla_q(p, x, positions, cfg)
    ckv, k_pe = _mla_latent(p, x, positions, cfg)
    kvb = L.apply_linear(p["wkv_b"], ckv, act=cfg.act_kernel).reshape(
        b, t, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvb[..., :m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand_as(q_pe)], dim=-1)
    out = chunked_attention(q, k, v, positions, positions, causal=causal)
    y = L.apply_linear(p["wo"], out.reshape(b, t, -1), act=cfg.act_kernel)
    lens = torch.full((b,), t, dtype=torch.int32, device=x.device)
    return y, {"ckv": ckv, "kpe": k_pe, "lens": lens}


def _mla_absorb_weights(p, cfg: ModelConfig):
    """Split an *fp* ``wkv_b`` into the absorbed key / value projections
    ``(w_k[r, H, nope], w_v[r, H, v])``.  Quantized params never take this
    path: PTQ derives the int4 pair ``p["wkv_b_absorbed"]``
    (``core/apply.py:_mla_absorbed_quantize``) and the grouped kernel
    contracts it; ``wkv_b`` itself is never dequantized to serve."""
    m = cfg.mla
    w = p["wkv_b"]["w"]
    if isinstance(w, QuantizedTensor):
        raise TypeError(
            "quantized MLA needs p['wkv_b_absorbed'] (the int4 absorbed pair "
            "from core.apply.quantize_params); wkv_b is not dequantized on "
            "the serving path")
    w = w.reshape(m.kv_lora_rank, cfg.num_heads,
                  m.qk_nope_head_dim + m.v_head_dim)
    return w[..., :m.qk_nope_head_dim], w[..., m.qk_nope_head_dim:]


def _mla_absorb_q_lat(p, q_nope1, cfg: ModelConfig) -> torch.Tensor:
    """``q_lat[N, H, r] = q_nope[N, H, nope] · w_k``: the heads ride the
    grouped kernel's expert axis (B6) when the pair is int4."""
    if "wkv_b_absorbed" in p:
        x = q_nope1.to(torch.float32).transpose(0, 1).contiguous()
        return kops.w4a16_grouped_matmul(
            x, p["wkv_b_absorbed"]["wk_t"], act=cfg.act_kernel).transpose(0, 1)
    w_k, _ = _mla_absorb_weights(p, cfg)
    return torch.einsum("bhn,rhn->bhr", q_nope1.to(torch.float32),
                        w_k.to(torch.float32))


def _mla_absorb_out(p, o_lat, cfg: ModelConfig) -> torch.Tensor:
    """``out[N, H, v] = o_lat[N, H, r] · w_v`` — the same head-as-expert
    grouped contraction for the int4 pair."""
    if "wkv_b_absorbed" in p:
        x = o_lat.to(torch.float32).transpose(0, 1).contiguous()
        return kops.w4a16_grouped_matmul(
            x, p["wkv_b_absorbed"]["wv"], act=cfg.act_kernel).transpose(0, 1)
    _, w_v = _mla_absorb_weights(p, cfg)
    return torch.einsum("bhr,rhv->bhv", o_lat.to(torch.float32),
                        w_v.to(torch.float32))


def _mla_absorbed_attend(p, q_nope, q_pe, ckv, kpe, valid, cfg: ModelConfig):
    """The gather oracle of one query token: absorbed-form attention against
    gathered latent rows ``ckv[B, S, r]`` / ``kpe[B, S, dr]`` with mask
    ``valid[B, S]`` → ``[B, 1, H·v]``."""
    b = q_nope.shape[0]
    q_lat = _mla_absorb_q_lat(p, q_nope[:, 0], cfg)
    ckv = ckv.to(torch.float32)
    sc = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
          + torch.einsum("bhd,bsd->bhs", q_pe[:, 0].to(torch.float32),
                         kpe.to(torch.float32))) * _mla_scale(cfg)
    sc = torch.where(valid[:, None, :], sc, torch.full_like(sc, NEG_INF))
    o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(sc, dim=-1), ckv)
    return _mla_absorb_out(p, o_lat, cfg).reshape(b, 1, -1)


def mla_prefill_chunk(p, x, pool, table_rows, start_len, chunk_len,
                      cfg: ModelConfig):
    """Chunked MLA prefill against the paged latent pools, absorbed form
    (the chunk contract of :func:`gqa_prefill_chunk`): the chunk's latents
    are written into the pages first; attention reads the start_len prefix
    rows from the pools and the chunk's own latents raw.  Returns (y,
    pool)."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    positions = _chunk_positions(start_len, t)
    q_nope, q_pe = _mla_q(p, x, positions, cfg)
    ckv_suf, kpe_suf = _mla_latent(p, x, positions, cfg)
    _scatter_chunk(pool, {"ckv": ckv_suf, "kpe": kpe_suf}, table_rows,
                   start_len, chunk_len, cfg.kv_quant)
    q_lat = _mla_absorb_q_lat(p, q_nope.reshape(b * t, h, -1),
                              cfg).reshape(b, t, h, -1)
    scale = _mla_scale(cfg)
    if cfg.paged_attn_impl == "auto":
        o_lat = kops.mla_paged_prefill(
            q_lat.contiguous(), q_pe.to(torch.float32).contiguous(),
            ckv_suf.contiguous(), kpe_suf.contiguous(), pool["ckv"],
            pool["kpe"], table_rows, start_len, chunk_len, pool.get("ckv_s"),
            pool.get("kpe_s"), sm_scale=scale)
    else:
        # dense gather + in-flight dequantization of the latent prefix, the
        # chunk raw — the kernel's masks
        pckv = _gathered_rows(pool, "ckv", table_rows, cfg.kv_quant)
        pkpe = _gathered_rows(pool, "kpe", table_rows, cfg.kv_quant)
        s = pckv.shape[1]
        ckv_all = torch.cat([pckv.to(torch.float32),
                             ckv_suf.to(torch.float32)], dim=1)
        kpe_all = torch.cat([pkpe.to(torch.float32),
                             kpe_suf.to(torch.float32)], dim=1)
        kpos_pre = torch.arange(s, device=x.device)[None].expand(b, s)
        k_pos = torch.cat([kpos_pre, positions], dim=1)
        k_valid = torch.cat(
            [kpos_pre < start_len.long()[:, None],
             torch.arange(t, device=x.device)[None, :]
             < chunk_len.long()[:, None]], dim=1)
        sc = (torch.einsum("bthr,bsr->bhts", q_lat.to(torch.float32), ckv_all)
              + torch.einsum("bthd,bsd->bhts", q_pe.to(torch.float32),
                             kpe_all)) * scale
        mask = k_valid[:, None, None, :] \
            & (k_pos[:, None, None, :] <= positions[:, None, :, None])
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        o_lat = torch.einsum("bhts,bsr->bthr", torch.softmax(sc, dim=-1),
                             ckv_all)
    out = _mla_absorb_out(p, o_lat.reshape(b * t, h, -1), cfg).reshape(
        b, t, h * m.v_head_dim)
    y = L.apply_linear(p["wo"], out.to(x.dtype).contiguous(),
                       act=cfg.act_kernel)
    return y, pool


def mla_decode_paged(p, x, positions, pool, table_rows, write_pos,
                     cfg: ModelConfig):
    """Absorbed-form decode against the paged latent pools (the page-table
    convention of :func:`gqa_decode_paged`).  Returns (y, pool)."""
    b = x.shape[0]
    q_nope, q_pe = _mla_q(p, x, positions, cfg)
    ckv_new, kpe_new = _mla_latent(p, x, positions, cfg)
    ps = pool["ckv"].shape[1]
    wp = write_pos.long()
    bidx = torch.arange(b, device=x.device)
    pg = table_rows.long()[bidx, wp // ps]
    off = wp % ps
    _store_rows(pool, "ckv", (pg, off), ckv_new[:, 0], cfg.kv_quant)
    _store_rows(pool, "kpe", (pg, off), kpe_new[:, 0], cfg.kv_quant)
    if cfg.paged_attn_impl == "auto":
        q_lat = _mla_absorb_q_lat(p, q_nope[:, 0], cfg)
        o_lat = kops.mla_paged_attention(
            q_lat.contiguous(), q_pe[:, 0].to(torch.float32).contiguous(),
            pool["ckv"], pool["kpe"], table_rows,
            (write_pos + 1).to(torch.int32), pool.get("ckv_s"),
            pool.get("kpe_s"), sm_scale=_mla_scale(cfg))
        out = _mla_absorb_out(p, o_lat, cfg).reshape(b, 1, -1)
    else:
        ckv = _gathered_rows(pool, "ckv", table_rows, cfg.kv_quant)
        kpe = _gathered_rows(pool, "kpe", table_rows, cfg.kv_quant)
        valid = torch.arange(ckv.shape[1], device=x.device)[None, :] \
            <= wp[:, None]
        out = _mla_absorbed_attend(p, q_nope, q_pe, ckv, kpe, valid, cfg)
    y = L.apply_linear(p["wo"], out.to(x.dtype), act=cfg.act_kernel)
    return y, pool


def init_mla_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                       device) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    shp = (num_pages, page_size)
    if cfg.kv_quant:
        return {"ckv": torch.zeros(*shp, m.kv_lora_rank, dtype=torch.int8,
                                   device=device),
                "kpe": torch.zeros(*shp, m.qk_rope_head_dim,
                                   dtype=torch.int8, device=device),
                "ckv_s": torch.zeros(shp, dtype=torch.float32, device=device),
                "kpe_s": torch.zeros(shp, dtype=torch.float32, device=device)}
    return {"ckv": torch.zeros(*shp, m.kv_lora_rank, dtype=cfg.tdtype,
                               device=device),
            "kpe": torch.zeros(*shp, m.qk_rope_head_dim, dtype=cfg.tdtype,
                               device=device)}
