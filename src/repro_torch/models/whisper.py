"""Whisper-style encoder-decoder (port of ``repro/models/whisper.py``).

The conv/mel frontend is a stub, as in the reference: requests carry frame
embeddings ``[T_enc, d_model]`` that feed the encoder directly.  Positions
are sinusoidal on both sides (the reference's documented deviation from
Whisper's learned decoder positions).

Params: ``{"enc": {"layers": [block, ...], "final_norm"}, "dec": {"embed":
{"table"}, "layers": [block, ...], "final_norm"}}``, one dict per layer
where the reference stacks ``[L, ...]``.  An encoder block is ``{"norm1",
"self_attn", "norm2", "mlp"}``, a decoder block adds ``"cross_attn"``
(q from the decoder, k/v from the encoder output) and ``"norm3"``; the
head is tied to the decoder's embedding.  Every linear goes through
``layers.apply_linear`` (the W4A16 kernel once quantized); the decoder's
self-attention is the paged GQA of ``models/attention.py`` (the paged
kernels), the encoder's is non-causal chunked attention, and cross
attention is a page gather plus two einsums at decode and chunked
attention at prefill, plain PyTorch ops as in the reference.

Caches: the contiguous cache (:func:`init_whisper_cache`) holds each decoder
layer's self-attention slab and its cross K/V ``xk``/``xv [B, T_enc, Hkv,
Dh]``.  The paged cache (:func:`init_whisper_paged_cache`) is ``{"layers":
[self-attention pool, ...], "enc": {"xk", "xv": [L, num_pages, page_size,
Hkv, Dh]}}``: the read-only encoder pool, written once per distinct audio
at admission (:func:`whisper_enc_kv`) and read through a slot's encoder
page table.  It stays at the model dtype under ``kv_quant``.

As in the reference, a generated token's embedding gets the sinusoid of
position 0 (:func:`whisper_decode`, :func:`whisper_decode_paged`), while
prompt tokens get their true positions; the port copies this quirk.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import mlp as M

Params = Dict[str, Any]


def _sin_cos(pos: torch.Tensor, d: int) -> torch.Tensor:
    """``[..., 1]`` f32 positions → ``[..., d]``: sines then cosines."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos * torch.exp(-dim * math.log(10000.0) / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid(t: int, d: int, offset: int = 0, device="cpu") -> torch.Tensor:
    """Sinusoidal embeddings of positions ``offset .. offset + t - 1``:
    ``[t, d]`` f32."""
    pos = torch.arange(offset, offset + t, dtype=torch.float32,
                       device=device)[:, None]
    return _sin_cos(pos, d)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """:func:`sinusoid` at per-row positions ``[B, T]`` → ``[B, T, d]``
    (chunked prefill, each slot at its own ``start_len``)."""
    return _sin_cos(positions.to(torch.float32)[..., None], d)


def init_whisper(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from ``gen`` (on ``gen``'s device)."""
    dt, dev, d = cfg.tdtype, gen.device, cfg.d_model

    def norm():
        return L.init_norm(d, dt, dev, cfg.norm)

    def enc_block():
        return {"norm1": norm(), "self_attn": A.init_gqa(gen, cfg),
                "norm2": norm(), "mlp": M.init_mlp(gen, cfg)}

    def dec_block():
        return {"norm1": norm(), "self_attn": A.init_gqa(gen, cfg),
                "norm2": norm(), "cross_attn": A.init_gqa(gen, cfg),
                "norm3": norm(), "mlp": M.init_mlp(gen, cfg)}

    return {"enc": {"layers": [enc_block() for _ in range(cfg.enc_layers)],
                    "final_norm": norm()},
            "dec": {"embed": L.init_embedding(gen, cfg.vocab_size, d, dt),
                    "layers": [dec_block() for _ in range(cfg.num_layers)],
                    "final_norm": norm()}}


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device)[None].expand(b, t)


def enc_block(lp: Params, x, pos, cfg: ModelConfig) -> torch.Tensor:
    """One encoder block: non-causal self-attention, then the GELU MLP."""
    h = L.apply_norm(lp["norm1"], x)
    y, _ = A.gqa_prefill(lp["self_attn"], h, pos, cfg, causal=False)
    x = x + y
    return x + M.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], x))


def encode(p: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = False) -> torch.Tensor:
    """frames ``[B, T_enc, D]`` → the encoder output ``[B, T_enc, D]``;
    ``remat`` recomputes each block in the backward pass."""
    b, t, d = frames.shape
    x = frames + sinusoid(t, d, device=frames.device).to(frames.dtype)[None]
    pos = _positions(b, t, frames.device)
    block = LM.checkpointed(lambda lp, x: enc_block(lp, x, pos, cfg), remat)
    for lp in p["enc"]["layers"]:
        x = block(lp, x)
    return L.apply_norm(p["enc"]["final_norm"], x)


def _cross_kv(lp: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross K/V ``[B, T_enc, Hkv, Dh]`` of the encoder
    output."""
    b, s, _ = enc_out.shape
    shp = (b, s, cfg.num_kv_heads, cfg.hdim)
    return (L.apply_linear(lp["cross_attn"]["wk"], enc_out).reshape(shp),
            L.apply_linear(lp["cross_attn"]["wv"], enc_out).reshape(shp))


def _cross_attend(lp: Params, x, xk, xv, cfg: ModelConfig, valid=None):
    """Non-causal cross attention of the decoder rows x ``[B, T, D]`` over
    encoder K/V rows (``valid[B, S]`` masks padding rows)."""
    b, t, _ = x.shape
    c = lp["cross_attn"]
    q = L.apply_linear(c["wq"], x).reshape(b, t, cfg.num_heads, cfg.hdim)
    zq = torch.zeros(b, t, dtype=torch.long, device=x.device)
    zk = torch.zeros(b, xk.shape[1], dtype=torch.long, device=x.device)
    out = A.chunked_attention(q, xk, xv, zq, zk, valid, causal=False)
    return L.apply_linear(c["wo"], out.reshape(b, t, -1))


def _cross_attend_one(lp: Params, x, xk, xv, cfg: ModelConfig, valid):
    """Cross attention of one decode token per row, x ``[B, 1, D]``."""
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    c = lp["cross_attn"]
    q = L.apply_linear(c["wq"], x).reshape(b, hkv, h // hkv, dh)
    o = A.attend_rows(q, xk, xv, valid, dh ** -0.5)
    return L.apply_linear(c["wo"], o.reshape(b, 1, h * dh).to(x.dtype))


def _dec_tail(lp: Params, x, cross) -> torch.Tensor:
    """A decoder block after its self-attention: cross attention
    (``cross(h)``), then the MLP."""
    x = x + cross(L.apply_norm(lp["norm2"], x))
    return x + M.apply_mlp(lp["mlp"], L.apply_norm(lp["norm3"], x))


def _dec_block(lp: Params, x, pos, enc_out, cfg: ModelConfig):
    """A full-sequence decoder block: (x, its self-attention KV, its cross
    K/V)."""
    h = L.apply_norm(lp["norm1"], x)
    y, kv = A.gqa_prefill(lp["self_attn"], h, pos, cfg)
    xk, xv = _cross_kv(lp, enc_out, cfg)
    x = _dec_tail(lp, x + y,
                  lambda hh: _cross_attend(lp, hh, xk, xv, cfg))
    return x, kv, (xk, xv)


def _embed(p: Params, tokens: torch.Tensor, sin: torch.Tensor):
    x = L.apply_embedding(p["dec"]["embed"], tokens)
    return x + sin.to(x.dtype)


def _head(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(p["dec"]["final_norm"], x)
    return L.logits_from_embedding(p["dec"]["embed"], x)


def whisper_forward(p: Params, frames: torch.Tensor, tokens: torch.Tensor,
                    cfg: ModelConfig, *, remat: bool = False
                    ) -> torch.Tensor:
    """Teacher-forced logits ``[B, T_dec, V]`` f32; ``remat`` recomputes
    each encoder and decoder block in the backward pass."""
    enc_out = encode(p, frames, cfg, remat=remat)
    b, t = tokens.shape
    x = _embed(p, tokens, sinusoid(t, cfg.d_model, device=tokens.device)[None])
    pos = _positions(b, t, tokens.device)
    block = LM.checkpointed(
        lambda lp, x: _dec_block(lp, x, pos, enc_out, cfg)[0], remat)
    for lp in p["dec"]["layers"]:
        x = block(lp, x)
    return _head(p, x)


def whisper_loss(p: Params, frames, tokens, labels, cfg: ModelConfig, *,
                 remat: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy in f32 (no aux term)."""
    return LM.cross_entropy(whisper_forward(p, frames, tokens, cfg,
                                            remat=remat), labels)


# ---------------------------------------------------- contiguous cache ---
def init_whisper_cache(cfg: ModelConfig, batch: int, smax: int, enc_len: int,
                       device) -> Any:
    """Per decoder layer: the self-attention slab and the cross K/V rows
    ``xk``/``xv [B, enc_len, Hkv, Dh]``, computed once at prefill."""
    shp = (batch, enc_len, cfg.num_kv_heads, cfg.hdim)
    return {"layers": [
        {"self": A.init_gqa_cache(cfg, batch, smax, device),
         "xk": torch.zeros(shp, dtype=cfg.tdtype, device=device),
         "xv": torch.zeros(shp, dtype=cfg.tdtype, device=device)}
        for _ in range(cfg.num_layers)]}


def whisper_prefill(p: Params, frames, tokens, cfg: ModelConfig, smax: int
                    ) -> Tuple[torch.Tensor, Any]:
    """Encode, prefill the prompt and build the contiguous cache padded to
    ``smax``: (last-token logits [B, V], cache)."""
    enc_out = encode(p, frames, cfg)
    b, t = tokens.shape
    cache = init_whisper_cache(cfg, b, smax, enc_out.shape[1], tokens.device)
    x = _embed(p, tokens, sinusoid(t, cfg.d_model, device=tokens.device)[None])
    pos = _positions(b, t, tokens.device)
    for lp, ct in zip(p["dec"]["layers"], cache["layers"]):
        x, kv, (xk, xv) = _dec_block(lp, x, pos, enc_out, cfg)
        A.pad_kv(ct["self"], kv, cfg)
        ct["xk"].copy_(xk)
        ct["xv"].copy_(xv)
    return _head(p, x[:, t - 1:])[:, 0], cache


def whisper_decode(p: Params, token, cache, position, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Any]:
    """One decode step against the contiguous cache (the slabs written in
    place).  The embedding gets position 0's sinusoid, as in the
    reference."""
    x = _embed(p, token, sinusoid(1, cfg.d_model, device=token.device)[None])
    pos = position[:, None]
    for lp, ct in zip(p["dec"]["layers"], cache["layers"]):
        h = L.apply_norm(lp["norm1"], x)
        y, _ = A.gqa_decode(lp["self_attn"], h, pos, ct["self"], cfg)
        valid = torch.ones(ct["xk"].shape[:2], dtype=torch.bool,
                           device=x.device)
        x = _dec_tail(lp, x + y, lambda hh: _cross_attend_one(
            lp, hh, ct["xk"], ct["xv"], cfg, valid))
    return _head(p, x)[:, 0], cache


# --------------------------------------------------------- paged serving ---
def init_whisper_paged_cache(cfg: ModelConfig, num_pages: int,
                             page_size: int, device) -> Any:
    """Per decoder layer a self-attention page pool (int8 under
    ``kv_quant``), plus the read-only encoder pool ``{"xk", "xv": [L,
    num_pages, page_size, Hkv, Dh]}`` at the model dtype: its pages are
    written once and never rescattered.  Page 0 is the trash page; its zero
    rows are softmax-safe because the decode masks them through
    ``enc_len``."""
    eshp = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
            cfg.hdim)
    return {"layers": [A.init_gqa_page_pool(cfg, num_pages, page_size, device)
                       for _ in range(cfg.num_layers)],
            "enc": {k: torch.zeros(eshp, dtype=cfg.tdtype, device=device)
                    for k in ("xk", "xv")}}


def whisper_enc_kv(p: Params, frames: torch.Tensor, cfg: ModelConfig):
    """Run the encoder once and project every decoder layer's cross K/V:
    ``{"xk"/"xv": [L, B, T_enc, Hkv, Dh]}``, the rows the engine scatters
    into the encoder pool at admission."""
    enc_out = encode(p, frames, cfg)
    kv = [_cross_kv(lp, enc_out, cfg) for lp in p["dec"]["layers"]]
    return {"xk": torch.stack([k for k, _ in kv]),
            "xv": torch.stack([v for _, v in kv])}


def gather_enc(exk, exv, enc_table, enc_len):
    """A slot's encoder rows from one layer's encoder pool ``[num_pages, ps,
    Hkv, Dh]`` in logical order, ``[B, P·ps, Hkv, Dh]``, and their valid
    mask.  ``enc_len`` is clamped to at least 1, so a row whose slot holds
    no encoder pages (the trash table) sees one valid zero row and its
    masked softmax stays finite."""
    xk = A.gather_pages(exk, enc_table)
    xv = A.gather_pages(exv, enc_table)
    s = xk.shape[1]
    valid = torch.arange(s, device=xk.device)[None, :] \
        < torch.clamp_min(enc_len.long(), 1)[:, None]
    return xk, xv, valid


def whisper_decode_paged(p: Params, token, cache, position, table_rows,
                         enc_table, enc_len, cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, Any]:
    """One decode step against the paged self-attention pools (written in
    place) and the read-only encoder pages: token[B, 1] at position[B] →
    (logits [B, V], pools).  The contiguous step's numerics, its
    position-0 sinusoid included."""
    x = _embed(p, token, sinusoid(1, cfg.d_model, device=token.device)[None])
    pos = position[:, None]
    enc = cache["enc"]
    for i, (lp, pool) in enumerate(zip(p["dec"]["layers"], cache["layers"])):
        h = L.apply_norm(lp["norm1"], x)
        y, _ = A.gqa_decode_paged(lp["self_attn"], h, pos, pool, table_rows,
                                  position, cfg)
        xk, xv, valid = gather_enc(enc["xk"][i], enc["xv"][i], enc_table,
                                   enc_len)
        x = _dec_tail(lp, x + y, lambda hh: _cross_attend_one(
            lp, hh, xk, xv, cfg, valid))
    return _head(p, x)[:, 0], cache


def whisper_prefill_chunk(p: Params, tokens, cache, start_len, chunk_len,
                          table_rows, enc_table, enc_len, cfg: ModelConfig,
                          *, last_idx=None) -> Tuple[torch.Tensor, Any]:
    """Chunked decoder prefill: the self-attention KV goes into the slot's
    pages (``attention.gqa_prefill_chunk``), cross attention reads the
    slot's encoder pages.  Prompt tokens take their true positions
    ``start_len + t``.  Returns (logits at ``last_idx`` per row, the last
    position when None; pools)."""
    b, t = tokens.shape
    positions = start_len.long()[:, None] + torch.arange(
        t, device=tokens.device)[None, :]
    x = _embed(p, tokens, sinusoid_at(positions, cfg.d_model))
    enc = cache["enc"]
    for i, (lp, pool) in enumerate(zip(p["dec"]["layers"], cache["layers"])):
        h = L.apply_norm(lp["norm1"], x)
        y, _ = A.gqa_prefill_chunk(lp["self_attn"], h, pool, table_rows,
                                   start_len, chunk_len, cfg)
        xk, xv, valid = gather_enc(enc["xk"][i], enc["xv"][i], enc_table,
                                   enc_len)
        x = _dec_tail(lp, x + y, lambda hh: _cross_attend(
            lp, hh, xk, xv, cfg, valid))
    idx = (last_idx.long() if last_idx is not None
           else torch.full((b,), t - 1, dtype=torch.long, device=x.device))
    x_last = x[torch.arange(b, device=x.device), idx][:, None]
    return _head(p, x_last)[:, 0], cache
