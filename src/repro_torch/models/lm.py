"""Decoder-only LM, dense and MoE (port of ``repro/models/lm.py``).

Params: ``{"embed": {"table"}, "final_norm": {"scale"[, "bias"]},
"lm_head": {"w"}, "layers": [block, ...]}`` — one dict per layer (norms of
``cfg.norm``), walked by a Python loop
where the reference ``lax.scan``s over ``[L, ...]`` stacks.  With
``cfg.tie_embeddings`` there is no ``lm_head``: the logits are
``norm(x) @ table.T``.  A MoE block's ``"mlp"`` is the router and the
stacked experts (``models/mlp.py``).  ``cfg.mixer`` picks GQA or MLA
(``models/attention.py``).  Paged caches are ``{"layers": [pool, ...]}``,
one pool per layer, updated in place: ``{"k", "v"}`` for GQA, the latent
``{"ckv", "kpe"}`` for MLA, plus their ``*_s`` scales under
``kv_quant``.  Every linear gets ``act=cfg.act_kernel``.  ``embeds``
(the VLM family's patch-embedding stub, ``[B, n, D]``) is added to the
token embeddings of the first n positions, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M

Params = Dict[str, Any]


def _init_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt, dev = cfg.tdtype, gen.device
    return {"norm1": L.init_norm(cfg.d_model, dt, dev, cfg.norm),
            "mixer": (A.init_mla(gen, cfg) if cfg.mixer == "mla"
                      else A.init_gqa(gen, cfg)),
            "norm2": L.init_norm(cfg.d_model, dt, dev, cfg.norm),
            "mlp": M.init_moe(gen, cfg) if cfg.moe else M.init_mlp(gen, cfg)}


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from ``gen`` (on ``gen``'s device)."""
    dt = cfg.tdtype
    p = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
         "final_norm": L.init_norm(cfg.d_model, dt, gen.device, cfg.norm)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size, dt)
    p["layers"] = [_init_block(gen, cfg) for _ in range(cfg.num_layers)]
    return p


def _channel_mix(p: Params, h: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The block's MLP: the MoE (its aux loss dropped: the port does not
    train) or the dense SwiGLU."""
    if cfg.moe is not None:
        return M.apply_moe(p["mlp"], h, cfg)[0]
    return M.apply_mlp(p["mlp"], h, act=cfg.act_kernel)


def _block_forward(p: Params, x, positions, cfg: ModelConfig):
    h = L.apply_norm(p["norm1"], x)
    prefill = A.mla_prefill if cfg.mixer == "mla" else A.gqa_prefill
    y, _ = prefill(p["mixer"], h, positions, cfg)
    x = x + y
    return x + _channel_mix(p, L.apply_norm(p["norm2"], x), cfg)


def _block_prefill_chunk(p, x, start_len, chunk_len, pool, table_rows, cfg):
    h = L.apply_norm(p["norm1"], x)
    chunk = A.mla_prefill_chunk if cfg.mixer == "mla" \
        else A.gqa_prefill_chunk
    y, pool = chunk(p["mixer"], h, pool, table_rows, start_len, chunk_len,
                    cfg)
    x = x + y
    return x + _channel_mix(p, L.apply_norm(p["norm2"], x), cfg), pool


def _block_decode_paged(p, x, rope_pos, write_pos, pool, table_rows, cfg):
    h = L.apply_norm(p["norm1"], x)
    decode = A.mla_decode_paged if cfg.mixer == "mla" \
        else A.gqa_decode_paged
    y, pool = decode(p["mixer"], h, rope_pos, pool, table_rows, write_pos,
                     cfg)
    x = x + y
    return x + _channel_mix(p, L.apply_norm(p["norm2"], x), cfg), pool


def embed_in(p: Params, tokens: torch.Tensor,
             embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, plus the precomputed patch embeddings ``embeds[B,
    n, D]`` at the first n positions (tokens there are pad)."""
    x = L.apply_embedding(p["embed"], tokens)
    if embeds is not None:
        n = embeds.shape[1]
        x = torch.cat([x[:, :n] + embeds.to(x.dtype), x[:, n:]], dim=1)
    return x


def _lm_head(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm + fp head (the head stays unquantized), f32 logits; the
    tied head reads the embedding table."""
    x = L.apply_norm(p["final_norm"], x)
    if cfg.tie_embeddings:
        return L.logits_from_embedding(p["embed"], x)
    return torch.matmul(x.to(torch.float32),
                        p["lm_head"]["w"].to(torch.float32))


def lm_forward(p: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
               positions: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced forward: tokens[B, T] → logits[B, T, V] f32."""
    b, t = tokens.shape[:2]
    if positions is None:
        positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    x = embed_in(p, tokens, embeds)
    for lp in p["layers"]:
        x = _block_forward(lp, x, positions, cfg)
    return _lm_head(p, x, cfg)


def lm_prefill_chunk(p: Params, tokens, cache, start_len, chunk_len,
                     table_rows, cfg: ModelConfig, *, last_idx=None,
                     embeds=None) -> Tuple[torch.Tensor, Any]:
    """One [B, T] prompt chunk per slot, KV written straight into the paged
    pools; returns the logits at ``last_idx`` per row (meaningful on a
    prompt's final chunk) and the pools."""
    b, t = tokens.shape[:2]
    x = embed_in(p, tokens, embeds)
    for lp, pool in zip(p["layers"], cache["layers"]):
        x, _ = _block_prefill_chunk(lp, x, start_len, chunk_len, pool,
                                    table_rows, cfg)
    if last_idx is None:
        last_idx = torch.full((b,), t - 1, dtype=torch.long, device=x.device)
    x_last = x[torch.arange(b, device=x.device), last_idx.long()][:, None]
    return _lm_head(p, x_last, cfg)[:, 0], cache


def lm_decode_paged(p: Params, token, cache, position, table_rows,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """One decode step: token[B, 1] at position[B] → (logits[B, V], pools).
    M-RoPE's three streams are views of ``position`` (no copy, so the
    decode CUDA graph captures them)."""
    x = L.apply_embedding(p["embed"], token)
    pos = position[:, None]
    if cfg.rope == "mrope":
        pos = pos[None].expand(3, *pos.shape)
    for lp, pool in zip(p["layers"], cache["layers"]):
        x, _ = _block_decode_paged(lp, x, pos, position, pool, table_rows,
                                   cfg)
    return _lm_head(p, x, cfg)[:, 0], cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> Any:
    init = A.init_mla_page_pool if cfg.mixer == "mla" \
        else A.init_gqa_page_pool
    return {"layers": [init(cfg, num_pages, page_size, device)
                       for _ in range(cfg.num_layers)]}
