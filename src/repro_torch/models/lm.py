"""Decoder-only LM (port of ``repro/models/lm.py``): dense, MoE, hybrid
(Zamba2) and RWKV6 stacks.

Params: ``{"embed": {"table"}, "final_norm": {"scale"[, "bias"]},
"lm_head": {"w"}, "layers": [block, ...]}`` — one dict per layer (norms of
``cfg.norm``), walked by a Python loop where the reference ``lax.scan``s
over ``[L, ...]`` stacks.  With ``cfg.tie_embeddings`` there is no
``lm_head``: the logits are ``norm(x) @ table.T``.  A MoE block's ``"mlp"``
is the router and the stacked experts (``models/mlp.py``).  ``cfg.mixer``
picks GQA or MLA (``models/attention.py``), or the sub-quadratic mixers of
``models/ssm.py``: an RWKV6 block has the time mix and the channel mix
(``"mlp"``), a Mamba2 block its mixer only.

The hybrid stack (``cfg.family == "hybrid"``) keeps the reference's names:
``"groups"`` (``[g][k]`` Mamba2 blocks), one weight-shared attention +
MLP block ``"shared"`` applied after each group, and ``"tail"`` (the
remainder Mamba2 blocks, absent when there are none).

Paged caches are ``{"layers": [pool, ...]}``, one pool per layer (per
group for the hybrid's shared attention), updated in place: ``{"k", "v"}``
for GQA, the latent ``{"ckv", "kpe"}`` for MLA, plus their ``*_s`` scales
under ``kv_quant``.  A hybrid slot's Mamba2 state lives beside them in the
fixed-rows tree of :func:`init_fixed_state`.  The contiguous decode cache
(:func:`init_cache`, :func:`lm_prefill`, :func:`lm_decode`) holds GQA slabs,
MLA's latent slabs, hybrid and RWKV6 state.  Every linear gets
``act=cfg.act_kernel``.  Training reads :func:`lm_forward_aux` (the logits
and the MoE aux loss summed over layers) through :func:`lm_loss`; with
``remat`` each block (the hybrid stack: each Mamba2 block and each group)
is recomputed in the backward pass, as the reference wraps the same bodies
in ``jax.checkpoint``.  ``embeds`` (the VLM family's patch-embedding
stub, ``[B, n, D]``) is added to the token embeddings of the first n
positions, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import ssm as S
from repro_torch.serving.trace import span

Params = Dict[str, Any]


def _init_mixer(gen: torch.Generator, cfg: ModelConfig, mixer: str):
    if mixer == "mla":
        return A.init_mla(gen, cfg)
    if mixer == "mamba2":
        return S.init_mamba2(gen, cfg)
    if mixer == "rwkv6":
        return S.init_rwkv6(gen, cfg)
    return A.init_gqa(gen, cfg)


def _init_block(gen: torch.Generator, cfg: ModelConfig,
                mixer: Optional[str] = None) -> Params:
    """One decoder block; ``mixer`` overrides ``cfg.mixer`` (the hybrid
    stack's shared attention).  A Mamba2 block has no MLP."""
    mixer = mixer or cfg.mixer
    dt, dev = cfg.tdtype, gen.device
    p = {"norm1": L.init_norm(cfg.d_model, dt, dev, cfg.norm),
         "mixer": _init_mixer(gen, cfg, mixer)}
    if mixer in ("attention", "mla"):
        p["norm2"] = L.init_norm(cfg.d_model, dt, dev, cfg.norm)
        p["mlp"] = M.init_moe(gen, cfg) if cfg.moe else M.init_mlp(gen, cfg)
    elif mixer == "rwkv6":
        p["norm2"] = L.init_norm(cfg.d_model, dt, dev, cfg.norm)
        p["mlp"] = S.init_rwkv_channel_mix(gen, cfg)
    return p


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups g, Mamba2 blocks per group k, tail blocks)."""
    k = cfg.hybrid.attn_every
    g = cfg.num_layers // k
    return g, k, cfg.num_layers - g * k


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from ``gen`` (on ``gen``'s device)."""
    dt = cfg.tdtype
    p = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
         "final_norm": L.init_norm(cfg.d_model, dt, gen.device, cfg.norm)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size, dt)
    if cfg.family == "hybrid":
        g, k, tail = hybrid_layout(cfg)
        p["groups"] = [[_init_block(gen, cfg) for _ in range(k)]
                       for _ in range(g)]
        p["shared"] = _init_block(gen, cfg.with_(moe=None), "attention")
        if tail:
            p["tail"] = [_init_block(gen, cfg) for _ in range(tail)]
    else:
        p["layers"] = [_init_block(gen, cfg) for _ in range(cfg.num_layers)]
    return p


def _mlp_aux(p: Params, h: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's MLP and its aux loss: the MoE and its load-balancing
    loss, or the dense MLP and None."""
    if cfg.moe is not None:
        return M.apply_moe(p["mlp"], h, cfg)
    return M.apply_mlp(p["mlp"], h, act=cfg.act_kernel), None


def _channel_mix(p: Params, h: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The block's MLP in a serving step (the MoE's aux loss dropped)."""
    return _mlp_aux(p, h, cfg)[0]


def _shift(h: torch.Tensor) -> torch.Tensor:
    """h[B, T, D] shifted one step later in time, zeros first."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def _block_forward(p: Params, x, positions, cfg: ModelConfig, *,
                   mixer: Optional[str] = None, state: bool = False):
    """Full-sequence block (calibration, teacher-forced forward, the
    contiguous prefill).  With ``state`` it also returns the mixer's cache
    or recurrent state for :func:`_block_decode`."""
    x, st, _ = _block_full(p, x, positions, cfg, mixer)
    return (x, st) if state else x


def _block_full(p: Params, x, positions, cfg: ModelConfig,
                mixer: Optional[str] = None):
    """:func:`_block_forward`'s body: (x, the mixer's cache or state, the
    MoE aux loss or None)."""
    mixer = mixer or cfg.mixer
    aux = None
    h = L.apply_norm(p["norm1"], x)
    if mixer == "mamba2":
        y, st = S.mamba2_forward(p["mixer"], h, cfg, return_state=True)
    elif mixer == "rwkv6":
        y, st = S.rwkv6_forward(p["mixer"], h, cfg, return_state=True)
    else:
        prefill = A.mla_prefill if mixer == "mla" else A.gqa_prefill
        y, st = prefill(p["mixer"], h, positions, cfg)
    x = x + y
    if "mlp" in p:
        h2 = L.apply_norm(p["norm2"], x)
        if mixer == "rwkv6":
            x = x + S.rwkv_channel_mix(p["mlp"], h2, _shift(h2), cfg)
            st = dict(st, ffn_prev=h2[:, -1])
        else:
            y2, aux = _mlp_aux(p, h2, cfg)
            x = x + y2
    return x, st, aux


def _block_decode(p: Params, x, positions, cache, cfg: ModelConfig, *,
                  mixer: Optional[str] = None):
    """One-token block against its contiguous cache or recurrent state."""
    mixer = mixer or cfg.mixer
    h = L.apply_norm(p["norm1"], x)
    if mixer == "mamba2":
        y, cache = S.mamba2_decode(p["mixer"], h, cache, cfg)
    elif mixer == "rwkv6":
        y, tc = S.rwkv6_decode(p["mixer"], h, cache, cfg)
        cache = dict(tc, ffn_prev=cache["ffn_prev"])
    elif mixer == "mla":
        y, cache = A.mla_decode(p["mixer"], h, positions, cache, cfg)
    else:
        y, cache = A.gqa_decode(p["mixer"], h, positions, cache, cfg)
    x = x + y
    if "mlp" in p:
        h2 = L.apply_norm(p["norm2"], x)
        if mixer == "rwkv6":
            x = x + S.rwkv_channel_mix(p["mlp"], h2,
                                       cache["ffn_prev"][:, None, :], cfg)
            cache = dict(cache, ffn_prev=h2[:, 0])
        else:
            x = x + _channel_mix(p, h2, cfg)
    return x, cache


def _block_prefill_chunk(p, x, start_len, chunk_len, pool, table_rows, cfg):
    # the spans tile the block, so that the device's idle gaps in an eager
    # chunk fall on a sub-layer of the trace
    with span("model.attn"):
        h = L.apply_norm(p["norm1"], x)
        chunk = A.mla_prefill_chunk if cfg.mixer == "mla" \
            else A.gqa_prefill_chunk
        y, pool = chunk(p["mixer"], h, pool, table_rows, start_len,
                        chunk_len, cfg)
        x = x + y
    with span("model.ffn"):
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


def _head_at(p: Params, x, last_idx, cfg: ModelConfig) -> torch.Tensor:
    """Logits [B, V] at ``last_idx[b]`` of each row (the last position when
    None)."""
    with span("model.head"):
        b, t = x.shape[:2]
        if last_idx is None:
            return _lm_head(p, x[:, t - 1:], cfg)[:, 0]
        x_last = x[torch.arange(b, device=x.device),
                   last_idx.long()][:, None]
        return _lm_head(p, x_last, cfg)[:, 0]


def lm_forward(p: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
               positions: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced forward: tokens[B, T] → logits[B, T, V] f32."""
    return lm_forward_aux(p, tokens, cfg, positions=positions,
                          embeds=embeds)[0]


def checkpointed(fn, on: bool):
    """``fn`` recomputed in the backward pass (``jax.checkpoint``'s
    counterpart) when ``on``."""
    if not on:
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def lm_forward_aux(p: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None,
                   remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward for training: (logits[B, T, V] f32, the MoE
    aux loss summed over layers, an f32 scalar; 0 without MoE).  ``remat``
    recomputes each block in the backward pass (the hybrid stack: each
    Mamba2 block, and each group around them)."""
    b, t = tokens.shape[:2]
    if positions is None:
        positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    x = embed_in(p, tokens, embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        scfg = cfg.with_(moe=None)
        mamba = checkpointed(
            lambda lp, x: _block_full(lp, x, positions, cfg)[0], remat)

        def group_body(group, x):
            for lp in group:
                x = mamba(lp, x)
            return _block_full(p["shared"], x, positions, scfg,
                               "attention")[0]

        group = checkpointed(group_body, remat)
        for gp in p["groups"]:
            x = group(gp, x)
        for lp in p.get("tail", ()):
            x = mamba(lp, x)
    else:
        def body(lp, x):
            x, _, a = _block_full(lp, x, positions, cfg)
            return x, a

        body = checkpointed(body, remat)
        for lp in p["layers"]:
            x, a = body(lp, x)
            if a is not None:
                aux = aux + a
    return _lm_head(p, x, cfg), aux


def lm_loss(p: Params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, *, positions=None, embeds=None,
            remat: bool = False, aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross entropy in f32 plus ``aux_weight`` times the
    MoE aux loss."""
    logits, aux = lm_forward_aux(p, tokens, cfg, positions=positions,
                                 embeds=embeds, remat=remat)
    return cross_entropy(logits, labels) + aux_weight * aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """``mean(logsumexp − gold)`` in f32.  The gold logit is gathered: the
    reference reduces a one-hot instead, the same math, chosen there only
    so that vocab-sharded logits reduce locally."""
    logits = logits.to(torch.float32)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


# ---------------------------------------------------- contiguous cache ---
def _one_state(cfg: ModelConfig, batch: int, device):
    if cfg.mixer == "mamba2":
        return S.init_mamba2_state(cfg, batch, device)
    st = S.init_rwkv6_state(cfg, batch, device)
    st["ffn_prev"] = torch.zeros(batch, cfg.d_model, dtype=cfg.tdtype,
                                 device=device)
    return st


def init_cache(cfg: ModelConfig, batch: int, smax: int, device) -> Any:
    """The contiguous decode cache: GQA ``[B, smax]`` slabs per layer
    (int8 codes + scales under ``kv_quant``), MLA's latent ``ckv`` / ``kpe``
    slabs per layer, recurrent state per RWKV6
    layer, and for the hybrid stack ``{"groups": [g][k] Mamba2 states,
    "shared": [g] GQA slabs, "tail": [tail] states or None}``."""
    if cfg.family == "hybrid":
        g, k, tail = hybrid_layout(cfg)
        return {"groups": [[_one_state(cfg, batch, device) for _ in range(k)]
                           for _ in range(g)],
                "shared": [A.init_gqa_cache(cfg, batch, smax, device)
                           for _ in range(g)],
                "tail": ([_one_state(cfg, batch, device)
                          for _ in range(tail)] if tail else None)}
    if cfg.mixer == "mla":
        return {"layers": [A.init_mla_cache(cfg, batch, smax, device)
                           for _ in range(cfg.num_layers)]}
    if cfg.mixer == "attention":
        return {"layers": [A.init_gqa_cache(cfg, batch, smax, device)
                           for _ in range(cfg.num_layers)]}
    return {"layers": [_one_state(cfg, batch, device)
                       for _ in range(cfg.num_layers)]}


def lm_prefill(p: Params, tokens: torch.Tensor, cfg: ModelConfig, smax: int,
               *, embeds=None, last_idx=None) -> Tuple[torch.Tensor, Any]:
    """Process a prompt and build the contiguous decode cache padded to
    ``smax``: last-token logits [B, V] and the cache.  ``last_idx[B]``
    gathers each row's logits at its real last token (right-padded rows;
    causal masking keeps the padding out of the valid prefix's KV, but a
    recurrent state runs through it, so callers batch RWKV6 prompts of one
    length, as the reference's do).  Hybrid stacks do not take it."""
    b, t = tokens.shape[:2]
    if last_idx is not None and cfg.family == "hybrid":
        raise NotImplementedError("bucketed prefill not wired for hybrid")
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    x = embed_in(p, tokens, embeds)
    dev = x.device
    if cfg.family == "hybrid":
        cache = init_cache(cfg, b, smax, dev)
        scfg = cfg.with_(moe=None)
        groups = []
        for gi, group in enumerate(p["groups"]):
            sts = []
            for lp in group:
                x, st = _block_forward(lp, x, positions, cfg, state=True)
                sts.append(st)
            groups.append(sts)
            x, new = _block_forward(p["shared"], x, positions, scfg,
                                    mixer="attention", state=True)
            A.pad_kv(cache["shared"][gi], new, cfg)
        cache["groups"] = groups
        if "tail" in p:
            cache["tail"] = []
            for lp in p["tail"]:
                x, st = _block_forward(lp, x, positions, cfg, state=True)
                cache["tail"].append(st)
        return _lm_head(p, x[:, t - 1:], cfg)[:, 0], cache
    slabs = (None if cfg.mixer not in ("attention", "mla")
             else init_cache(cfg, b, smax, dev)["layers"])
    layers = []
    for i, lp in enumerate(p["layers"]):
        x, new = _block_forward(lp, x, positions, cfg, state=True)
        layers.append(new if slabs is None else A.pad_kv(slabs[i], new, cfg))
    return _head_at(p, x, last_idx, cfg), {"layers": layers}


def lm_decode(p: Params, token: torch.Tensor, cache: Any,
              position: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Any]:
    """One decode step against the contiguous cache: token[B, 1] at
    position[B] → (logits [B, V], cache).  GQA slabs are written in place;
    recurrent states come back as new tensors."""
    pos = position[:, None]
    if cfg.rope == "mrope":
        pos = pos[None].expand(3, *pos.shape)
    x = L.apply_embedding(p["embed"], token)
    if cfg.family == "hybrid":
        scfg = cfg.with_(moe=None)
        groups, shared = [], []
        for group, gst, sc in zip(p["groups"], cache["groups"],
                                  cache["shared"]):
            new = []
            for lp, st in zip(group, gst):
                x, st = _block_decode(lp, x, pos, st, cfg)
                new.append(st)
            groups.append(new)
            x, sc = _block_decode(p["shared"], x, pos, sc, scfg,
                                  mixer="attention")
            shared.append(sc)
        tail = cache["tail"]
        if "tail" in p:
            tail = []
            for lp, st in zip(p["tail"], cache["tail"]):
                x, st = _block_decode(lp, x, pos, st, cfg)
                tail.append(st)
        new_cache = {"groups": groups, "shared": shared, "tail": tail}
    else:
        layers = []
        for lp, st in zip(p["layers"], cache["layers"]):
            x, st = _block_decode(lp, x, pos, st, cfg)
            layers.append(st)
        new_cache = {"layers": layers}
    return _lm_head(p, x, cfg)[:, 0], new_cache


# ------------------------------------------------------------- paged ---
def paged_supported(cfg: ModelConfig) -> Tuple[bool, str]:
    """Whether the paged serving engine covers this config: attention / MLA
    stacks and hybrid stacks (KV pages for the shared attention, fixed SSM
    state rows beside them); not RWKV6, whose state is O(1) per slot."""
    if cfg.family == "hybrid":
        return True, ""
    if cfg.mixer not in ("attention", "mla"):
        return False, (f"{cfg.mixer} state is O(1) per slot; paging buys "
                       "nothing")
    return True, ""


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> Any:
    """Per-layer paged pools; a hybrid stack pages only its shared
    attention (one pool per group)."""
    ok, why = paged_supported(cfg)
    if not ok:
        raise NotImplementedError(why)
    if cfg.family == "hybrid":
        return {"layers": [A.init_gqa_page_pool(cfg, num_pages, page_size,
                                                device)
                           for _ in range(hybrid_layout(cfg)[0])]}
    init = A.init_mla_page_pool if cfg.mixer == "mla" \
        else A.init_gqa_page_pool
    return {"layers": [init(cfg, num_pages, page_size, device)
                       for _ in range(cfg.num_layers)]}


def init_fixed_state(cfg: ModelConfig, batch: int, device) -> Any:
    """The hybrid stack's fixed-rows state: every Mamba2 layer's state with
    the slot axis second (``[M, B, ...]``), layers in group-major order
    (the ``g·k`` grouped layers, then the tail)."""
    if cfg.family != "hybrid":
        raise ValueError(f"fixed-rows state is hybrid-only, got {cfg.family}")
    d_inner, hp, nh, n = S.mamba_dims(cfg)
    m, km1 = cfg.num_layers, cfg.conv_kernel - 1
    return {"h": torch.zeros(m, batch, nh, hp, n, dtype=torch.float32,
                             device=device),
            "conv_x": torch.zeros(m, batch, km1, d_inner, dtype=cfg.tdtype,
                                  device=device),
            "conv_bc": torch.zeros(m, batch, km1, 2 * n, dtype=cfg.tdtype,
                                   device=device)}


def _mamba_layers(p: Params):
    """The hybrid stack's Mamba2 blocks in fixed-state order, each with the
    index of the group whose shared application follows it (None)."""
    for gi, group in enumerate(p["groups"]):
        for ki, lp in enumerate(group):
            yield lp, (gi if ki == len(group) - 1 else None)
    for lp in p.get("tail", ()):
        yield lp, None


def lm_prefill_chunk(p: Params, tokens, cache, start_len, chunk_len,
                     table_rows, cfg: ModelConfig, *, last_idx=None,
                     embeds=None) -> Tuple[torch.Tensor, Any]:
    """One [B, T] prompt chunk per slot, KV written straight into the paged
    pools; returns the logits at ``last_idx`` per row (meaningful on a
    prompt's final chunk) and the pools."""
    with span("model.embed"):
        x = embed_in(p, tokens, embeds)
    for lp, pool in zip(p["layers"], cache["layers"]):
        x, _ = _block_prefill_chunk(lp, x, start_len, chunk_len, pool,
                                    table_rows, cfg)
    return _head_at(p, x, last_idx, cfg), cache


def hybrid_prefill_chunk(p: Params, tokens, cache, fixed, slots, start_len,
                         chunk_len, table_rows, cfg: ModelConfig, *,
                         last_idx=None) -> Tuple[torch.Tensor, Any, Any]:
    """Chunked hybrid prefill: each Mamba2 layer runs the chunked SSD from
    its state rows, gathered at ``slots`` (every bucket row is a prefilling
    slot), and the rows go back at ``slots``; the shared attention writes
    its per-group pool.  Returns (logits, pools, fixed), both trees updated
    in place."""
    x = embed_in(p, tokens)
    scfg = cfg.with_(moe=None)
    idx = slots.long()
    fx = {k: v.index_select(1, idx) for k, v in fixed.items()}
    new = {k: [] for k in fixed}
    for m, (lp, gi) in enumerate(_mamba_layers(p)):
        h = L.apply_norm(lp["norm1"], x)
        y, st = S.mamba2_prefill_chunk(lp["mixer"], h,
                                       {k: v[m] for k, v in fx.items()},
                                       chunk_len, cfg)
        x = x + y
        for k in new:
            new[k].append(st[k])
        if gi is not None:
            x, _ = _block_prefill_chunk(p["shared"], x, start_len, chunk_len,
                                        cache["layers"][gi], table_rows, scfg)
    for k, v in fixed.items():
        v.index_copy_(1, idx, torch.stack(new[k]).to(v.dtype))
    return _head_at(p, x, last_idx, cfg), cache, fixed


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


def hybrid_decode_paged(p: Params, token, cache, fixed, position, table_rows,
                        active, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, Any, Any]:
    """One hybrid decode step: the Mamba2 layers update their fixed state
    rows, the shared attention hits one paged pool per group.  Rows with
    ``active[b]`` False keep their state bit for bit (the trash page takes
    their KV writes, but a recurrence has no trash page): each layer's new
    rows are ``where(active, new, old)``, written back in place into
    ``fixed`` (the decode CUDA graph holds those tensors).  Returns
    (logits, pools, fixed)."""
    b = token.shape[0]
    x = L.apply_embedding(p["embed"], token)
    pos = position[:, None]
    scfg = cfg.with_(moe=None)
    for m, (lp, gi) in enumerate(_mamba_layers(p)):
        old = {k: v[m] for k, v in fixed.items()}
        x, st = _block_decode(lp, x, pos, old, cfg)
        for k, v in old.items():
            keep = active.reshape((b,) + (1,) * (v.ndim - 1))
            v.copy_(torch.where(keep, st[k].to(v.dtype), v))
        if gi is not None:
            x, _ = _block_decode_paged(p["shared"], x, pos, position,
                                       cache["layers"][gi], table_rows, scfg)
    return _lm_head(p, x, cfg)[:, 0], cache, fixed
