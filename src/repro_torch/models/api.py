"""Model facade (port of ``repro/models/api.py``).

``init_model`` defaults to the GPU and raises when there is no card; pass
``device="cpu"`` explicitly to build on the CPU.  ``prefill_fn`` /
``decode_fn`` run the contiguous decode cache (:func:`init_decode_cache`;
RWKV6 runs only this way), ``prefill_chunk_fn`` / ``decode_paged_fn`` the
serving engine's paged pools.  A slot owns the state leaves of
:func:`state_leaves`: KV pages, and for the hybrid stack fixed rows of
Mamba2 state (:func:`init_fixed_state`), which the paged entry points take
and return beside the pools.  The swap helpers (:func:`gather_pool_rows`,
:func:`scatter_pool_rows`, :func:`gather_fixed_rows`,
:func:`scatter_fixed_rows`, :func:`swap_image_checksum`) move a preempted
slot's rows, and :func:`copy_pool_page` gives a prefix-cache hit its
copy-on-write page.  An encoder-decoder config (``cfg.encdec``: Whisper,
``models/whisper.py``) takes its frame embeddings as ``batch["frames"]``
and owns a third leaf, refcounted read-only encoder pages
(:func:`encode_kv_fn` computes their rows at admission); its paged entry
points take the slot's encoder page table and valid length.
:func:`loss_fn` is the training loss.  For the dry-run
(``launch/dryrun.py``) and the sharding rules, :func:`input_specs` and
:func:`cache_specs` give one (arch × shape) cell's batch and decode cache as
meta tensors, the counterpart of the reference's ``ShapeDtypeStruct`` s
(nothing is allocated), ``init_model(cfg, device="meta")`` the params'
shapes and dtypes, and :func:`supports_shape` the cells a config skips.
"""
from __future__ import annotations

import zlib
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import whisper as W


# State-leaf kinds a slot can own (the reference's names):
#   kv_pages   read-write paged KV (attention / MLA / hybrid shared attention)
#   fixed_rows per-layer O(1) SSM state rows, swapped alongside KV pages
#   shared_ro  refcounted read-only pages (encoder cross-attention K/V)
VLM_PATCHES = 256  # the reference's stub: fixed vision-prefix length

KV_PAGES = "kv_pages"
FIXED_ROWS = "fixed_rows"
SHARED_RO = "shared_ro"


def state_leaves(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which state-leaf kinds a slot of this config owns."""
    if cfg.encdec:
        return (KV_PAGES, SHARED_RO)
    if cfg.family == "hybrid":
        return (KV_PAGES, FIXED_ROWS)
    return (KV_PAGES,)


def paged_supported(cfg: ModelConfig) -> Tuple[bool, str]:
    """Whether the paged serving engine covers this config (and why not).
    Kept on the facade, as in the reference, so that callers need not
    reach into ``models/lm.py``."""
    return LM.paged_supported(cfg)


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random-weight params for ``cfg`` from a seeded ``torch.Generator``;
    on ``device="meta"`` the full tree of empty meta tensors (shapes and
    dtypes, nothing allocated: ``jax.eval_shape(init_model)``'s
    counterpart)."""
    if torch.device(device).type == "meta":
        gen = L.MetaGenerator()
    else:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
    if cfg.check().encdec:
        return W.init_whisper(gen, cfg)
    return LM.init_lm(gen, cfg)


def forward_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced logits ``[B, T, V]`` f32 of ``batch["tokens"]`` (plus
    the VLM stub's ``batch["embeds"]``, or the encoder-decoder's
    ``batch["frames"]``, where given)."""
    if cfg.encdec:
        return W.whisper_forward(params, batch["frames"], batch["tokens"],
                                 cfg)
    return LM.lm_forward(params, batch["tokens"], cfg,
                         embeds=batch.get("embeds"))


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False
            ) -> torch.Tensor:
    """The training loss of the reference's batch dict: ``tokens`` and
    ``labels`` ``[B, T]``, plus ``embeds`` (the VLM stub) or ``frames``
    (the encoder-decoder); mean cross entropy in f32, plus 0.01 times the
    MoE aux loss.  ``remat`` recomputes each block in the backward pass."""
    if cfg.encdec:
        return W.whisper_loss(params, batch["frames"], batch["tokens"],
                              batch["labels"], cfg, remat=remat)
    return LM.lm_loss(params, batch["tokens"], batch["labels"], cfg,
                      embeds=batch.get("embeds"), remat=remat)


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device):
    """Per-layer pools for the engine's block-table pager
    (``serving/kv_cache.py``): GQA ``{"k", "v"}`` of ``[num_pages,
    page_size, Hkv, Dh]``, MLA the latent ``{"ckv": [num_pages, page_size,
    r], "kpe": [num_pages, page_size, dr]}``; ``cfg.tdtype``, or int8 codes
    under ``cfg.kv_quant`` with f32 row scales ``{"k_s", "v_s"}`` of
    ``[num_pages, page_size, Hkv]`` (GQA) / ``{"ckv_s", "kpe_s"}`` of
    ``[num_pages, page_size]`` (MLA).  An encoder-decoder's cache also
    holds the read-only encoder pool ``{"enc": {"xk", "xv": [L,
    num_pages, page_size, Hkv, Dh]}}``."""
    if cfg.encdec:
        return W.init_whisper_paged_cache(cfg, num_pages, page_size, device)
    return LM.init_paged_cache(cfg, num_pages, page_size, device)


def prefill_fn(params, batch, cfg: ModelConfig, smax: int, *, last_idx=None):
    """Prefill ``batch["tokens"]`` into a fresh contiguous cache padded to
    ``smax``: (last-token logits [B, V], cache).  The reference's
    ``raw_cache`` option is not ported: nothing here scatters a raw prefix
    cache into pools.  An encoder-decoder encodes ``batch["frames"]``
    first; it takes no ``last_idx``, as in the reference."""
    if cfg.encdec:
        if last_idx is not None:
            raise NotImplementedError("bucketed prefill is decoder-only")
        return W.whisper_prefill(params, batch["frames"], batch["tokens"],
                                 cfg, smax)
    return LM.lm_prefill(params, batch["tokens"], cfg, smax,
                         last_idx=last_idx, embeds=batch.get("embeds"))


def decode_fn(params, batch, cache, cfg: ModelConfig):
    """One step of ``batch["token"]`` at ``batch["position"]`` against the
    contiguous cache: (logits [B, V], cache)."""
    if cfg.encdec:
        return W.whisper_decode(params, batch["token"], cache,
                                batch["position"], cfg)
    return LM.lm_decode(params, batch["token"], cache, batch["position"],
                        cfg)


def init_decode_cache(cfg: ModelConfig, batch: int, smax: int,
                      device="cuda"):
    """An empty contiguous decode cache (``models/lm.py:init_cache``; an
    encoder-decoder's holds ``smax`` cross K/V rows a layer)."""
    if cfg.encdec:
        return W.init_whisper_cache(cfg, batch, smax, smax,
                                    resolve_device(device))
    return LM.init_cache(cfg, batch, smax, resolve_device(device))


def init_fixed_state(cfg: ModelConfig, batch: int, device):
    """Fixed-rows state ``{"h", "conv_x", "conv_bc": [M, B, ...]}`` (slot
    axis second) for configs whose :func:`state_leaves` hold
    ``FIXED_ROWS``."""
    return LM.init_fixed_state(cfg, batch, device)


def encode_kv_fn(params, frames, cfg: ModelConfig):
    """The encoder pass and every decoder layer's cross K/V rows
    (``{"xk"/"xv": [L, B, T_enc, Hkv, Dh]}``), for admission into the
    read-only encoder pool."""
    if not cfg.encdec:
        raise NotImplementedError("encoder K/V is enc-dec only")
    return W.whisper_enc_kv(params, frames, cfg)


def prefill_chunk_fn(params, batch, cache, table_rows, start_len, chunk_len,
                     cfg: ModelConfig, *, last_idx=None, fixed=None,
                     slots=None, enc_table=None, enc_len=None):
    """One prompt chunk per slot into the paged pools: (logits, pools); a
    hybrid config also takes the fixed-rows tree and the bucket's
    ``slots`` and returns (logits, pools, fixed); an encoder-decoder takes
    the rows' encoder page table ``enc_table[B, P]`` and valid encoder
    rows ``enc_len[B]``."""
    if cfg.encdec:
        return W.whisper_prefill_chunk(
            params, batch["tokens"], cache, start_len, chunk_len, table_rows,
            enc_table, enc_len, cfg, last_idx=last_idx)
    if cfg.family == "hybrid":
        return LM.hybrid_prefill_chunk(
            params, batch["tokens"], cache, fixed, slots, start_len,
            chunk_len, table_rows, cfg, last_idx=last_idx)
    return LM.lm_prefill_chunk(params, batch["tokens"], cache, start_len,
                               chunk_len, table_rows, cfg, last_idx=last_idx)


def decode_paged_fn(params, batch, cache, table_rows, cfg: ModelConfig, *,
                    fixed=None, active=None, enc_table=None, enc_len=None):
    """One decode step against the paged pools: (logits, pools); a hybrid
    config also takes the fixed-rows tree and ``active[B]`` (rows not
    decoding keep their state) and returns (logits, pools, fixed); an
    encoder-decoder takes ``enc_table`` / ``enc_len`` as
    :func:`prefill_chunk_fn` does."""
    if cfg.encdec:
        return W.whisper_decode_paged(
            params, batch["token"], cache, batch["position"], table_rows,
            enc_table, enc_len, cfg)
    if cfg.family == "hybrid":
        return LM.hybrid_decode_paged(
            params, batch["token"], cache, fixed, batch["position"],
            table_rows, active, cfg)
    return LM.lm_decode_paged(params, batch["token"], cache,
                              batch["position"], table_rows, cfg)


# --------------------------------------------------------------- dry-run ----
def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The batch of one (arch × shape) cell as meta tensors (nothing is
    allocated).  ``decode`` cells: one new token against a ``seq_len``
    cache (:func:`cache_specs`).  The audio and VLM frontends are stubs, as
    in the reference: frames and patch embeddings arrive precomputed."""
    b, s = shape.global_batch, shape.seq_len

    def tok(*sh):
        return torch.empty(sh, dtype=torch.int32, device="meta")

    def emb(*sh):
        return torch.empty(sh, dtype=cfg.tdtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.encdec:
            h = s // 2
            spec = {"frames": emb(b, h, cfg.d_model), "tokens": tok(b, h)}
            if shape.kind == "train":
                spec["labels"] = tok(b, h)
            return spec
        spec = {"tokens": tok(b, s)}
        if shape.kind == "train":
            spec["labels"] = tok(b, s)
        if cfg.family == "vlm":
            spec["embeds"] = emb(b, VLM_PATCHES, cfg.d_model)
        return spec
    if shape.kind == "decode":
        return {"token": tok(b, 1), "position": tok(b)}
    raise ValueError(shape.kind)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The contiguous decode cache of a decode cell as meta tensors.  An
    encoder-decoder holds ``seq_len // 2`` self and cross rows, as the
    reference's dry-run does (:func:`init_decode_cache` gives it ``smax``
    of each)."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if cfg.encdec:
        return W.init_whisper_cache(cfg, b, s // 2, s // 2, meta)
    return LM.init_cache(cfg, b, s, meta)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The reference's skip rule: ``long_500k`` needs sub-quadratic
    attention."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       "dense-attention arch skipped per assignment")
    return True, ""


def gather_pool_rows(pools, pages: torch.Tensor):
    """Whole pool pages for a slot swap-out: ``pages[n]`` (int64, on the
    pools' device) → ``{"layers": [{leaf: [n, page_size, ...]}, ...]}``, a
    copy of every leaf of every layer (K/V, MLA latents, int8 codes and
    their f32 scales alike).  This helper, :func:`scatter_pool_rows` and
    :func:`copy_pool_page` walk ``pools["layers"]`` only: an
    encoder-decoder's read-only encoder pool never rides a swap image."""
    return {"layers": [{k: leaf.index_select(0, pages)
                        for k, leaf in lp.items()}
                       for lp in pools["layers"]]}


def scatter_pool_rows(pools, rows, pages: torch.Tensor):
    """Inverse of :func:`gather_pool_rows` (swap-in): write ``rows`` (on any
    device) into pool pages ``pages`` in place, bit for bit, so that a
    captured decode graph, which holds the pool tensors, reads them."""
    for lp, lr in zip(pools["layers"], rows["layers"]):
        for k, leaf in lp.items():
            leaf.index_copy_(0, pages, lr[k].to(leaf.device, leaf.dtype,
                                                non_blocking=True))
    return pools


def copy_pool_page(pools, src: torch.Tensor, dst: torch.Tensor):
    """Copy-on-write: duplicate pool pages ``src[n]`` into ``dst[n]`` (int64,
    on the pools' device; the destinations are distinct fresh pages) across
    every leaf of every layer, codes and int8 scales alike, bit for bit and
    in place: the decode CUDA graph holds these tensors, so the copy writes
    into their storage.  ``src`` is read whole before any ``dst`` row is
    written."""
    for lp in pools["layers"]:
        for leaf in lp.values():
            leaf.index_copy_(0, dst, leaf.index_select(0, src))
    return pools


def gather_fixed_rows(fixed, slots: torch.Tensor):
    """A slot's fixed-rows state for swap-out: ``slots[n]`` (int64) →
    ``{leaf: [M, n, ...]}``, a copy."""
    return {k: v.index_select(1, slots) for k, v in fixed.items()}


def scatter_fixed_rows(fixed, rows, slots: torch.Tensor):
    """Inverse of :func:`gather_fixed_rows` (swap-in), bit for bit and in
    place (the decode CUDA graph holds the fixed tensors)."""
    for k, v in fixed.items():
        v.index_copy_(1, slots, rows[k].to(v.device, v.dtype,
                                           non_blocking=True))
    return fixed


def swap_image_checksum(rows, fixed=None) -> int:
    """CRC-32 of a host swap image: the fixed-rows leaves first, in sorted
    name order (``conv_bc``, ``conv_x``, ``h``: the bytes of the
    reference's ``[M, 1, ...]`` rows), then the KV rows (None when the slot
    had no private page) leaf by leaf in sorted leaf-name order and, within
    a leaf, layer by layer (the bytes of the reference's ``[L, n,
    page_size, ...]`` stacks), so that it equals
    ``repro.models.api.swap_image_checksum({"kv": ..., "fixed": ...})`` on
    the same rows."""
    crc = 0
    for k in sorted(fixed or ()):
        crc = zlib.crc32(_bytes(fixed[k]), crc)
    if rows is None:
        return crc
    layers = rows["layers"]
    for k in sorted(layers[0]):
        for lr in layers:
            crc = zlib.crc32(_bytes(lr[k]), crc)
    return crc


def _bytes(t: torch.Tensor):
    return t.contiguous().view(-1).view(torch.uint8).numpy()


def rows_nbytes(rows) -> int:
    """Bytes of a swap image's KV rows (every leaf of every layer) or of its
    fixed rows (every leaf)."""
    if "layers" not in rows:
        return sum(t.numel() * t.element_size() for t in rows.values())
    return sum(t.numel() * t.element_size()
               for lr in rows["layers"] for t in lr.values())
