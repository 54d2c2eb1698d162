"""Model facade, decoder-only subset (port of ``repro/models/api.py``).

``init_model`` defaults to the GPU and raises when there is no card; pass
``device="cpu"`` explicitly to build on the CPU.  The swap helpers
(:func:`gather_pool_rows`, :func:`scatter_pool_rows`,
:func:`swap_image_checksum`) move a preempted slot's pool rows, and
:func:`copy_pool_page` gives a prefix-cache hit its copy-on-write page.
Still to port from the reference facade: the hybrid SSM and
encoder-decoder state leaves (``state_leaves``, ``init_fixed_state``,
``encode_kv_fn``; ROADMAP.md).  Its training loss, dense-cache
``prefill_fn`` / ``decode_fn`` and shape specs are not ported.
"""
from __future__ import annotations

import zlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm as LM


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random-weight params for ``cfg`` from a seeded ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return LM.init_lm(gen, cfg.check())


def forward_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced logits ``[B, T, V]`` f32 of ``batch["tokens"]`` (plus
    the VLM stub's ``batch["embeds"]`` where given)."""
    return LM.lm_forward(params, batch["tokens"], cfg,
                         embeds=batch.get("embeds"))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device):
    """Per-layer pools for the engine's block-table pager
    (``serving/kv_cache.py``): GQA ``{"k", "v"}`` of ``[num_pages,
    page_size, Hkv, Dh]``, MLA the latent ``{"ckv": [num_pages, page_size,
    r], "kpe": [num_pages, page_size, dr]}``; ``cfg.tdtype``, or int8 codes
    under ``cfg.kv_quant`` with f32 row scales ``{"k_s", "v_s"}`` of
    ``[num_pages, page_size, Hkv]`` (GQA) / ``{"ckv_s", "kpe_s"}`` of
    ``[num_pages, page_size]`` (MLA)."""
    return LM.init_paged_cache(cfg, num_pages, page_size, device)


def prefill_chunk_fn(params, batch, cache, table_rows, start_len, chunk_len,
                     cfg: ModelConfig, *, last_idx=None):
    return LM.lm_prefill_chunk(params, batch["tokens"], cache, start_len,
                               chunk_len, table_rows, cfg, last_idx=last_idx)


def decode_paged_fn(params, batch, cache, table_rows, cfg: ModelConfig):
    return LM.lm_decode_paged(params, batch["token"], cache,
                              batch["position"], table_rows, cfg)


def gather_pool_rows(pools, pages: torch.Tensor):
    """Whole pool pages for a slot swap-out: ``pages[n]`` (int64, on the
    pools' device) → ``{"layers": [{leaf: [n, page_size, ...]}, ...]}``, a
    copy of every leaf of every layer (K/V, MLA latents, int8 codes and
    their f32 scales alike)."""
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


def swap_image_checksum(rows) -> int:
    """CRC-32 of a host swap image (:func:`gather_pool_rows`' tree on the
    CPU), folded leaf by leaf in sorted leaf-name order and, within a leaf,
    layer by layer: the bytes of the reference's ``[L, n, page_size, ...]``
    stacks, so that it equals ``repro.models.api.swap_image_checksum`` on
    the same rows."""
    crc = 0
    layers = rows["layers"]
    for k in sorted(layers[0]):
        for lr in layers:
            a = lr[k].contiguous()
            crc = zlib.crc32(a.view(-1).view(torch.uint8).numpy(), crc)
    return crc


def rows_nbytes(rows) -> int:
    """Bytes of a swap image (every leaf of every layer)."""
    return sum(t.numel() * t.element_size()
               for lr in rows["layers"] for t in lr.values())
