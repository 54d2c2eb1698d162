"""Model facade, decoder-only subset (port of ``repro/models/api.py``).

``init_model`` defaults to the GPU and raises when there is no card; pass
``device="cpu"`` explicitly to build on the CPU.
"""
from __future__ import annotations

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
    """Teacher-forced logits ``[B, T, V]`` f32 of ``batch["tokens"]``."""
    return LM.lm_forward(params, batch["tokens"], cfg)


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
