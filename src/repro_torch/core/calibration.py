"""Calibration: per-input-channel activation max statistics (port of
``repro/core/calibration.py``).

The calibration batches run through the fp model layer by layer; each layer's
weight tensors are registered (by ``id``) with a context collector, and
:func:`repro_torch.models.layers.apply_linear` reports its input when it sees
a registered weight.  Stats keys are the reference's:
``(("layers",), (layer_idx,), weight_subpath)``; the hybrid stack's Mamba2
layers are keyed ``(("groups",), (gi, ki), ...)`` and ``(("tail",), (ti,),
...)``, and its weight-shared attention block one key ``(("shared",), (),
...)`` across its call sites, so its stats take the channel max over them.
The encoder-decoder's layers are keyed ``(("enc",), (i,), ...)`` and
``(("dec",), (i,), ...)``; its batches carry ``frames`` and the encoder
runs non-causal.  Beside the channel max
|X| the collector keeps, per key, the channel sums of |X| and their row
count (:meth:`StatsCollector.mean_stats`, AWQ's importance) and the worst
per-token int8 round-trip error of the input
(:func:`repro_torch.core.quantize.a8_roundtrip_error`), the W4A8
eligibility statistic.  The MLA linears (``wq_a``, ``wq_b``,
``wkv_a``, ``wkv_b`` in the expanded form, ``wo``) and the shared expert
are linears like any other and are tapped by ``apply_linear``.  MoE expert
inputs never pass through
``apply_linear`` (they are grouped products over stacked weights), so
``models/mlp.py:apply_moe`` taps the collector explicitly
(:meth:`StatsCollector.record_explicit`) under the block's ``moe_key``;
as in the reference those taps record the max only, no sums.
``collect_stats.batches`` counts the batches every call has read, so a
caller can tell a boot that calibrated from one that did not.  A VLM
config's calibration batches carry the reference's patch-embedding stub
(``embeds``, 4 rows), added at the first positions as the model adds it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import a8_roundtrip_error

StatKey = Tuple[Tuple[str, ...], Tuple[int, ...], Tuple[str, ...]]

_COLLECTOR: contextvars.ContextVar = contextvars.ContextVar(
    "smoothquant_collector", default=None)


@dataclasses.dataclass
class StatsCollector:
    ids: Dict[int, StatKey] = dataclasses.field(default_factory=dict)
    stats: Dict[StatKey, np.ndarray] = dataclasses.field(default_factory=dict)
    # channel sums of |x| and their row count (AWQ's mean importance)
    sums: Dict[StatKey, np.ndarray] = dataclasses.field(default_factory=dict)
    counts: Dict[StatKey, int] = dataclasses.field(default_factory=dict)
    # worst per-token int8 round-trip error, max over batches; meaningful on
    # the post-smoothing pass of ``apply.smoothquant_plus``
    a8_err: Dict[StatKey, float] = dataclasses.field(default_factory=dict)
    # (block, layer_idx) of the block running now, for the MoE taps
    moe_key: Optional[Tuple[Tuple[str, ...], Tuple[int, ...]]] = None

    def register_tree(self, block: Tuple[str, ...], lidx: Tuple[int, ...],
                      tree, path: Tuple[str, ...] = ()) -> None:
        """Register every tensor leaf of a (per-layer) param tree."""
        if isinstance(tree, dict):
            for k, v in tree.items():
                self.register_tree(block, lidx, v, path + (k,))
        else:
            self.ids[id(tree)] = (block, lidx, path)

    def record_input(self, w, x: torch.Tensor) -> None:
        key = self.ids.get(id(w))
        if key is None:
            return
        dims = tuple(range(x.ndim - 1))
        absx = x.to(torch.float32).abs()
        amax = absx.amax(dim=dims).cpu().numpy()
        prev = self.stats.get(key)
        self.stats[key] = amax if prev is None else np.maximum(prev, amax)
        self.sums[key] = self.sums.get(key, 0.0) + absx.sum(dim=dims).cpu(
        ).numpy()
        self.counts[key] = self.counts.get(key, 0) + x.numel() // x.shape[-1]
        err = float(a8_roundtrip_error(x))
        self.a8_err[key] = max(self.a8_err.get(key, 0.0), err)

    def mean_stats(self, key: StatKey) -> np.ndarray:
        """Mean |x| per input channel over every recorded row."""
        return self.sums[key] / max(self.counts.get(key, 1), 1)

    def record_explicit(self, subpath: Tuple[str, ...], amax: torch.Tensor,
                        a8_err: Optional[torch.Tensor] = None) -> None:
        """A stat the model reports itself (per-expert channel max
        ``[E, Ci]``), keyed under the running block's ``moe_key``."""
        if self.moe_key is None:
            return
        block, lidx = self.moe_key
        key = (block, lidx, subpath)
        amax = amax.to(torch.float32).cpu().numpy()
        prev = self.stats.get(key)
        self.stats[key] = amax if prev is None else np.maximum(prev, amax)
        if a8_err is not None:
            self.a8_err[key] = max(self.a8_err.get(key, 0.0), float(a8_err))


def current_collector() -> Optional[StatsCollector]:
    return _COLLECTOR.get()


@contextlib.contextmanager
def collecting(collector: StatsCollector):
    tok = _COLLECTOR.set(collector)
    try:
        yield collector
    finally:
        _COLLECTOR.reset(tok)


@torch.no_grad()
def collect_stats(params, cfg: ModelConfig,
                  batches: Iterable[Dict[str, torch.Tensor]]) -> StatsCollector:
    """Run calibration batches through the model, collecting stats."""
    col = StatsCollector()
    with collecting(col):
        for batch in batches:
            if cfg.encdec:
                _whisper_pass(col, params, cfg, batch)
            else:
                _lm_pass(col, params, cfg, batch)
            collect_stats.batches += 1
    return col


collect_stats.batches = 0


def _lm_pass(col: StatsCollector, params, cfg: ModelConfig, batch) -> None:
    from repro_torch.models import lm as LM

    device = params["embed"]["table"].device
    tokens = batch["tokens"].to(device)
    b, t = tokens.shape
    pos = torch.arange(t, device=device)[None].expand(b, t)
    embeds = batch.get("embeds")
    x = LM.embed_in(params, tokens,
                    None if embeds is None else embeds.to(device))

    def run_block(block, lidx, lp, x, c=cfg, mixer=None):
        col.register_tree((block,), lidx, lp)
        col.moe_key = ((block,), lidx)
        x = LM._block_forward(lp, x, pos, c, mixer=mixer)
        col.moe_key = None
        return x

    if cfg.family == "hybrid":
        for gi, group in enumerate(params["groups"]):
            for ki, lp in enumerate(group):
                x = run_block("groups", (gi, ki), lp, x)
            x = run_block("shared", (), params["shared"], x,
                          cfg.with_(moe=None), "attention")
        for ti, lp in enumerate(params.get("tail", ())):
            x = run_block("tail", (ti,), lp, x)
    else:
        for i, lp in enumerate(params["layers"]):
            x = run_block("layers", (i,), lp, x)


def _whisper_pass(col: StatsCollector, params, cfg: ModelConfig,
                  batch) -> None:
    from repro_torch.models import whisper as W

    device = params["dec"]["embed"]["table"].device
    frames = batch["frames"].to(device)
    tokens = batch["tokens"].to(device)
    b, te, d = frames.shape
    x = frames + W.sinusoid(te, d, device=device).to(frames.dtype)[None]
    epos = torch.arange(te, device=device)[None].expand(b, te)
    for i, lp in enumerate(params["enc"]["layers"]):
        col.register_tree(("enc",), (i,), lp)
        x = W.enc_block(lp, x, epos, cfg)
    enc_out = W.L.apply_norm(params["enc"]["final_norm"], x)
    bt, td = tokens.shape
    x = W.L.apply_embedding(params["dec"]["embed"], tokens)
    x = x + W.sinusoid(td, d, device=device).to(x.dtype)[None]
    dpos = torch.arange(td, device=device)[None].expand(bt, td)
    for i, lp in enumerate(params["dec"]["layers"]):
        col.register_tree(("dec",), (i,), lp)
        x = W._dec_block(lp, x, dpos, enc_out, cfg)[0]


def synthetic_calibration_set(cfg: ModelConfig, *, n_seqs: int = 8,
                              seq_len: int = 64, domain: str = "humaneval",
                              seed: int = 0) -> List[Dict[str, torch.Tensor]]:
    """Offline stand-in for the paper's calibration sets: the reference's
    Zipf token draws, number for number (CPU int32 tensors); a VLM config's
    batches also carry the reference's ``embeds`` (4 standard-normal patch
    rows from seed + 9, the same for every sequence), an encoder-decoder's
    its ``frames`` (``seq_len`` standard-normal rows from seed + 7, the
    same for every sequence)."""
    zipf_a = {"humaneval": 1.3, "pile": 1.1, "c4": 1.05}[domain]
    offset = {"humaneval": 0, "pile": 1, "c4": 2}[domain]
    rng = np.random.default_rng(seed + offset * 1000)
    out = []
    for _ in range(n_seqs):
        ranks = rng.zipf(zipf_a, size=(1, seq_len)).astype(np.int64)
        toks = (ranks * (offset * 7919 + 31) % cfg.vocab_size).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks)}
        if cfg.encdec:
            emb_rng = np.random.default_rng(seed + 7)
            batch["frames"] = torch.from_numpy(emb_rng.standard_normal(
                (1, seq_len, cfg.d_model), np.float32)).to(cfg.tdtype)
        if cfg.family == "vlm":
            emb_rng = np.random.default_rng(seed + 9)
            batch["embeds"] = torch.from_numpy(emb_rng.standard_normal(
                (1, 4, cfg.d_model), np.float32)).to(cfg.tdtype)
        out.append(batch)
    return out
