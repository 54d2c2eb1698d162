"""Calibration: per-input-channel activation max statistics (port of
``repro/core/calibration.py``, decoder-only pass).

The calibration batches run through the fp model layer by layer; each layer's
weight tensors are registered (by ``id``) with a context collector, and
:func:`repro_torch.models.layers.apply_linear` reports its input when it sees
a registered weight.  Stats keys are the reference's:
``(("layers",), (layer_idx,), weight_subpath)``.  Beside the channel max
|X| the collector keeps, per key, the worst per-token int8 round-trip error
of the input (:func:`repro_torch.core.quantize.a8_roundtrip_error`), the
W4A8 eligibility statistic.  The MLA linears (``wq_a``, ``wq_b``,
``wkv_a``, ``wkv_b`` in the expanded form, ``wo``) and the shared expert
are linears like any other and are tapped by ``apply_linear``.  MoE expert
inputs never pass through
``apply_linear`` (they are grouped products over stacked weights), so
``models/mlp.py:apply_moe`` taps the collector explicitly
(:meth:`StatsCollector.record_explicit`) under the block's ``moe_key``.
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
        amax = x.to(torch.float32).abs().amax(dim=dims).cpu().numpy()
        prev = self.stats.get(key)
        self.stats[key] = amax if prev is None else np.maximum(prev, amax)
        err = float(a8_roundtrip_error(x))
        self.a8_err[key] = max(self.a8_err.get(key, 0.0), err)

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
            _lm_pass(col, params, cfg, batch)
    return col


def _lm_pass(col: StatsCollector, params, cfg: ModelConfig, batch) -> None:
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM

    device = params["embed"]["table"].device
    tokens = batch["tokens"].to(device)
    b, t = tokens.shape
    pos = torch.arange(t, device=device)[None].expand(b, t)
    x = L.apply_embedding(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        col.register_tree(("layers",), (i,), lp)
        col.moe_key = (("layers",), (i,))
        x = LM._block_forward(lp, x, pos, cfg)
        col.moe_key = None


def synthetic_calibration_set(cfg: ModelConfig, *, n_seqs: int = 8,
                              seq_len: int = 64, domain: str = "humaneval",
                              seed: int = 0) -> List[Dict[str, torch.Tensor]]:
    """Offline stand-in for the paper's calibration sets: the reference's
    Zipf token draws, number for number (CPU int32 tensors)."""
    zipf_a = {"humaneval": 1.3, "pile": 1.1, "c4": 1.05}[domain]
    offset = {"humaneval": 0, "pile": 1, "c4": 2}[domain]
    rng = np.random.default_rng(seed + offset * 1000)
    out = []
    for _ in range(n_seqs):
        ranks = rng.zipf(zipf_a, size=(1, seq_len)).astype(np.int64)
        toks = (ranks * (offset * 7919 + 31) % cfg.vocab_size).astype(np.int32)
        out.append({"tokens": torch.from_numpy(toks)})
    return out
