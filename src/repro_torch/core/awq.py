"""AWQ baseline (Lin et al. 2023) as the paper characterises it, §4 (port of
``repro/core/awq.py``).

The differences from SmoothQuant+ are the paper's three criticisms:
- the importance factor is the per-channel activation *mean* |x|
  (:meth:`StatsCollector.mean_stats`), not the max;
- α is searched per smoothing group, minimizing that group's own weighted
  quantization loss: error accumulating across groups is ignored;
- that per-group search is what makes it slower at scale.

It reuses SmoothQuant+'s groups and exact fusion, so a comparison isolates
those deltas.  A group spans every layer, as the reference's groups span
its stacked ``[L, ...]`` tensors: its one α minimizes the loss summed over
the layers (``s`` itself stays per layer, except in a ``layer_reduce``
group, whose one ``s`` is the max over its layers' ``s``, as in the
reference).  The MoE expert taps record the
max only, so ``moe.down`` falls back to the max statistics, as in the
reference.  A group with no provider (the GELU MLP's ``down``) is skipped,
unsmoothed, with no α.  Like :func:`repro_torch.core.apply.smoothquant_plus`
it works in place on the params it is given.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import smoothing as SM
from repro_torch.core.apply import quantize_params
from repro_torch.core.calibration import StatsCollector, collect_stats
from repro_torch.core.quantize import fake_quantize


def _awq_s(layer, cfg: ModelConfig, group: SM.Group, alpha: float,
           act_mean: np.ndarray) -> np.ndarray:
    """AWQ importance for one layer: SmoothQuant+'s formula on the mean
    |X|, ``s = mean|X|^α / max|W|^(1-α)``."""
    return SM.smoothing_s(act_mean, SM.weight_absmax(layer, group,
                                                      act_mean.shape),
                          cfg, group, alpha)


def _layer_loss(layer, group, s, group_size, act_mean) -> float:
    """One layer's weighted quantization loss of the group for its
    ``s``."""
    dev = SM.tget(layer, group.weights[0]).device
    st = torch.from_numpy(s).to(dev)
    x_hat = torch.from_numpy(act_mean / s).to(dev)
    total = 0.0
    for wp in group.weights:
        w = SM.tget(layer, wp).to(torch.float32)
        ws = w * SM._align(st, w)
        err = ws - fake_quantize(ws, group_size)
        total += float(((err * SM._align(x_hat, w)) ** 2).sum())
    return total


def _mean_stats(col: StatsCollector, block: str, lidx, sub) -> np.ndarray:
    """A layer's mean |x| for the group's input, or its max where the input
    was tapped without sums (the MoE experts)."""
    key = ((block,), lidx, sub)
    return col.mean_stats(key) if key in col.sums else SM.layer_stats(
        col, block, lidx, sub)


@torch.no_grad()
def awq_quantize(params, cfg: ModelConfig,
                 calibration_batches: Iterable[Dict[str, torch.Tensor]],
                 qcfg: QuantConfig = QuantConfig(), *, step: float = 0.05
                 ) -> Tuple[object, Dict[str, float]]:
    """Per-group α search + smoothing + int4 RTN (AWQ-style), in place.
    Returns ``(qparams, {group name: α})``, e.g. ``layers.qkv``,
    ``layers.wo``, ``mlp.in`` (a group with no provider has none)."""
    col = collect_stats(params, cfg, calibration_batches)
    alphas: Dict[str, float] = {}
    grid = np.round(np.arange(0.0, 1.0 + 1e-9, step), 10)
    for g in SM.smoothing_groups(cfg):
        if g.provider.kind == "none":      # nothing to smooth (s = 1)
            continue
        blk = SM.block_layers(params, g.block)
        if not blk:
            continue        # block absent (no hybrid tail in this layout)
        layers = [lp for _, lp in blk]
        try:
            acts = [_mean_stats(col, g.block, lidx, g.stats_sub)
                    for lidx, _ in blk]
        except KeyError:
            continue
        best, best_s = None, None
        for a in grid:
            ss = [_awq_s(lp, cfg, g, float(a), act)
                  for lp, act in zip(layers, acts)]
            if g.layer_reduce:
                ss = [np.max(np.stack(ss), axis=0)] * len(ss)
            loss = sum(_layer_loss(lp, g, s, qcfg.group_size, act)
                       for lp, act, s in zip(layers, acts, ss))
            if best is None or loss < best[0]:
                best, best_s = (loss, float(a)), ss
        alphas[g.name] = best[1]
        SM.apply_block(params, cfg, g, list(zip(layers, best_s)))
    qparams, *_ = quantize_params(params, cfg, qcfg)
    return qparams, alphas
