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
the layers (``s`` itself stays per layer).  The MoE expert taps record the
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
    """AWQ importance for one layer: ``s = mean|X|^α / max|W|^(1-α)``, in
    the reference's numpy arithmetic."""
    wmax = None
    for wp in group.weights:
        wm = SM._w_absmax_in(SM.tget(layer, wp), act_mean.shape)
        wmax = wm if wmax is None else np.maximum(wmax, wm)
    eps = 1e-8
    s = np.power(np.maximum(act_mean, eps), alpha) / np.power(
        np.maximum(wmax, eps), 1.0 - alpha)
    s = np.where((act_mean > eps) & (wmax > eps), s, 1.0)
    s = np.clip(s, 1e-4, 1e4)
    if group.tie == "kv":
        hkv, grp = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        dh = s.shape[-1] // (hkv * grp)
        sr = s.reshape(*s.shape[:-1], hkv, grp, dh).max(axis=-2)
        s = np.broadcast_to(
            sr[..., :, None, :], (*s.shape[:-1], hkv, grp, dh)
        ).reshape(s.shape)
    return s.astype(np.float32)


def _layer_loss(layer, cfg, group, alpha, group_size, act_mean
                ) -> Tuple[float, np.ndarray]:
    """One layer's weighted quantization loss of the group at ``alpha``,
    and its ``s``."""
    s = _awq_s(layer, cfg, group, alpha, act_mean)
    dev = SM.tget(layer, group.weights[0]).device
    st = torch.from_numpy(s).to(dev)
    x_hat = torch.from_numpy(act_mean / s).to(dev)
    total = 0.0
    for wp in group.weights:
        w = SM.tget(layer, wp).to(torch.float32)
        ws = w * SM._align(st, w)
        err = ws - fake_quantize(ws, group_size)
        total += float(((err * SM._align(x_hat, w)) ** 2).sum())
    return total, s


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
    ``layers.wo``, ``mlp.in``, ``mlp.down``."""
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
            res = [_layer_loss(lp, cfg, g, float(a), qcfg.group_size, act)
                   for lp, act in zip(layers, acts)]
            loss = sum(r[0] for r in res)
            if best is None or loss < best[0]:
                best, best_s = (loss, float(a)), [r[1] for r in res]
        alphas[g.name] = best[1]
        for lp, s in zip(layers, best_s):
            SM.apply_group(lp, cfg, g, s)
    qparams, *_ = quantize_params(params, cfg, qcfg)
    return qparams, alphas
