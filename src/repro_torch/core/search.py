"""Global smoothing-strength (α) grid search — SmoothQuant+ §2.2/§3.1.3
(port of ``repro/core/search.py``).

One α for the whole model, minimizing the total activation-weighted
quantization loss ``Σ ||diag(x̂)(W_s − Q(W_s))||²`` with ``x̂ = stats / s``,
over the grid 0→1 in steps of 0.05.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import smoothing as SM
from repro_torch.core.calibration import StatsCollector
from repro_torch.core.quantize import fake_quantize


@dataclasses.dataclass
class SearchResult:
    alpha: float
    loss: float
    losses: Dict[float, float]


def _layer_quant_loss(layer, act, s, group, group_size) -> float:
    """One layer's activation-weighted quantization loss of the group, for
    its stats ``act`` and factors ``s``."""
    dev = SM.tget(layer, group.weights[0]).device
    st = torch.from_numpy(s).to(dev)
    x_hat = torch.from_numpy(act / s).to(dev)
    total = 0.0
    for wp in group.weights:
        w = SM.tget(layer, wp).to(torch.float32)
        ws = w * SM._align(st, w)
        err = ws - fake_quantize(ws, group_size)
        total += float(((err * SM._align(x_hat, w)) ** 2).sum())
    return total


@torch.no_grad()
def model_quant_loss(params, cfg: ModelConfig, col: StatsCollector,
                     alpha: float, group_size: int = 128) -> float:
    return sum(_layer_quant_loss(layer, act, s, g, group_size)
               for g in SM.smoothing_groups(cfg)
               for layer, act, s in SM.block_s(params, cfg, col, g, alpha))


def search_alpha(params, cfg: ModelConfig, col: StatsCollector, *,
                 step: float = 0.05, group_size: int = 128,
                 verbose: bool = False) -> SearchResult:
    """Grid-search α ∈ {0, step, …, 1} minimizing the whole-model loss."""
    grid = np.round(np.arange(0.0, 1.0 + 1e-9, step), 10)
    losses: Dict[float, float] = {}
    for a in grid:
        losses[float(a)] = model_quant_loss(params, cfg, col, float(a),
                                            group_size)
        if verbose:
            print(f"  alpha={a:.2f}  loss={losses[float(a)]:.6f}")
    best = min(losses, key=losses.get)
    return SearchResult(alpha=best, loss=losses[best], losses=losses)
