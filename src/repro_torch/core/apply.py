"""End-to-end SmoothQuant+ PTQ: calibrate → search α → smooth → group-wise
int4 RTN (port of ``repro/core/apply.py``, A16).

The port smooths and quantizes the given params *in place*: each fp weight
is replaced by its :class:`QuantizedTensor` as soon as it is quantized, so
the f32 7B model never exists twice and its fp linear weights are freed.
The W4A8 second calibration pass and the PTQ artifact wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import calibration as C
from repro_torch.core import search as S
from repro_torch.core import smoothing as SM
from repro_torch.core.quantize import quantize


@dataclasses.dataclass
class PTQReport:
    alpha: float
    search_loss: float
    loss_curve: Dict[float, float]
    quantized_paths: List[Tuple[Any, ...]]
    fp_bytes: int
    quant_bytes: int


def quantizable_paths(cfg: ModelConfig) -> List[Tuple[Any, ...]]:
    """Every weight named by the smoothing group table, per layer."""
    return [wp for g in SM.smoothing_groups(cfg) for wp in g.weights]


def _fit_group(ci: int, group_size: int) -> int:
    """Largest power-of-two divisor of ``ci`` at most ``group_size``."""
    g = group_size
    while g > 2 and ci % g != 0:
        g //= 2
    return max(g, 2)


@torch.no_grad()
def quantize_params(params, cfg: ModelConfig, qcfg: QuantConfig):
    """Replace every quantizable linear weight with a QuantizedTensor, in
    place.  Returns (params, paths, fp_bytes, quant_bytes)."""
    fp_bytes = quant_bytes = 0
    done = []
    for i, layer in enumerate(params["layers"]):
        for wp in quantizable_paths(cfg):
            parent = SM.tget(layer, wp[:-1])
            w = parent[wp[-1]]
            qt = quantize(w, group_size=_fit_group(w.shape[-2],
                                                   qcfg.group_size),
                          dtype=cfg.tdtype)
            parent[wp[-1]] = qt
            fp_bytes += w.numel() * 2
            quant_bytes += qt.nbytes_quant()
            done.append(("layers", i) + wp)
            del w
    return params, done, fp_bytes, quant_bytes


def smoothquant_plus(params, cfg: ModelConfig,
                     calibration_batches: Iterable[Dict[str, torch.Tensor]],
                     qcfg: QuantConfig = QuantConfig(), *, step: float = 0.05,
                     verbose: bool = False) -> Tuple[Any, PTQReport]:
    """The SmoothQuant+ recipe (paper §3.1.3), in place on ``params``:
    calibrate channel max |X|, grid-search one global α (or take
    ``qcfg.alpha``), smooth, then 4-bit group-wise RTN."""
    col = C.collect_stats(params, cfg, list(calibration_batches))
    if qcfg.alpha is not None:
        res = S.SearchResult(
            alpha=qcfg.alpha,
            loss=S.model_quant_loss(params, cfg, col, qcfg.alpha,
                                    qcfg.group_size),
            losses={})
    else:
        res = S.search_alpha(params, cfg, col, step=step,
                             group_size=qcfg.group_size, verbose=verbose)
    smoothed, _ = SM.smooth_model(params, cfg, col, res.alpha)
    if not qcfg.enabled:
        return smoothed, PTQReport(res.alpha, res.loss, res.losses, [], 0, 0)
    qparams, paths, fpb, qb = quantize_params(smoothed, cfg, qcfg)
    return qparams, PTQReport(res.alpha, res.loss, res.losses, paths, fpb, qb)


def rtn_baseline(params, cfg: ModelConfig, qcfg: QuantConfig = QuantConfig()):
    """Paper baseline: plain group-wise RTN, no smoothing (in place)."""
    return quantize_params(params, cfg, qcfg)[0]
