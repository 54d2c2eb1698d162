"""End-to-end SmoothQuant+ PTQ: calibrate → search α → smooth → W4A8
eligibility pass → group-wise int4 RTN (port of ``repro/core/apply.py``).

The port smooths and quantizes the given params *in place*: each fp weight
is replaced by its :class:`QuantizedTensor` as soon as it is quantized, so
the f32 7B model never exists twice and its fp linear weights are freed.
The reference flags one ``a8`` per stacked ``[L, ...]`` tensor (one bad
layer vetoes the stack); the port keeps one dict per layer and stamps that
same flag on the path in every layer.  MoE experts quantize as stacked
``[E, Ci, Co]`` tensors (one flag per stack); the router is a row
compensation of smoothing and stays fp.  An MLA layer also gets the int4
absorbed pair ``mixer/wkv_b_absorbed`` (:func:`_mla_absorbed_quantize`),
the only form of ``wkv_b`` the serving path reads.  The PTQ artifact waits
for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import calibration as C
from repro_torch.core import search as S
from repro_torch.core import smoothing as SM
from repro_torch.core.quantize import QuantizedTensor, quantize

# where quantize_params puts an MLA layer's absorbed int4 pair
ABSORBED = ("mixer", "wkv_b_absorbed")


@dataclasses.dataclass
class PTQReport:
    alpha: float
    search_loss: float
    loss_curve: Dict[float, float]
    quantized_paths: List[Tuple[Any, ...]]
    fp_bytes: int
    quant_bytes: int
    # W4A8: per weight path ("layers/mixer/wq/w", as the reference names its
    # stacked paths) the eligibility flag and the worst post-smoothing
    # per-token int8 round-trip error that decided it
    a8_eligibility: Dict[str, bool] = dataclasses.field(default_factory=dict)
    a8_errors: Dict[str, float] = dataclasses.field(default_factory=dict)


def quantizable_paths(cfg: ModelConfig) -> List[Tuple[Any, ...]]:
    """Every weight named by the smoothing group table, per layer."""
    return [wp for g in SM.smoothing_groups(cfg) for wp in g.weights]


def _fit_group(ci: int, group_size: int) -> int:
    """Largest power-of-two divisor of ``ci`` at most ``group_size``."""
    g = group_size
    while g > 2 and ci % g != 0:
        g //= 2
    return max(g, 2)


def _mla_absorbed_quantize(w: torch.Tensor, cfg: ModelConfig,
                           qcfg: QuantConfig) -> Dict[str, QuantizedTensor]:
    """The int4 absorbed-form projections of a *smoothed fp*
    ``wkv_b[r, H·(nope+v)]``.  Absorbed attention contracts the two halves
    along different axes (``q_lat = q_nope · w_k`` over nope, ``out = o_lat ·
    w_v`` over r), and group quantization lives on the contraction axis: the
    key half is stored transposed, ``wk_t[H, nope, r]`` (groups along nope),
    the value half head-stacked, ``wv[H, r, v]`` (groups along r); the heads
    ride the grouped kernel's expert axis."""
    m, h = cfg.mla, cfg.num_heads
    wr = w.reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    wk = wr[..., :m.qk_nope_head_dim].permute(1, 2, 0)        # [H, n, r]
    wv = wr[..., m.qk_nope_head_dim:].transpose(0, 1)         # [H, r, v]
    return {
        "wk_t": quantize(wk.contiguous(), dtype=cfg.tdtype, group_size=(
            _fit_group(m.qk_nope_head_dim, qcfg.group_size))),
        "wv": quantize(wv.contiguous(), dtype=cfg.tdtype, group_size=(
            _fit_group(m.kv_lora_rank, qcfg.group_size))),
    }


def _report_key(wp: Tuple[Any, ...]) -> str:
    return "/".join(map(str, SM.BLOCK + wp))


def derive_a8_eligibility(col: C.StatsCollector, cfg: ModelConfig,
                          qcfg: QuantConfig
                          ) -> Tuple[Dict[Tuple[Any, ...], bool],
                                     Dict[str, float]]:
    """Per-weight-path W4A8 eligibility from *post-smoothing* stats: every
    weight of a smoothing group shares one input, so the group's worst
    per-token int8 round-trip error — max over batches and over depth —
    must stay within ``qcfg.a8_threshold``.  A group with no stats is
    ineligible.  Returns ``(per-layer path → bool, report key → error)``."""
    amap: Dict[Tuple[Any, ...], bool] = {}
    errors: Dict[str, float] = {}
    for g in SM.smoothing_groups(cfg):
        errs = [v for (blk, _lidx, sub), v in col.a8_err.items()
                if blk == SM.BLOCK and sub == g.stats_sub]
        worst = max(errs) if errs else float("inf")
        ok = bool(worst <= qcfg.a8_threshold)
        for wp in g.weights:
            amap[wp] = ok
            errors[_report_key(wp)] = worst
    return amap, errors


def _tree_a8_flags(qparams, cfg: ModelConfig) -> Dict[str, bool]:
    """The ``a8`` flags actually stamped on the tree, one per path (set only
    if it is set on that path in every layer); an MLA absorbed pair moves in
    step and reports as one flag."""
    paths = quantizable_paths(cfg) + ([ABSORBED] if cfg.mla else [])

    def flag(node) -> bool:
        if isinstance(node, dict):
            return all(bool(v.a8) for v in node.values())
        return bool(node.a8)

    return {_report_key(wp): all(flag(SM.tget(lp, wp))
                                 for lp in qparams["layers"])
            for wp in paths}


@torch.no_grad()
def quantize_params(params, cfg: ModelConfig, qcfg: QuantConfig, *,
                    a8_map: Optional[Dict[Tuple[Any, ...], bool]] = None):
    """Replace every quantizable linear weight with a QuantizedTensor, in
    place.  ``a8_map`` (from :func:`derive_a8_eligibility`) stamps each
    weight's ``a8`` flag, paths missing from it ineligible (the absorbed MLA
    pair among them: its latent-domain inputs are never calibrated);
    ``None`` keeps the permissive default.  Returns (params, paths,
    fp_bytes, quant_bytes)."""
    if not qcfg.skip_router:
        raise NotImplementedError(
            "skip_router=False: the port never quantizes the MoE router (it "
            "is a row compensation of smoothing)")
    fp_bytes = quant_bytes = 0
    done = []
    for i, layer in enumerate(params["layers"]):
        for wp in quantizable_paths(cfg):
            parent = SM.tget(layer, wp[:-1])
            w = parent[wp[-1]]
            qt = quantize(w, group_size=_fit_group(w.shape[-2],
                                                   qcfg.group_size),
                          dtype=cfg.tdtype)
            if a8_map is not None:
                qt = dataclasses.replace(qt, a8=bool(a8_map.get(wp, False)))
            parent[wp[-1]] = qt
            fp_bytes += w.numel() * 2
            quant_bytes += qt.nbytes_quant()
            done.append(("layers", i) + wp)
            if cfg.mla is not None and wp[-2:] == ("wkv_b", "w"):
                ab = _mla_absorbed_quantize(w, cfg, qcfg)
                if a8_map is not None:
                    ab = {k: dataclasses.replace(
                        v, a8=bool(a8_map.get(ABSORBED, False)))
                        for k, v in ab.items()}
                SM.tget(layer, ABSORBED[:-1])[ABSORBED[-1]] = ab
                quant_bytes += sum(v.nbytes_quant() for v in ab.values())
                done.append(("layers", i) + ABSORBED)
            del w
    return params, done, fp_bytes, quant_bytes


def smoothquant_plus(params, cfg: ModelConfig,
                     calibration_batches: Iterable[Dict[str, torch.Tensor]],
                     qcfg: QuantConfig = QuantConfig(), *, step: float = 0.05,
                     verbose: bool = False) -> Tuple[Any, PTQReport]:
    """The SmoothQuant+ recipe (paper §3.1.3), in place on ``params``:
    calibrate channel max |X|, grid-search one global α (or take
    ``qcfg.alpha``), smooth, then 4-bit group-wise RTN.  A second
    calibration pass over the *smoothed* model measures each layer's
    per-token int8 activation error and stamps the W4A8 ``a8`` flags."""
    batches = list(calibration_batches)     # consumed twice
    col = C.collect_stats(params, cfg, batches)
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
    col2 = C.collect_stats(smoothed, cfg, batches)
    a8_map, a8_errors = derive_a8_eligibility(col2, cfg, qcfg)
    qparams, paths, fpb, qb = quantize_params(smoothed, cfg, qcfg,
                                              a8_map=a8_map)
    return qparams, PTQReport(res.alpha, res.loss, res.losses, paths, fpb, qb,
                              a8_eligibility=_tree_a8_flags(qparams, cfg),
                              a8_errors=a8_errors)


def rtn_baseline(params, cfg: ModelConfig, qcfg: QuantConfig = QuantConfig()):
    """Paper baseline: plain group-wise RTN, no smoothing (in place)."""
    return quantize_params(params, cfg, qcfg)[0]
