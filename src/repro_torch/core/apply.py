"""End-to-end SmoothQuant+ PTQ: calibrate → search α → smooth → W4A8
eligibility pass → group-wise int4 RTN (port of ``repro/core/apply.py``).

The port smooths and quantizes the given params *in place*: each fp weight
is replaced by its :class:`QuantizedTensor` as soon as it is quantized, so
the f32 7B model never exists twice and its fp linear weights are freed.
The reference flags one ``a8`` per stacked ``[L, ...]`` tensor (one bad
layer vetoes the stack; for the hybrid's ``[g, k, ...]`` groups one per
group stack); the port keeps one dict per layer and stamps that same flag
on the path in every layer of the block.  MoE experts quantize as stacked
``[E, Ci, Co]`` tensors (one flag per stack); the router is a row
compensation of smoothing and stays fp.  An MLA layer also gets the int4
absorbed pair ``mixer/wkv_b_absorbed`` (:func:`_mla_absorbed_quantize`),
the only form of ``wkv_b`` the serving path reads.

Quantize once, serve many: :func:`save_ptq` writes the quantized params and
the report as an artifact that the reference's ``load_ptq`` reads too (the
reference's stacked layout, ``checkpoint/manager.py``), and :func:`load_ptq`
boots from one saved by either package, with no calibration and no α
search.  :func:`ptq_fingerprint` renders the reference's config ``repr``, so
both packages stamp and check the same hash.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.checkpoint import manager as CK
from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import calibration as C
from repro_torch.core import search as S
from repro_torch.core import smoothing as SM
from repro_torch.core.quantize import QuantizedTensor, quantize
from repro_torch.device import resolve_device
from repro_torch.models.convert import from_reference, to_reference

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
    """Every weight named by the smoothing group table, per layer (of any
    block; :func:`repro_torch.core.smoothing.block_paths` pairs each with
    its block)."""
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


def report_key(block: str, wp: Tuple[Any, ...]) -> str:
    """The reference's name of a weight path: its stacked path joined by
    ``/`` (``layers/mixer/wq/w``, ``enc/layers/self_attn/wq/w``)."""
    return "/".join(map(str, SM.block_prefix(block) + wp))


def derive_a8_eligibility(col: C.StatsCollector, cfg: ModelConfig,
                          qcfg: QuantConfig
                          ) -> Tuple[Dict[Tuple[Any, ...], bool],
                                     Dict[str, float]]:
    """Per-weight-path W4A8 eligibility from *post-smoothing* stats: every
    weight of a smoothing group shares one input, so the group's worst
    per-token int8 round-trip error — max over batches and over depth —
    must stay within ``qcfg.a8_threshold``.  A group with no stats is
    ineligible.  Returns ``((block,) + per-layer path → bool, report key →
    error)``."""
    amap: Dict[Tuple[Any, ...], bool] = {}
    errors: Dict[str, float] = {}
    for g in SM.smoothing_groups(cfg):
        errs = [v for (blk, _lidx, sub), v in col.a8_err.items()
                if blk == (g.block,) and sub == g.stats_sub]
        worst = max(errs) if errs else float("inf")
        ok = bool(worst <= qcfg.a8_threshold)
        for wp in g.weights:
            amap[(g.block,) + wp] = ok
            errors[report_key(g.block, wp)] = worst
    return amap, errors


def _tree_a8_flags(qparams, cfg: ModelConfig) -> Dict[str, bool]:
    """The ``a8`` flags actually stamped on the tree, one per path of a
    block (set only if it is set on that path in every layer of the
    block); an MLA absorbed pair moves in step and reports as one flag."""
    paths = SM.block_paths(cfg) + ([("layers", ABSORBED)] if cfg.mla else [])

    def flag(node) -> bool:
        if isinstance(node, dict):
            return all(bool(v.a8) for v in node.values())
        return bool(node.a8)

    return {report_key(blk, wp): all(
                flag(SM.tget(lp, wp))
                for _, lp in SM.block_layers(qparams, blk))
            for blk, wp in paths if SM.block_layers(qparams, blk)}


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
    paths = SM.block_paths(cfg)
    for block in dict.fromkeys(blk for blk, _ in paths):
        for lidx, layer in SM.block_layers(params, block):
            for blk, wp in paths:
                if blk != block:
                    continue
                parent = SM.tget(layer, wp[:-1])
                w = parent[wp[-1]]
                qt = quantize(w, group_size=_fit_group(w.shape[-2],
                                                       qcfg.group_size),
                              dtype=cfg.tdtype)
                if a8_map is not None:
                    qt = dataclasses.replace(
                        qt, a8=bool(a8_map.get((block,) + wp, False)))
                parent[wp[-1]] = qt
                fp_bytes += w.numel() * 2
                quant_bytes += qt.nbytes_quant()
                done.append((block,) + lidx + wp)
                if cfg.mla is not None and wp[-2:] == ("wkv_b", "w"):
                    ab = _mla_absorbed_quantize(w, cfg, qcfg)
                    if a8_map is not None:
                        ab = {k: dataclasses.replace(
                            v, a8=bool(a8_map.get(ABSORBED, False)))
                            for k, v in ab.items()}
                    SM.tget(layer, ABSORBED[:-1])[ABSORBED[-1]] = ab
                    quant_bytes += sum(v.nbytes_quant() for v in ab.values())
                    done.append((block,) + lidx + ABSORBED)
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


# ------------------------------------------------------- PTQ artifact I/O ---
class StalePTQArtifactError(ValueError):
    """The artifact was produced under a different (model, quant) config."""


# The reference's quant config field the port does not carry, at its
# default, after the field it follows in the reference's field order.
_REF_QUANT_EXTRA = {"alpha": (("backend", "auto"),)}


def _ref_repr(obj, extra=None) -> str:
    """``repr(obj)`` as the reference's dataclass of the same name prints
    it: its fields in order, the ``extra`` ones inserted."""
    parts = []
    for f in dataclasses.fields(obj):
        parts.append(f"{f.name}={getattr(obj, f.name)!r}")
        parts += [f"{k}={v!r}" for k, v in (extra or {}).get(f.name, ())]
    return f"{type(obj).__qualname__}({', '.join(parts)})"


def ptq_fingerprint(cfg: ModelConfig, qcfg: QuantConfig) -> str:
    """The config hash stored in and checked against the artifact: the
    reference's ``sha256(repr((cfg.with_(act_quant="a16"), qcfg)))``, byte
    for byte.  ``act_quant`` is normalized out (the artifact serves A16 and
    A8-prefill engines alike); ``a8_threshold`` changes the stamped flags,
    so it counts."""
    text = (f"({_ref_repr(cfg.with_(act_quant='a16'))}, "
            f"{_ref_repr(qcfg, _REF_QUANT_EXTRA)})")
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def has_ptq(directory) -> bool:
    return CK.has_ptq_artifact(directory)


def ptq_matches(directory, cfg: ModelConfig, qcfg: QuantConfig) -> bool:
    """True iff an artifact exists and was built for exactly this config,
    i.e. a boot from it skips calibration and the α search."""
    if not has_ptq(directory):
        return False
    try:
        meta = json.loads((Path(directory) / "meta.json").read_text())
    except (ValueError, OSError):
        return False          # corrupt or unreadable metadata
    return meta.get("config_hash") == ptq_fingerprint(cfg, qcfg)


# leading layer indices of a per-layer path, per block
_LAYER_AXES = {"layers": 1, "tail": 1, "groups": 2, "shared": 0, "enc": 1,
               "dec": 1}


def _reference_paths(paths) -> List[Tuple[str, ...]]:
    """The port's per-layer paths (``("layers", i, ...)``, ``("groups", gi,
    ki, ...)``, ``("shared", ...)``, ``("enc", i, ...)``) → the
    reference's stacked ones (``("layers", ...)``, ``("enc", "layers",
    ...)``), in first-layer order."""
    out: List[Tuple[str, ...]] = []
    for p in paths:
        rp = SM.block_prefix(p[0]) + tuple(map(str, p[1 + _LAYER_AXES[p[0]]:]))
        if rp not in out:
            out.append(rp)
    return out


def _split_reference_path(p: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
    """A reference stacked path → (block, per-layer path)."""
    n = len(SM.block_prefix(p[0]))
    return p[0], tuple(p[n:])


def save_ptq(directory, qparams, report: PTQReport, cfg: ModelConfig,
             qcfg: QuantConfig) -> Path:
    """Write the quantized params and the report as an artifact in the
    reference's layout (its stacked quantized paths in the report, in the
    order its ``quantize_params`` takes them: the group table's)."""
    order = []
    for blk, wp in SM.block_paths(cfg):
        order.append(SM.block_prefix(blk) + wp)
        if cfg.mla is not None and wp[-2:] == ("wkv_b", "w"):
            order.append(SM.block_prefix(blk) + ABSORBED)
    paths = sorted(_reference_paths(report.quantized_paths),
                   key=lambda p: order.index(p) if p in order else len(order))
    meta = {
        "config_hash": ptq_fingerprint(cfg, qcfg),
        "model": cfg.name,
        "report": {
            "alpha": float(report.alpha),
            "search_loss": float(report.search_loss),
            "loss_curve": {str(k): float(v)
                           for k, v in report.loss_curve.items()},
            "quantized_paths": [list(p) for p in paths],
            "fp_bytes": int(report.fp_bytes),
            "quant_bytes": int(report.quant_bytes),
            "a8_eligibility": _tree_a8_flags(qparams, cfg) if paths else {},
            "a8_errors": {k: float(v) for k, v in report.a8_errors.items()},
        },
    }
    return CK.save_ptq_artifact(directory, to_reference(qparams), meta)


def load_ptq(directory, cfg: ModelConfig, qcfg: QuantConfig,
             device="cuda") -> Tuple[Any, PTQReport]:
    """Boot from an artifact saved by either package onto ``device``: no
    calibration, no α search.  Raises :class:`StalePTQArtifactError` when
    its config hash is not ``(cfg, qcfg)``'s."""
    dev = resolve_device(device)
    tree, meta = CK.load_ptq_artifact(directory)
    want = ptq_fingerprint(cfg, qcfg)
    if meta.get("config_hash") != want:
        raise StalePTQArtifactError(
            f"PTQ artifact at {directory} was built for config hash "
            f"{meta.get('config_hash')!r}, engine wants {want!r} "
            f"(model/quant config changed: re-quantize)")
    r = meta["report"]
    flags = {k: bool(v) for k, v in r.get("a8_eligibility", {}).items()}
    paths = [tuple(p) for p in r["quantized_paths"]]
    # re-stamp the a8 flags (the npz holds arrays only; the manager builds
    # quantized weights with the permissive default a8=True)
    for p in paths:
        flag = flags.get("/".join(p))
        if flag is None:
            continue
        node = SM.tget(tree, p[:-1])
        if isinstance(node[p[-1]], dict):
            node[p[-1]] = {k: dataclasses.replace(v, a8=flag)
                           for k, v in node[p[-1]].items()}
        else:
            node[p[-1]] = dataclasses.replace(node[p[-1]], a8=flag)
    params = from_reference(tree, dev)
    report = PTQReport(
        alpha=r["alpha"], search_loss=r["search_loss"],
        loss_curve={float(k): v for k, v in r["loss_curve"].items()},
        quantized_paths=[
            (block,) + lidx + wp
            for block in dict.fromkeys(p[0] for p in paths)
            for lidx, _ in SM.block_layers(params, block)
            for blk, wp in map(_split_reference_path, paths)
            if blk == block],
        fp_bytes=r["fp_bytes"], quant_bytes=r["quant_bytes"],
        a8_eligibility=flags,
        a8_errors={k: float(v) for k, v in r.get("a8_errors", {}).items()},
    )
    return params, report
