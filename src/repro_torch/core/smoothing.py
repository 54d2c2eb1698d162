"""SmoothQuant+ smoothing with exact fusion (port of
``repro/core/smoothing.py``: the dense, MoE and MLA decoder groups).

For every smoothing group — linear weights sharing one input activation —
``s_j = max|X_j|^α / max|W_j|^(1-α)`` (paper eq. 6), ``W ← diag(s) W`` and
the matching ``1/s`` is fused into the activation's provider: the preceding
RMSNorm scale (``"norm"``) or the preceding linear's output columns
(``"linear_out"``), or only the V columns of MLA's ``wkv_b``
(``"linear_out_mla_v"``: ``wo``'s input is attention over those values).
``tie="kv"`` reduces the o-proj's ``s`` (max) over each
KV head's query group so it can fuse into ``wv``'s ``Hkv·Dh`` columns.
``row_compensations`` are non-quantized consumers of the same activation
(the MoE router): their rows are scaled by ``s`` so the model stays
equivalent, but they are not quantized.  Stacked expert weights ``[E, Ci,
Co]`` take the group's ``s`` per row: ``moe.in``'s ``s[Ci]`` (keyed by the
router's input stat) is shared by the experts, ``moe.down``'s ``s[E, F]`` is
per expert.  DeepSeek-V2's shared expert joins ``moe.in`` (the same
normed input) and has its own ``moe.shared.down`` group.

Paths are relative to one layer's param dict; ``s`` is computed per layer
with the reference's numpy arithmetic, so it matches it bit for bit given
the same statistics.  The port scales weights *in place* so the f32 7B model
is never held twice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibration import StatsCollector

Path = Tuple[Any, ...]
BLOCK = ("layers",)


@dataclasses.dataclass(frozen=True)
class Provider:
    kind: str                       # norm | linear_out | linear_out_mla_v
    path: Path = ()


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    weights: Tuple[Path, ...]       # quantized + smoothed (path to the tensor)
    provider: Provider
    stats_sub: Tuple[str, ...]      # collector weight subpath
    row_compensations: Tuple[Path, ...] = ()
    tie: Optional[str] = None       # None | "kv"


def tget(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _attn_groups() -> List[Group]:
    m = ("mixer",)
    return [
        Group("layers.qkv", (m + ("wq", "w"), m + ("wk", "w"), m + ("wv", "w")),
              Provider("norm", ("norm1",)), m + ("wq", "w")),
        Group("layers.wo", (m + ("wo", "w"),),
              Provider("linear_out", m + ("wv", "w")), m + ("wo", "w"),
              tie="kv"),
    ]


def _mla_groups() -> List[Group]:
    m = ("mixer",)
    return [
        Group("mla.a", (m + ("wq_a", "w"), m + ("wkv_a", "w")),
              Provider("norm", ("norm1",)), m + ("wq_a", "w")),
        Group("mla.qb", (m + ("wq_b", "w"),),
              Provider("norm", m + ("norm_q",)), m + ("wq_b", "w")),
        Group("mla.kvb", (m + ("wkv_b", "w"),),
              Provider("norm", m + ("norm_kv",)), m + ("wkv_b", "w")),
        Group("mla.wo", (m + ("wo", "w"),),
              Provider("linear_out_mla_v", m + ("wkv_b", "w")),
              m + ("wo", "w")),
    ]


def _mlp_groups(cfg: ModelConfig) -> List[Group]:
    mlp = ("mlp",)
    if cfg.moe is not None:
        ex = mlp + ("experts",)
        sh = mlp + ("shared",)
        shared = bool(cfg.moe.num_shared_experts)
        groups = [
            Group("moe.in", (ex + ("gate",), ex + ("up",))
                  + ((sh + ("gate", "w"), sh + ("up", "w")) if shared else ()),
                  Provider("norm", ("norm2",)), mlp + ("router", "w"),
                  row_compensations=(mlp + ("router", "w"),)),
            Group("moe.down", (ex + ("down",),),
                  Provider("linear_out", ex + ("up",)), ex + ("down",)),
        ]
        if shared:
            groups.append(Group("moe.shared.down", (sh + ("down", "w"),),
                                Provider("linear_out", sh + ("up", "w")),
                                sh + ("down", "w")))
        return groups
    return [
        Group("mlp.in", (mlp + ("gate", "w"), mlp + ("up", "w")),
              Provider("norm", ("norm2",)), mlp + ("gate", "w")),
        Group("mlp.down", (mlp + ("down", "w"),),
              Provider("linear_out", mlp + ("up", "w")), mlp + ("down", "w")),
    ]


def smoothing_groups(cfg: ModelConfig) -> List[Group]:
    cfg.check()
    mixer = _mla_groups() if cfg.mixer == "mla" else _attn_groups()
    return mixer + _mlp_groups(cfg)


def layer_stats(col: StatsCollector, i: int, sub: Tuple[str, ...]
                ) -> np.ndarray:
    key = (BLOCK, (i,), sub)
    if key not in col.stats:
        raise KeyError(f"no calibration stats for {key}")
    return col.stats[key]


def _w_absmax_in(w: torch.Tensor, stat_shape: Tuple[int, ...]
                 ) -> np.ndarray:
    """max_j |W[..., i, j]| per input row, reduced to ``stat_shape`` (the
    experts' max for a stat shared by a stacked weight)."""
    a = w.to(torch.float32).abs().amax(dim=-1)
    while a.ndim > len(stat_shape):        # reduce extra lead dims (E)
        a = a.amax(dim=a.ndim - 2)
    return a.cpu().numpy()


def _align(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Broadcast ``s[*stat_lead, Ci]`` against ``w[*w_lead, Ci, Co]``
    rows."""
    extra = w.ndim - 1 - s.ndim
    return s.reshape(*s.shape[:-1], *([1] * extra), s.shape[-1], 1)


def compute_group_s(layer, cfg: ModelConfig, act: np.ndarray, group: Group,
                    alpha: float) -> np.ndarray:
    """Smoothing factors ``s[*stat_lead, Ci]`` for one group of one layer
    (``[Ci]``, or ``[E, F]`` for ``moe.down``)."""
    wmax = None
    for wp in group.weights:
        wm = _w_absmax_in(tget(layer, wp), act.shape)
        wmax = wm if wmax is None else np.maximum(wmax, wm)
    eps = 1e-8
    s = np.power(np.maximum(act, eps), alpha) / np.power(
        np.maximum(wmax, eps), 1.0 - alpha)
    s = np.where((act > eps) & (wmax > eps), s, 1.0)
    s = np.clip(s, 1e-4, 1e4)
    if group.tie == "kv":
        hkv, grp = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        dh = s.shape[-1] // (hkv * grp)
        sr = s.reshape(hkv, grp, dh).max(axis=-2)
        s = np.broadcast_to(sr[:, None, :], (hkv, grp, dh)).reshape(s.shape)
    return s.astype(np.float32)


def _scale_(w: torch.Tensor, factor: torch.Tensor, divide: bool) -> None:
    """``w ← w·factor`` (or ``/``) computed in f32, in place."""
    if w.dtype == torch.float32:
        (w.div_ if divide else w.mul_)(factor)
    else:
        wf = w.to(torch.float32)
        w.copy_((wf / factor if divide else wf * factor).to(w.dtype))


def apply_group(layer, cfg: ModelConfig, group: Group, s: np.ndarray) -> None:
    """Scale the group's weight rows (and its row compensations) by s and
    fuse 1/s into the provider."""
    dev = tget(layer, group.weights[0]).device
    st = torch.from_numpy(s).to(dev)
    for wp in group.weights + group.row_compensations:
        w = tget(layer, wp)
        _scale_(w, _align(st, w), divide=False)
    s_prov = s
    if group.tie == "kv":
        # s is constant over each KV head's query group; the provider (wv)
        # has Hkv·Dh output columns — take one per group
        hkv, grp = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        dh = s.shape[-1] // (hkv * grp)
        s_prov = np.ascontiguousarray(
            s.reshape(hkv, grp, dh)[:, 0, :].reshape(hkv * dh))
    sp = torch.from_numpy(s_prov).to(dev)
    if group.provider.kind == "norm":
        _scale_(tget(layer, group.provider.path)["scale"], sp, divide=True)
    elif group.provider.kind == "linear_out":
        # columns of [*lead, Ci, Co] (per expert for stacked weights)
        w = tget(layer, group.provider.path)
        _scale_(w, sp.reshape(*sp.shape[:-1], *([1] * (w.ndim - 1 - sp.ndim)),
                              1, sp.shape[-1]), divide=True)
    elif group.provider.kind == "linear_out_mla_v":
        # wkv_b[r, H·(nope+v)]: divide only each head's v columns by
        # s[H·v]; its key columns feed the scores, not wo
        m, h = cfg.mla, cfg.num_heads
        w = tget(layer, group.provider.path)
        wv = w.view(w.shape[0], h, m.qk_nope_head_dim + m.v_head_dim)[
            ..., m.qk_nope_head_dim:]
        _scale_(wv, sp.reshape(h, m.v_head_dim), divide=True)
    else:
        raise ValueError(group.provider.kind)


@torch.no_grad()
def smooth_model(params, cfg: ModelConfig, col: StatsCollector, alpha: float
                 ) -> Tuple[Any, Dict[str, np.ndarray]]:
    """Apply smoothing at strength α in place.  Returns (params,
    {group name: s stacked [L, Ci]})."""
    s_map: Dict[str, List[np.ndarray]] = {}
    for g in smoothing_groups(cfg):
        for i, layer in enumerate(params["layers"]):
            s = compute_group_s(layer, cfg, layer_stats(col, i, g.stats_sub),
                                g, alpha)
            apply_group(layer, cfg, g, s)
            s_map.setdefault(g.name, []).append(s)
    return params, {k: np.stack(v) for k, v in s_map.items()}
