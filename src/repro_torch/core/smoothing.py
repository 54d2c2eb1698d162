"""SmoothQuant+ smoothing with exact fusion (port of
``repro/core/smoothing.py``: the dense, MoE, MLA, hybrid Mamba2 and RWKV6
decoder groups).

For every smoothing group — linear weights sharing one input activation —
``s_j = max|X_j|^α / max|W_j|^(1-α)`` (paper eq. 6), ``W ← diag(s) W`` and
the matching ``1/s`` is fused into the activation's provider: the preceding
norm's scale, and a LayerNorm's bias too (``"norm"``), or the preceding
linear's output columns (``"linear_out"``), or only the V columns of MLA's
``wkv_b`` (``"linear_out_mla_v"``: ``wo``'s input is attention over those
values).  The GELU MLP's ``down`` has a non-linear producer
(``"none"``): its ``s`` is 1 and it is quantized unsmoothed.  As in the
reference, ``"linear_out"`` scales only ``wv``'s weight columns, not its
bias, so on a model with a nonzero ``wv`` bias the ``layers.wo`` transform
(and the encoder-decoder's ``*.wo`` / ``dec.xo``) is not exact; the port
keeps that behaviour.
RWKV6's channel mix feeds ``wv`` with ``relu(k)²``: its ``1/s`` fuses
into ``wk``'s columns as ``1/√s`` (``"linear_out_sqrt"``; exact because
``√s > 0``).  ``tie="kv"`` reduces the o-proj's ``s`` (max) over each
KV head's query group so it can fuse into ``wv``'s ``Hkv·Dh`` columns.
``row_compensations`` are non-quantized consumers of the same activation
(the MoE router, RWKV6's decay-LoRA ``w_lora_a``): their rows are scaled by
``s`` so the model stays equivalent, but they are not quantized.  Stacked expert weights ``[E, Ci,
Co]`` take the group's ``s`` per row: ``moe.in``'s ``s[Ci]`` (keyed by the
router's input stat) is shared by the experts, ``moe.down``'s ``s[E, F]`` is
per expert.  DeepSeek-V2's shared expert joins ``moe.in`` (the same
normed input) and has its own ``moe.shared.down`` group.

Paths are relative to one layer's param dict of the group's ``block``
(``"layers"``; for the hybrid stack ``"groups"``, ``"tail"`` and the
weight-shared ``"shared"``, whose one stats key spans its call sites, so its
statistics are the channel max over them; for the encoder-decoder ``"enc"``
and ``"dec"``, the layers of ``params["enc"|"dec"]["layers"]``); ``s`` is
computed per layer with the reference's numpy arithmetic, so it matches it
bit for bit given the same statistics.  A ``layer_reduce`` group
(``dec.xkv``: every decoder layer's cross ``wk``/``wv`` reads the one
encoder output) takes one ``s`` for all its layers, from the max over
layers of the activation and of the weight statistics, and its provider
(``enc.final_norm``, a path from the params' root) takes ``1/s`` once.  The port scales weights *in place* so the f32 7B model
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


@dataclasses.dataclass(frozen=True)
class Provider:
    kind: str       # norm | linear_out | linear_out_sqrt | linear_out_mla_v
    path: Path = ()                 # | none


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    weights: Tuple[Path, ...]       # quantized + smoothed (path to the tensor)
    provider: Provider
    stats_sub: Tuple[str, ...]      # collector weight subpath
    row_compensations: Tuple[Path, ...] = ()
    tie: Optional[str] = None       # None | "kv"
    block: str = "layers"           # layers | groups | tail | shared | enc
    # one s across the block's layers; the provider path is from the root
    layer_reduce: bool = False      # | dec


# the encoder-decoder's blocks: each side's "layers" list
ENCDEC_BLOCKS = ("enc", "dec")


def block_prefix(block: str) -> Tuple[str, ...]:
    """The reference's path of a block's stacked layers: ``("enc",
    "layers")`` for an encoder-decoder side, ``(block,)`` otherwise."""
    return (block, "layers") if block in ENCDEC_BLOCKS else (block,)


def tget(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def block_layers(params, block: str) -> List[Tuple[Tuple[int, ...], Any]]:
    """``(layer index, layer dict)`` of every layer of ``block`` (none when
    the layout has no such block): ``(i,)`` for ``"layers"`` and
    ``"tail"``, ``(gi, ki)`` for the hybrid's ``"groups"``, ``()`` for its
    one ``"shared"`` block."""
    node = params.get(block)
    if node is None:
        return []
    if block in ENCDEC_BLOCKS:
        node = node["layers"]
    if block == "shared":
        return [((), node)]
    if block == "groups":
        return [((gi, ki), lp) for gi, group in enumerate(node)
                for ki, lp in enumerate(group)]
    return [((i,), lp) for i, lp in enumerate(node)]


def _attn_groups(block: str = "layers") -> List[Group]:
    m = ("mixer",)
    return [
        Group(f"{block}.qkv",
              (m + ("wq", "w"), m + ("wk", "w"), m + ("wv", "w")),
              Provider("norm", ("norm1",)), m + ("wq", "w"), block=block),
        Group(f"{block}.wo", (m + ("wo", "w"),),
              Provider("linear_out", m + ("wv", "w")), m + ("wo", "w"),
              tie="kv", block=block),
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


def _mlp_groups(cfg: ModelConfig, block: str = "layers") -> List[Group]:
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
    if cfg.mlp == "gelu":   # up smoothable; down's producer is non-linear
        return [
            Group("mlp.in", (mlp + ("up", "w"),),
                  Provider("norm", ("norm2",)), mlp + ("up", "w"),
                  block=block),
            Group("mlp.down", (mlp + ("down", "w"),), Provider("none"),
                  mlp + ("down", "w"), block=block),
        ]
    return [
        Group("mlp.in", (mlp + ("gate", "w"), mlp + ("up", "w")),
              Provider("norm", ("norm2",)), mlp + ("gate", "w"), block=block),
        Group("mlp.down", (mlp + ("down", "w"),),
              Provider("linear_out", mlp + ("up", "w")), mlp + ("down", "w"),
              block=block),
    ]


def _mamba_groups(block: str) -> List[Group]:
    m = ("mixer",)
    return [
        Group("mamba.in", tuple(m + (k, "w") for k in ("in_z", "in_x",
                                                        "in_bc", "in_dt")),
              Provider("norm", ("norm1",)), m + ("in_z", "w"), block=block),
        Group("mamba.out", (m + ("out_proj", "w"),),
              Provider("norm", m + ("norm",)), m + ("out_proj", "w"),
              block=block),
    ]


def _rwkv_groups() -> List[Group]:
    m, mlp = ("mixer",), ("mlp",)
    return [
        Group("rwkv.in", tuple(m + (k, "w") for k in ("wr", "wk", "wv", "wg")),
              Provider("norm", ("norm1",)), m + ("wr", "w"),
              row_compensations=(m + ("w_lora_a",),)),
        Group("rwkv.wo", (m + ("wo", "w"),), Provider("norm", m + ("ln_x",)),
              m + ("wo", "w")),
        Group("rwkv.cm.in", (mlp + ("wk", "w"), mlp + ("wr", "w")),
              Provider("norm", ("norm2",)), mlp + ("wk", "w")),
        Group("rwkv.cm.v", (mlp + ("wv", "w"),),
              Provider("linear_out_sqrt", mlp + ("wk", "w")),
              mlp + ("wv", "w")),
    ]


def _encdec_groups() -> List[Group]:
    """Both sides' self-attention, the decoder's cross attention (q fed by
    ``norm2``, k/v by the shared encoder output) and both GELU MLPs (the
    encoder's ``norm2``, the decoder's ``norm3``)."""
    groups = []
    for side in ENCDEC_BLOCKS:
        m = ("self_attn",)
        groups += [
            Group(f"{side}.qkv", tuple(m + (k, "w") for k in ("wq", "wk",
                                                              "wv")),
                  Provider("norm", ("norm1",)), m + ("wq", "w"), block=side),
            Group(f"{side}.wo", (m + ("wo", "w"),),
                  Provider("linear_out", m + ("wv", "w")), m + ("wo", "w"),
                  tie="kv", block=side)]
    c = ("cross_attn",)
    groups += [
        Group("dec.xq", (c + ("wq", "w"),), Provider("norm", ("norm2",)),
              c + ("wq", "w"), block="dec"),
        Group("dec.xkv", (c + ("wk", "w"), c + ("wv", "w")),
              Provider("norm", ("enc", "final_norm")), c + ("wk", "w"),
              block="dec", layer_reduce=True),
        Group("dec.xo", (c + ("wo", "w"),),
              Provider("linear_out", c + ("wv", "w")), c + ("wo", "w"),
              tie="kv", block="dec")]
    for side, nrm in (("enc", "norm2"), ("dec", "norm3")):
        mlp = ("mlp",)
        groups += [
            Group(f"{side}.mlp.in", (mlp + ("up", "w"),),
                  Provider("norm", (nrm,)), mlp + ("up", "w"), block=side),
            Group(f"{side}.mlp.down", (mlp + ("down", "w"),),
                  Provider("none"), mlp + ("down", "w"), block=side)]
    return groups


def smoothing_groups(cfg: ModelConfig) -> List[Group]:
    """The reference's group table, in its order (the hybrid stack: the
    grouped and tail Mamba2 layers, then the shared attention and MLP)."""
    cfg.check()
    if cfg.encdec:
        return _encdec_groups()
    if cfg.family == "hybrid":
        return (_mamba_groups("groups") + _mamba_groups("tail")
                + _attn_groups("shared")
                + _mlp_groups(cfg.with_(moe=None), "shared"))
    if cfg.mixer == "rwkv6":
        return _rwkv_groups()
    mixer = _mla_groups() if cfg.mixer == "mla" else _attn_groups()
    return mixer + _mlp_groups(cfg)


def block_paths(cfg: ModelConfig) -> List[Tuple[str, Path]]:
    """Every ``(block, per-layer weight path)`` the groups name, once."""
    out: List[Tuple[str, Path]] = []
    for g in smoothing_groups(cfg):
        out += [(g.block, wp) for wp in g.weights if (g.block, wp) not in out]
    return out


def layer_stats(col: StatsCollector, block: str, lidx: Tuple[int, ...],
                sub: Tuple[str, ...]) -> np.ndarray:
    key = ((block,), lidx, sub)
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


def weight_absmax(layer, group: Group, stat_shape) -> np.ndarray:
    """max |W| per input row over the group's weights of one layer."""
    wmax = None
    for wp in group.weights:
        wm = _w_absmax_in(tget(layer, wp), stat_shape)
        wmax = wm if wmax is None else np.maximum(wmax, wm)
    return wmax


def smoothing_s(act: np.ndarray, wmax: np.ndarray, cfg: ModelConfig,
                group: Group, alpha: float) -> np.ndarray:
    """``s = max|X|^α / max|W|^(1-α)``, clipped, with the ``kv`` tie."""
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


def compute_group_s(layer, cfg: ModelConfig, act: np.ndarray, group: Group,
                    alpha: float) -> np.ndarray:
    """Smoothing factors ``s[*stat_lead, Ci]`` for one group of one layer
    (``[Ci]``, or ``[E, F]`` for ``moe.down``); ones for a ``"none"``
    provider."""
    if group.provider.kind == "none":
        return np.ones_like(act)
    return smoothing_s(act, weight_absmax(layer, group, act.shape), cfg,
                       group, alpha)


def block_s(params, cfg: ModelConfig, col: StatsCollector, group: Group,
            alpha: float) -> List[Tuple[Any, np.ndarray, np.ndarray]]:
    """``(layer, its activation stats, its s)`` for every layer of the
    group's block (none when the layout has no such block).  A
    ``layer_reduce`` group's one ``s`` comes from the max over layers of
    both statistics."""
    layers = [(lp, layer_stats(col, group.block, lidx, group.stats_sub))
              for lidx, lp in block_layers(params, group.block)]
    if not group.layer_reduce or group.provider.kind == "none":
        return [(lp, act, compute_group_s(lp, cfg, act, group, alpha))
                for lp, act in layers]
    act = np.max(np.stack([a for _, a in layers]), axis=0)
    wmax = np.max(np.stack([weight_absmax(lp, group, act.shape)
                            for lp, _ in layers]), axis=0)
    s = smoothing_s(act, wmax, cfg, group, alpha)
    return [(lp, a, s) for lp, a in layers]


def _scale_(w: torch.Tensor, factor: torch.Tensor, divide: bool) -> None:
    """``w ← w·factor`` (or ``/``) computed in f32, in place."""
    if w.dtype == torch.float32:
        (w.div_ if divide else w.mul_)(factor)
    else:
        wf = w.to(torch.float32)
        w.copy_((wf / factor if divide else wf * factor).to(w.dtype))


def scale_rows(layer, group: Group, s: np.ndarray) -> None:
    """``W ← diag(s) W`` for the group's weights (and row compensations) of
    one layer, in place."""
    st = torch.from_numpy(s).to(tget(layer, group.weights[0]).device)
    for wp in group.weights + group.row_compensations:
        w = tget(layer, wp)
        _scale_(w, _align(st, w), divide=False)


def fuse_provider(root, cfg: ModelConfig, group: Group, s: np.ndarray
                  ) -> None:
    """Divide the provider at ``group.provider.path`` from ``root`` by s, in
    place (the layer's dict; the params' root for a ``layer_reduce``
    group)."""
    s_prov = s
    if group.tie == "kv":
        # s is constant over each KV head's query group; the provider (wv)
        # has Hkv·Dh output columns — take one per group
        hkv, grp = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        dh = s.shape[-1] // (hkv * grp)
        s_prov = np.ascontiguousarray(
            s.reshape(hkv, grp, dh)[:, 0, :].reshape(hkv * dh))
    node = tget(root, group.provider.path)
    dev = (node["scale"] if group.provider.kind == "norm" else node).device
    sp = torch.from_numpy(s_prov).to(dev)
    if group.provider.kind == "norm":
        for leaf in ("scale", "bias"):
            if leaf in node:
                _scale_(node[leaf], sp, divide=True)
    elif group.provider.kind in ("linear_out", "linear_out_sqrt"):
        # columns of [*lead, Ci, Co] (per expert for stacked weights); the
        # sqrt form: relu(k / √s)² = relu(k)² / s needs √s > 0
        if group.provider.kind == "linear_out_sqrt":
            assert (s > 0).all(), "linear_out_sqrt needs s > 0"
            sp = torch.from_numpy(np.sqrt(s_prov)).to(dev)
        _scale_(node, sp.reshape(*sp.shape[:-1],
                                 *([1] * (node.ndim - 1 - sp.ndim)), 1,
                                 sp.shape[-1]), divide=True)
    elif group.provider.kind == "linear_out_mla_v":
        # wkv_b[r, H·(nope+v)]: divide only each head's v columns by
        # s[H·v]; its key columns feed the scores, not wo
        m, h = cfg.mla, cfg.num_heads
        wv = node.view(node.shape[0], h, m.qk_nope_head_dim
                       + m.v_head_dim)[..., m.qk_nope_head_dim:]
        _scale_(wv, sp.reshape(h, m.v_head_dim), divide=True)
    else:
        raise ValueError(group.provider.kind)


def apply_block(params, cfg: ModelConfig, group: Group, layers_s) -> None:
    """Smooth the group over its block: scale each ``(layer, s)``'s rows and
    fuse 1/s into the provider, per layer, or once from the root for a
    ``layer_reduce`` group (one unstacked provider: dividing it per layer
    would compound s).  Nothing for a ``"none"`` provider."""
    if group.provider.kind == "none":
        return
    for layer, s in layers_s:
        scale_rows(layer, group, s)
        if not group.layer_reduce:
            fuse_provider(layer, cfg, group, s)
    if group.layer_reduce and layers_s:
        fuse_provider(params, cfg, group, layers_s[0][1])


def stack_block(params, block: str, per_layer: List[np.ndarray]
                ) -> np.ndarray:
    """Per-layer arrays of ``block`` stacked as the reference stacks them:
    ``[L, ...]``, ``[g, k, ...]`` for the hybrid's groups, unstacked for the
    shared block."""
    if block == "shared":
        return per_layer[0]
    a = np.stack(per_layer)
    if block == "groups":
        g = len(params["groups"])
        a = a.reshape(g, -1, *a.shape[1:])
    return a


@torch.no_grad()
def smooth_model(params, cfg: ModelConfig, col: StatsCollector, alpha: float
                 ) -> Tuple[Any, Dict[str, np.ndarray]]:
    """Apply smoothing at strength α in place.  Returns (params,
    {group name: s stacked as its block (``[L, Ci]``)}); a name two blocks
    share (the hybrid's ``mamba.*``) keeps the later block's, as in the
    reference."""
    s_map: Dict[str, np.ndarray] = {}
    for g in smoothing_groups(cfg):
        layers = block_s(params, cfg, col, g, alpha)
        if not layers:
            continue        # block absent (no hybrid tail in this layout)
        apply_block(params, cfg, g, [(lp, s) for lp, _, s in layers])
        s_map[g.name] = stack_block(params, g.block, [s for _, _, s in layers])
    return params, s_map
