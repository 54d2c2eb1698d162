"""Logical-axis sharding rules: the spec trees of params, batches, caches,
logits and optimizer state (port of ``repro/sharding/rules.py``).

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Pods are pure data-parallel; "model" carries TP/EP.

  TP   attention heads / FFN hidden / per-head SSM channels → "model"
  EP   MoE experts → "model"
  DP   batch → ("pod", "data")
  SP   decode KV caches: sequence axis → "model" (+ "data" when batch==1,
       the long-context cell)
  ZeRO optimizer state: extra "data" sharding over the first free,
       divisible dim

A spec is a plain tuple with one entry per tensor dim (trailing dims may be
left out): ``None``, an axis name, or a tuple of axis names; ``()`` is
replicated.  :func:`placements` turns one into ``Shard(i)`` / ``Replicate()``
per mesh dim.  Every rule takes a ``launch.mesh.MeshShape`` or a
``DeviceMesh``.

Rules are matched by path suffix, where a path joins the dict keys and list
indices from the root with ``/``: the port stores one dict per layer
(``layers/3/mixer/wq/w``, the hybrid's ``groups/2/4/mixer/in_x/w``), where
the reference stacks the layers on lead axes.  Suffix matching never reaches
the layer index, and the port's leaves have no stacked lead dims, so
``_pad_lead`` pads only what is really there (the MoE's stacked experts and
MLA's absorbed heads lead with a real axis).  A quantized weight (a
``QuantizedTensor``) gets the spec dict ``{"packed", "scales", "zeros"}``:
``packed`` keeps the fp weight's spec, ``scales`` / ``zeros`` drop only the
group-axis sharding, so the trio stays co-sharded on every other axis.

One difference from the reference is structural: the ZeRO axis of
:func:`opt_specs` lands on the first free, divisible dim of the port's
per-layer leaf, where the reference's lands on the stacked layer axis
whenever the layer count divides "data".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.launch.mesh import DATA, MODEL, axis_sizes

Spec = Tuple[Any, ...]
QFIELDS = ("packed", "scales", "zeros")


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", DATA) if "pod" in axis_sizes(mesh) else (DATA,)


# (suffix, base spec for the LAST ndim dims of an fp weight)
# order matters: first match wins
_RULES = (
    ("embed/table", (MODEL, None)),
    ("lm_head/w", (None, MODEL)),
    # attention (+ rwkv time-mix shares the names)
    ("mixer/wq/w", (None, MODEL)), ("mixer/wk/w", (None, MODEL)),
    ("mixer/wv/w", (None, MODEL)), ("mixer/wg/w", (None, MODEL)),
    ("mixer/wo/w", (MODEL, None)),
    ("self_attn/wq/w", (None, MODEL)), ("self_attn/wk/w", (None, MODEL)),
    ("self_attn/wv/w", (None, MODEL)), ("self_attn/wo/w", (MODEL, None)),
    ("cross_attn/wq/w", (None, MODEL)), ("cross_attn/wk/w", (None, MODEL)),
    ("cross_attn/wv/w", (None, MODEL)), ("cross_attn/wo/w", (MODEL, None)),
    ("mixer/wq/b", (MODEL,)), ("mixer/wk/b", (MODEL,)), ("mixer/wv/b", (MODEL,)),
    ("self_attn/wq/b", (MODEL,)), ("self_attn/wk/b", (MODEL,)), ("self_attn/wv/b", (MODEL,)),
    ("cross_attn/wq/b", (MODEL,)), ("cross_attn/wk/b", (MODEL,)), ("cross_attn/wv/b", (MODEL,)),
    ("wo/b", (None,)),
    # MLA
    ("mixer/wq_a/w", (None, None)), ("mixer/wkv_a/w", (None, None)),
    ("mixer/wq_b/w", (None, MODEL)), ("mixer/wkv_b/w", (None, MODEL)),
    # MLA absorbed-form decode weights (stacked int4 [H, Ci, Co]; heads ride
    # the lead axis → TP, contraction/group axes stay unsharded)
    ("wkv_b_absorbed/wk_t", (MODEL, None, None)),
    ("wkv_b_absorbed/wv", (MODEL, None, None)),
    # MoE
    ("experts/gate", (MODEL, None, None)), ("experts/up", (MODEL, None, None)),
    ("experts/down", (MODEL, None, None)),
    ("router/w", (None, None)),
    # dense MLP / shared expert
    ("mlp/gate/w", (None, MODEL)), ("mlp/up/w", (None, MODEL)),
    ("mlp/down/w", (MODEL, None)),
    ("shared/gate/w", (None, MODEL)), ("shared/up/w", (None, MODEL)),
    ("shared/down/w", (MODEL, None)),
    ("gate/b", (MODEL,)), ("up/b", (MODEL,)), ("down/b", (None,)),
    # rwkv channel mix (under mlp/)
    ("mlp/wk/w", (None, MODEL)), ("mlp/wv/w", (MODEL, None)),
    ("mlp/wr/w", (None, MODEL)),
    # mamba2
    ("mixer/in_z/w", (None, MODEL)), ("mixer/in_x/w", (None, MODEL)),
    ("mixer/in_bc/w", (None, None)), ("mixer/in_dt/w", (None, MODEL)),
    ("conv_x_w", (None, MODEL)), ("conv_x_b", (MODEL,)),
    ("conv_bc_w", (None, None)), ("conv_bc_b", (None,)),
    ("dt_bias", (MODEL,)), ("a_log", (MODEL,)), ("d_skip", (MODEL,)),
    ("mixer/norm/scale", (MODEL,)),
    ("mixer/out_proj/w", (MODEL, None)),
    # rwkv specific
    ("w_lora_a", (None, None)), ("w_lora_b", (None, MODEL)),
    ("w0", (MODEL,)), ("u_bonus", (MODEL,)),
    ("ln_x/scale", (MODEL,)), ("ln_x/bias", (MODEL,)),
    ("mixer/mix", (None, None)), ("mlp/mix", (None, None)),
)


# ----------------------------------------------------------- tree walks ----
def map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over the tensor leaves of a port tree (dicts,
    lists, tuples, ``OptState``), a ``QuantizedTensor`` giving the dict
    ``{"packed", "scales", "zeros"}`` of its three tensors' results; the
    result keeps the tree's structure (``None`` stays ``None``)."""
    if isinstance(tree, QuantizedTensor):
        return {f: fn(f"{path}/{f}", getattr(tree, f)) for f in QFIELDS}
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path
                                        else str(i))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: map_with_path(fn, getattr(tree, f.name),
                                                   f"{path}/{f.name}"
                                                   if path else f.name)
                             for f in dataclasses.fields(tree)})
    return tree


def map_specs(fn: Callable, tree, specs):
    """``fn(tensor, spec)`` over a tree and its spec tree (as the rules
    return it), walked by the tree: a ``QuantizedTensor`` comes back as one
    (its ``a8`` flag kept) of its three tensors' results."""
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(*(fn(getattr(tree, f), specs[f])
                                 for f in QFIELDS), a8=tree.a8)
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs,
                                                               strict=True))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: map_specs(fn, getattr(tree, f.name),
                                               getattr(specs, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


def flat_specs(specs, path: str = "") -> Dict[str, Spec]:
    """``{path: spec}`` of a spec tree (dicts, lists, dataclasses; a spec
    is a tuple)."""
    out: Dict[str, Spec] = {}
    if isinstance(specs, tuple):
        out[path] = specs
    elif isinstance(specs, dict):
        for k, v in specs.items():
            out.update(flat_specs(v, f"{path}/{k}" if path else str(k)))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            out.update(flat_specs(v, f"{path}/{i}" if path else str(i)))
    elif dataclasses.is_dataclass(specs):
        for f in dataclasses.fields(specs):
            out.update(flat_specs(getattr(specs, f.name),
                                  f"{path}/{f.name}" if path else f.name))
    return out


def placements(spec: Spec, mesh):
    """The ``DTensor`` placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where tensor dim i's entry names that axis, else
    ``Replicate()`` (a tensor dim over several axes is split in mesh-dim
    order, as the reference's tuple entries are).  A mesh dim of size 1
    replicates: its one shard is the whole dim, and ``DTensor`` would
    otherwise refuse views of it for nothing."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for ax, size in axis_sizes(mesh).items():
        dim = next((i for i, e in enumerate(spec)
                    if e == ax or (isinstance(e, tuple) and ax in e)), None)
        out.append(Replicate() if dim is None or size == 1 else Shard(dim))
    return out


# ---------------------------------------------------------------- params ----
def _match(ps: str) -> Optional[Spec]:
    for suffix, spec in _RULES:
        if ps.endswith(suffix):
            return spec
    return None


def _pad_lead(spec: Spec, ndim: int, qfield: Optional[str] = None) -> Spec:
    """Prepend None for lead dims the rule does not name; adapt for
    quantized fields.

    ``packed`` keeps the fp weight's spec verbatim (its row dim is Ci/2 —
    divisibility is re-checked against the real leaf shape).  ``scales`` /
    ``zeros`` drop only the *group-axis* (second-to-last) sharding, which is
    rarely divisible, and keep every lead axis (MoE expert / MLA head →
    EP/TP) plus the output axis."""
    base = tuple(spec)
    if qfield in ("scales", "zeros") and len(base) >= 2:
        base = (*base[:-2], None, base[-1])
    lead = ndim - len(base)
    if lead < 0:  # spec longer than the leaf's ndim — trim
        base = base[-ndim:] if ndim else ()
        lead = 0
    return (None,) * lead + base


def _divisible(shape, spec: Spec, mesh) -> bool:
    sizes = axis_sizes(mesh)
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if ax is None:
            continue
        need = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            need *= sizes[a]
        if dim % need != 0:
            return False
    return True


_KV_NAMES = ("wk/w", "wv/w", "wk/b", "wv/b")


def param_specs(params, mesh, cfg: Optional[ModelConfig] = None):
    """The spec tree of a param tree (real or meta tensors).

    Falls back to replication when a matched spec doesn't divide the dims.
    KV projections are REPLICATED when num_kv_heads doesn't divide the model
    axis: col-sharding them would split head_dim across devices and put a
    score all-reduce inside every attention layer.  RWKV's "wk/wv" share
    the names but are attention-free — the rule only fires for attention
    mixers."""
    sizes = axis_sizes(mesh)
    repl_kv = (cfg is not None and cfg.mixer in ("attention", "mla")
               and cfg.num_kv_heads % sizes[MODEL] != 0)

    def leaf_spec(ps: str, leaf: torch.Tensor) -> Spec:
        ndim = leaf.ndim
        qfield = None
        if ps.rsplit("/", 1)[-1] in QFIELDS:
            ps, qfield = ps.rsplit("/", 1)
        if repl_kv and any(ps.endswith(k) for k in _KV_NAMES) \
                and "mlp/" not in ps:
            return ()
        spec = _match(ps)
        if spec is None:
            return ()  # norms, small vectors → replicated
        spec = _pad_lead(spec, ndim, qfield)
        if not _divisible(leaf.shape, spec, mesh):
            return ()
        return spec

    return map_with_path(leaf_spec, params)


# ----------------------------------------------------------------- batch ----
def _n_dp(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def batch_specs(batch, mesh):
    """Shard every batch input along its leading (batch) dim when
    divisible."""
    dp, n_dp = batch_axes(mesh), _n_dp(mesh)

    def spec(_, leaf):
        b = leaf.shape[0] if leaf.ndim else 0
        if leaf.ndim >= 1 and b > 0 and b % n_dp == 0:
            return (dp,) + (None,) * (leaf.ndim - 1)
        return ()

    return map_with_path(spec, batch)


# ----------------------------------------------------------------- cache ----
def cache_specs_tree(cache, mesh):
    """Decode-cache specs: batch → data axes; sequence → model (SP); SSM
    state heads/channels → model.  Long-context batch=1 shards the sequence
    over every axis."""
    sizes = axis_sizes(mesh)
    dp, n_dp = batch_axes(mesh), _n_dp(mesh)
    n_model = sizes[MODEL]

    def spec(ps: str, leaf):
        shp = leaf.shape
        name = ps.rsplit("/", 1)[-1]
        lead = len(shp) - _cache_rank(name)
        pad = (None,) * lead
        b_idx = lead  # batch dim position after any stacked dims
        if name == "lens":
            return pad + (dp if shp[b_idx] % n_dp == 0 else None,)
        if name in ("k", "v", "ckv", "kpe", "xk", "xv", "k_s", "v_s"):
            # [*, B, S, ...]: shard B over data, S over model (SP decode)
            b, s = shp[b_idx], shp[b_idx + 1]
            if b % n_dp == 0:
                baxis, saxis = dp, (MODEL,) if s % n_model == 0 else None
            else:
                baxis = None
                all_ax = dp + (MODEL,)
                saxis = all_ax if s % (n_dp * n_model) == 0 else (
                    (MODEL,) if s % n_model == 0 else None)
            rest = len(shp) - b_idx - 2
            return pad + (baxis, saxis) + (None,) * rest
        if name in ("h", "wkv"):  # mamba [*, B, H, P, N], rwkv [*, B, H, K, V]
            b, h = shp[b_idx], shp[b_idx + 1]
            return pad + (dp if b % n_dp == 0 else None,
                          MODEL if h % n_model == 0 else None) \
                + (None,) * (len(shp) - b_idx - 2)
        if name == "conv_x":  # [*, B, K-1, d_inner]
            b, c = shp[b_idx], shp[b_idx + 2]
            return pad + (dp if b % n_dp == 0 else None, None,
                          MODEL if c % n_model == 0 else None)
        # conv_bc, x_prev, ffn_prev: batch only
        b = shp[b_idx] if len(shp) > b_idx else 0
        return pad + (dp if b and b % n_dp == 0 else None,) \
            + (None,) * (len(shp) - b_idx - 1)

    return map_with_path(spec, cache)


def _cache_rank(name: str) -> int:
    """Rank of one cache leaf excluding stacked dims (the port's leaves
    have none; the names are the port's cache leaves, the reference's)."""
    return {
        "k": 4, "v": 4, "xk": 4, "xv": 4, "ckv": 3, "kpe": 3, "lens": 1,
        "k_s": 3, "v_s": 3,
        "h": 4, "conv_x": 3, "conv_bc": 3, "wkv": 4, "x_prev": 2,
        "ffn_prev": 2,
    }[name]


def logits_spec(mesh) -> Spec:
    return (batch_axes(mesh), None, MODEL)


def logits_prefill_spec(mesh, batch: int, vocab: int) -> Spec:
    """Prefill returns last-token logits [B, V]: batch over data, V over
    model."""
    sizes = axis_sizes(mesh)
    b_ax = batch_axes(mesh) if batch % _n_dp(mesh) == 0 else None
    v_ax = MODEL if vocab % sizes[MODEL] == 0 else None
    return (b_ax, v_ax)


def logits_decode_spec(mesh, batch: int, vocab: int) -> Spec:
    v_ax = MODEL if vocab % axis_sizes(mesh)[MODEL] == 0 else None
    return (None, v_ax)  # decode batch may be small (long_500k B=1)


# ------------------------------------------------------ optimizer (ZeRO) ----
def opt_specs(opt_state, pspecs, mesh):
    """ZeRO-style optimizer-state sharding over the port's
    ``optim.adamw.OptState``: mu/nu/ef take the param's spec PLUS a "data"
    sharding on the first dim whose axis is free and divisible, so Adam
    moments never replicate across the data axis."""
    from repro_torch.optim.adamw import OptState

    n_data = axis_sizes(mesh)[DATA]

    def zeroify(leaf, spec: Spec) -> Spec:
        axes = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, (ax, dim) in enumerate(zip(axes, leaf.shape)):
            if ax is None and dim > 0 and dim % n_data == 0:
                axes[i] = DATA
                return tuple(axes)
        return tuple(axes)

    def tree(t):
        return None if t is None else map_specs(zeroify, t, pspecs)

    return OptState(step=(), mu=tree(opt_state.mu), nu=tree(opt_state.nu),
                    ef=tree(opt_state.ef))
