"""AdamW with a warmup + cosine schedule, global-norm clipping, and optional
int8 gradient compression with error feedback (port of
``repro/optim/adamw.py``).

Plain functions on tensors.  The moments and the error-feedback residual
are f32; each parameter's update is computed in f32 and cast back to the
parameter's dtype (bf16 at full width).  ``torch.optim.AdamW`` is not used:
it keeps the moments in the parameter's dtype and decays the weight before
the Adam step, where the reference adds ``wd · p`` to the Adam direction.

:func:`adamw_update` writes the new parameters, moments and residual into
the tensors it is given, leaf by leaf, and returns them: a 3 B-parameter
model's f32 moments are 25.7 GB, and a functional update would hold two
copies.  For the same reason the int8 compression runs leaf by leaf inside
the update (its f32 trees would be 12.8 GB each).  The arithmetic is the reference's, operation for operation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import TrainConfig
from repro_torch.models.convert import STACKS


@dataclasses.dataclass
class OptState:
    step: torch.Tensor          # int32 scalar
    mu: Any                     # f32 tree, the params' layout
    nu: Any                     # f32 tree
    ef: Optional[Any] = None    # error-feedback residual (grad compression)


def init_opt_state(params, tc: TrainConfig) -> OptState:
    """Zero moments (and residual under ``int8_ef``) beside each parameter,
    on its device."""
    def zeros():
        return T.map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)

    dev = T.leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros(), nu=zeros(),
                    ef=zeros() if tc.grad_compression == "int8_ef" else None)


def lr_schedule(tc: TrainConfig, step) -> torch.Tensor:
    """Linear warmup to ``learning_rate``, then a cosine down to a tenth of
    it at ``total_steps``; f32, on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - tc.warmup_steps)
                    / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's f32 squares, summed leaf by leaf
    in order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm at most ``max_norm``, in f32; the norm
    before clipping)."""
    gn = global_norm(T.leaves(grads))
    scale = _clip_scale(gn, max_norm)
    return T.map_leaves(lambda g: g.to(torch.float32) * scale, grads), gn


# ------------------------------------------------- int8 grad compression ----
def _codes(g: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / amax * 127.0), -127,
                       127).to(torch.int8)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 codes and the amax they scale by."""
    amax = torch.max(torch.abs(g)) + 1e-12
    return _codes(g, amax), amax


def decompress_int8(q: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (amax / 127.0)


def _stack_groups(tree) -> List[List[int]]:
    """Indices into ``tree.leaves(tree)`` grouped by the reference leaf they
    belong to: the port keeps a dict per layer where the reference stacks
    ``[L, ...]`` (``[g, k, ...]`` for the hybrid's groups), so the layers of
    one stack form one group."""
    groups: Dict[Tuple, List[int]] = {}
    n = 0

    def walk(node, path, stacked=False):
        nonlocal n
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), k in STACKS)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path if stacked else path + (i,), stacked)
        elif node is not None:
            groups.setdefault(path, []).append(n)
            n += 1

    walk(tree, ())
    return list(groups.values())


def _ef_amax(grads: List[torch.Tensor], ef: List[torch.Tensor],
             groups: List[List[int]]) -> List[torch.Tensor]:
    """Each leaf's int8 scale: the largest ``|g + e|`` over its reference
    leaf's group, built one leaf at a time."""
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for idx in groups:
        amax = torch.stack([torch.max(torch.abs(grads[i].to(torch.float32)
                                                + ef[i]))
                            for i in idx]).max() + 1e-12
        for i in idx:
            out[i] = amax
    return out


def _ef_leaf(g: torch.Tensor, e: torch.Tensor, amax: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the decompressed gradient, the new residual) of one leaf, f32."""
    v = g.to(torch.float32) + e
    d = decompress_int8(_codes(v, amax), amax)
    return d, v - d


def compress_grads_with_ef(grads, ef):
    """Error-feedback int8 compression: the residual carries each step's
    quantization error into the next, so the compressed gradient stays
    unbiased in the long run.  One amax per reference leaf, so the layers
    of a stack share it (:func:`_stack_groups`), as they do in the
    reference's ``[L, ...]`` tensors.  Returns (decompressed grads, new
    residual), f32 trees.  :func:`adamw_update` does the same leaf by leaf
    without holding either tree."""
    g, e = T.leaves(grads), T.leaves(ef)
    amax = _ef_amax(g, e, _stack_groups(grads))
    out = [_ef_leaf(*a) for a in zip(g, e, amax, strict=True)]
    return (T.unflatten(grads, [d for d, _ in out]),
            T.unflatten(grads, [r for _, r in out]))


def _adam_leaf(p, g, m, v, scale, lr, c1, c2, tc: TrainConfig):
    """One parameter's AdamW step, in place: ``g`` is its (compressed)
    gradient before clipping."""
    b1, b2, eps, wd = tc.beta1, tc.beta2, tc.eps, tc.weight_decay
    g = g.to(torch.float32) * scale
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * torch.square(g))
    pf = p.to(torch.float32)
    delta = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * pf
    p.copy_((pf - lr * delta).to(p.dtype))


@torch.no_grad()
def adamw_update(params, grads, st: OptState, tc: TrainConfig):
    """One AdamW step: (params, state, metrics), the params and the state's
    tensors updated in place, leaf by leaf; under ``int8_ef`` each leaf's
    gradient is compressed (and its residual written) as the loop reaches
    it, so no tree-sized f32 copy is held.  ``metrics`` holds the pre-clip
    ``grad_norm`` and the step's ``lr`` (device scalars)."""
    g_leaves = T.leaves(grads)
    ef = T.leaves(st.ef) if (tc.grad_compression == "int8_ef"
                             and st.ef is not None) else None
    if ef is not None:
        amax = _ef_amax(g_leaves, ef, _stack_groups(grads))
        # the norm of the compressed gradients, rebuilt leaf by leaf
        gn = torch.sqrt(sum(torch.sum(torch.square(_ef_leaf(*a)[0]))
                            for a in zip(g_leaves, ef, amax, strict=True)))
    else:
        gn = global_norm(g_leaves)
    scale = _clip_scale(gn, tc.grad_clip)
    st.step += 1
    lr = lr_schedule(tc, st.step)
    stepf = st.step.to(torch.float32)
    c1 = 1 - torch.pow(tc.beta1, stepf)
    c2 = 1 - torch.pow(tc.beta2, stepf)
    for i, (p, g, m, v) in enumerate(zip(T.leaves(params), g_leaves,
                                         T.leaves(st.mu), T.leaves(st.nu),
                                         strict=True)):
        if ef is not None:
            g, r = _ef_leaf(g, ef[i], amax[i])
            ef[i].copy_(r)
            del r
        _adam_leaf(p, g, m, v, scale, lr, c1, c2, tc)
        del g
    return params, st, {"grad_norm": gn, "lr": lr}
