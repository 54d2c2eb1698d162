"""Convert the JAX reference's params into the port's, and back.

:func:`from_reference` takes the reference param tree with every array
turned into numpy (``jax.tree.map(np.asarray, params)``), or the host
tensors :func:`to_reference` gives: nested dicts whose leaves are arrays or
quantized-weight objects with ``packed`` / ``scales`` / ``zeros``.  The
``[L, ...]`` layer stacks under ``"layers"`` (and the hybrid stack's
``"tail"``) become one dict per layer, the hybrid's ``[g, k, ...]``
``"groups"`` a list of g lists of k dicts; its weight-shared ``"shared"``
block stays one dict.  An encoder-decoder's ``"enc"`` and ``"dec"``
subtrees are converted the same way, each with its own ``"layers"``.  A quantized weight keeps its ``a8`` flag (one per
stack in the reference, so the same on every layer of the stack).
:func:`to_reference` is its inverse, the layout of a PTQ artifact and of a
train checkpoint (``repro_torch.checkpoint.manager``).  Both map an
optimizer state too: its moment trees have the params' layout.
bfloat16 arrays go through f32, which loses nothing; packed bytes keep the
reference layout (no repack).  This module imports neither JAX nor the
reference package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedTensor


def to_tensor(a, device="cpu") -> torch.Tensor:
    """A private copy (the port updates weights and pools in place, so it
    must never alias the caller's arrays)."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_quantized(leaf) -> bool:
    return all(hasattr(leaf, f) for f in ("packed", "scales", "zeros"))


def _convert(node, device, index=None) -> Any:
    if isinstance(node, dict):
        return {k: _convert(v, device, index) for k, v in node.items()}
    if _is_quantized(node):
        return QuantizedTensor(*(_convert(getattr(node, f), device, index)
                                 for f in ("packed", "scales", "zeros")),
                               a8=bool(getattr(node, "a8", True)))
    a = node if isinstance(node, torch.Tensor) else np.asarray(node)
    return to_tensor(a if index is None else a[index], device).contiguous()


# the stacked blocks and how many leading layer axes each has
STACKS = {"layers": 1, "tail": 1, "groups": 2}
# subtrees laid out like a whole model (the encoder-decoder's two sides)
SIDES = ("enc", "dec")


def _lead_shape(node, n: int):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return tuple((node.packed if _is_quantized(node) else node).shape[:n])


def is_opt_state(node) -> bool:
    """Whether ``node`` is an optimizer state (either package's)."""
    return all(hasattr(node, f) for f in ("step", "mu", "nu", "ef"))


def from_reference(tree, device="cpu"):
    """Reference param tree (numpy leaves) → port params on ``device``.  An
    optimizer state (the reference's ``OptState`` or the port's, with
    ``step``, and ``mu`` / ``nu`` / ``ef`` trees in the params' layout, ``ef``
    possibly None) becomes the port's ``OptState``."""
    if is_opt_state(tree):
        from repro_torch.optim.adamw import OptState

        return OptState(
            step=to_tensor(np.asarray(tree.step), device),
            **{f: (None if getattr(tree, f) is None
                   else from_reference(getattr(tree, f), device))
               for f in ("mu", "nu", "ef")})
    out = {}
    for k, v in tree.items():
        if k in SIDES:
            out[k] = from_reference(v, device)
        elif k not in STACKS:
            out[k] = _convert(v, device)
        elif STACKS[k] == 1:
            out[k] = [_convert(v, device, i)
                      for i in range(_lead_shape(v, 1)[0])]
        else:
            g, kk = _lead_shape(v, 2)
            out[k] = [[_convert(v, device, (gi, ki)) for ki in range(kk)]
                      for gi in range(g)]
    return out


def _stack(nodes) -> Any:
    first = nodes[0]
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    if isinstance(first, QuantizedTensor):
        return QuantizedTensor(*(torch.stack([getattr(n, f).cpu()
                                              for n in nodes])
                                 for f in ("packed", "scales", "zeros")),
                               a8=all(bool(n.a8) for n in nodes))
    return torch.stack([n.cpu() for n in nodes])


def _host(node) -> Any:
    if isinstance(node, dict):
        return {k: _host(v) for k, v in node.items()}
    if isinstance(node, QuantizedTensor):
        return QuantizedTensor(*(getattr(node, f).cpu()
                                 for f in ("packed", "scales", "zeros")),
                               a8=node.a8)
    return node.cpu()


def to_reference(params):
    """Port params → the reference's layout as host tensors: the per-layer
    dicts stacked back into ``[L, ...]`` (``[g, k, ...]`` for the hybrid's
    groups; a quantized weight's ``a8`` flag set where it is set in every
    layer of the stack, as the reference keeps one per stack); the inverse
    of :func:`from_reference`.  The port's ``OptState`` maps to one whose
    trees have this layout (its step a host tensor)."""
    if is_opt_state(params):
        from repro_torch.optim.adamw import OptState

        return OptState(step=params.step.cpu(),
                        **{f: (None if getattr(params, f) is None
                               else to_reference(getattr(params, f)))
                           for f in ("mu", "nu", "ef")})
    out = {}
    for k, v in params.items():
        if k in SIDES:
            out[k] = to_reference(v)
        elif k not in STACKS:
            out[k] = _host(v)
        elif STACKS[k] == 1:
            out[k] = _stack(v)
        else:
            out[k] = _stack([_stack(group) for group in v])
    return out
