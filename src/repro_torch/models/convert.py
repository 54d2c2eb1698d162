"""Convert the JAX reference's params into the port's.

Input is the reference param tree with every array turned into numpy
(``jax.tree.map(np.asarray, params)``): nested dicts whose leaves are arrays
or quantized-weight objects with ``packed`` / ``scales`` / ``zeros``.  The
``[L, ...]`` layer stacks under ``"layers"`` become one dict per layer; a
quantized weight keeps its ``a8`` flag (one per stack in the reference, so
the same on every layer).
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
    a = np.asarray(node)
    return to_tensor(a if index is None else a[index], device).contiguous()


def from_reference(tree, device="cpu"):
    """Reference param tree (numpy leaves) → port params on ``device``."""
    out = {k: _convert(v, device) for k, v in tree.items() if k != "layers"}
    first = tree["layers"]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n_layers = (first.packed if _is_quantized(first) else np.asarray(first)
                ).shape[0]
    out["layers"] = [_convert(tree["layers"], device, i)
                     for i in range(n_layers)]
    return out
