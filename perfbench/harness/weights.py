"""Seeded f32 weights, made on the device in one draw per group.

A group is the embedding, the head (final norm and output projection), or
one decoder layer.  Each group has its own ``torch.Generator``, seeded from
``(seed, group name)``, and draws one standard-normal vector for all of its
leaves at once; the leaves are slices of it, taken in the sorted order of
their dotted paths and scaled by their kind.  So a group's values depend
only on the seed, the group's name and its leaves' shapes, and the program
and the plain reference, which describe the shapes each in its own way,
get the same numbers layer by layer.

Plain PyTorch: this module imports nothing of the program.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

Shapes = Dict[str, Tuple[int, ...]]


def group_seed(seed: int, group: str) -> int:
    """A 63-bit generator seed for ``group`` under the run's ``seed``."""
    h = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def leaf_scale(path: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """``(mean, std)`` of a leaf by its kind: an embedding table N(0,
    0.02²); a norm's scale N(1, 0.1²) and its bias N(0, 0.02²); a linear
    bias N(0, 0.02²); a weight ``[..., Ci, Co]`` N(0, 1/Ci)."""
    parts = path.split(".")
    name, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if name == "table":
        return 0.0, 0.02
    if "norm" in parent:
        return (1.0, 0.1) if name == "scale" else (0.0, 0.02)
    if name == "b":
        return 0.0, 0.02
    if len(shape) < 2:
        raise ValueError(f"{path}: no init rule for shape {shape}")
    return 0.0, 1.0 / math.sqrt(shape[-2])


def make_group(seed: int, group: str, shapes: Shapes,
               device) -> Dict[str, torch.Tensor]:
    """The f32 leaves of one group, ``{dotted path: tensor}``, each its own
    storage (so freeing a leaf frees its bytes)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    paths = sorted(shapes)
    sizes = [math.prod(shapes[p]) for p in paths]
    z = torch.randn(sum(sizes), generator=gen, device=device,
                    dtype=torch.float32)
    out, off = {}, 0
    for p, n in zip(paths, sizes):
        mean, std = leaf_scale(p, shapes[p])
        t = z[off:off + n].view(shapes[p]).clone()
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[p] = t
        off += n
    del z
    return out
