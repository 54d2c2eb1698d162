"""Sharding hints usable from model code without hard mesh coupling (port
of ``repro/sharding/hints.py``).

Model code calls ``shard_hint(x, "data", None, "model", None)``.  With a
mesh installed (:func:`hint_mesh`: a ``DeviceMesh``, or a
``launch.mesh.MeshShape``) and ``x`` a ``DTensor``, ``x`` is redistributed
to those placements: the counterpart of the reference's
``with_sharding_constraint``, anchoring the layout where ``DTensor``'s
propagation would otherwise replicate.  With no mesh installed, on a plain
tensor, or under ``REPRO_NO_HINTS``, it is a no-op.
"""
from __future__ import annotations

import contextlib
import contextvars
import os

import torch

from repro_torch.launch.mesh import axis_sizes

_MESH: contextvars.ContextVar = contextvars.ContextVar("hint_mesh",
                                                       default=None)


@contextlib.contextmanager
def hint_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


def hint_spec(shape, axes, mesh):
    """``axes`` for a tensor of ``shape`` on ``mesh``: entries naming axes
    the mesh lacks, or whose size does not divide the dim, are dropped
    (replicated), so hints are always safe."""
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            fixed.append(None)
            continue
        group = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                      if a in sizes)
        if not group:
            fixed.append(None)
            continue
        n = 1
        for a in group:
            n *= sizes[a]
        fixed.append((group if len(group) > 1 else group[0])
                     if dim % n == 0 else None)
    return tuple(fixed) + (None,) * (len(shape) - len(fixed))


def shard_hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` redistributed to ``axes`` (see :func:`hint_spec`) when a hint
    mesh is installed and ``x`` is a ``DTensor``; else ``x``."""
    mesh = _MESH.get()
    if mesh is None or os.environ.get("REPRO_NO_HINTS"):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.rules import placements

    return x.redistribute(x.device_mesh,
                          placements(hint_spec(x.shape, axes, mesh),
                                     x.device_mesh))
