"""Collective bytes of one step (port of the collective parsing of
``repro/launch/hlo_analysis.py`` and ``roofline.py``).

The port has no HLO: ``DTensor``'s sharding propagation plays GSPMD's part,
and each redistribution it needs runs a functional collective on the
rank's local shard.  :class:`CommBytes` is a ``TorchDispatchMode`` that,
the way ``torch.distributed.tensor.debug.CommDebugMode`` finds them, lets
each ``DTensor`` op run and sums the result bytes of every collective it
runs, by kind: per-device bytes landing in memory, the reference's proxy
for link traffic.  Every layer runs its own collectives, so no trip count
is needed.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# functional collective → the reference's HLO name for its kind
KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # DTensor's Shard(i) → Shard(j)
    "broadcast": "broadcast",
}


class CommBytes(TorchDispatchMode):
    """``bytes``: ``{kind: per-device result bytes}``; ``counts``: calls;
    ``by_group``: ``{process-group name: per-device result bytes}``
    (:func:`by_axis` names the mesh axis of each group); ``by_op``: the
    bytes by the ``DTensor`` op whose redistribution ran them."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.by_group: Dict[str, float] = {}
        self.by_op: Dict[str, float] = {}
        self._op = "?"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self._op = str(func)
            return NotImplemented      # let DTensor run and desugar
        out = func(*args, **(kwargs or {}))
        if getattr(func, "namespace", None) in ("_c10d_functional",
                                                "c10d_functional",
                                                "_dtensor"):
            kind = KINDS.get(func._overloadpacket.__name__)
            if kind is not None and isinstance(out, torch.Tensor):
                nbytes = out.numel() * out.element_size()
                self.bytes[kind] = self.bytes.get(kind, 0.0) + nbytes
                self.counts[kind] = self.counts.get(kind, 0) + 1
                group = [a for a in args if isinstance(a, str)][-1]
                self.by_group[group] = self.by_group.get(group, 0.0) + nbytes
                self.by_op[self._op] = self.by_op.get(self._op, 0.0) + nbytes
        return out

    def by_axis(self, mesh) -> Dict[str, float]:
        """Per-device bytes by the axis of ``mesh`` (a ``DeviceMesh``)
        whose process group carried them; a group over several adjacent
        axes (a flattened redistribution) is named ``"a+b"``."""
        from torch.distributed.distributed_c10d import _resolve_process_group

        dims = list(mesh.mesh_dim_names)
        sizes = dict(zip(dims, mesh.shape))
        names = {mesh.get_group(a).group_name: a for a in dims}
        out: Dict[str, float] = {}
        for g, b in self.by_group.items():
            name = names.get(g)
            if name is None:
                n = _resolve_process_group(g).size()
                runs = [dims[i:j] for i in range(len(dims))
                        for j in range(i + 2, len(dims) + 1)]
                run = next(r for r in runs
                           if _prod(sizes[a] for a in r) == n)
                name = "+".join(run)
            out[name] = out.get(name, 0.0) + b
        return out


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n
