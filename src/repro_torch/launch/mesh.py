"""Meshes (port of ``repro/launch/mesh.py``).

:class:`MeshShape` holds axis names and sizes and no process group: the
sharding rules (``sharding/rules.py``) build specs on it, as the reference's
tests build them on an ``AbstractMesh``.  :func:`make_production_mesh`
keeps the reference's dry-run shapes, ``(16, 16)`` over ``("data",
"model")`` and ``(2, 16, 16)`` with ``"pod"``, as a ``DeviceMesh`` over a
fake process group of 256 or 512 ranks (:func:`make_fake_mesh`):
collectives return at once and nothing leaves the process, so a step on meta ``DTensor`` s shows what each
rank would run (``launch/dryrun.py``).  :func:`make_local_mesh` covers
the cards that are present, one rank per process: on one card a ``(1, 1)``
mesh.  Functions, so that importing this module touches no process group.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Tuple

import torch
import torch.distributed as dist

DATA = "data"
MODEL = "model"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, with no process group."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def production_shape(multi_pod: bool = False) -> MeshShape:
    """16×16 per pod, ×2 pods for the multi-pod dry-run."""
    if multi_pod:
        return MeshShape(("pod", DATA, MODEL), (2, 16, 16))
    return MeshShape((DATA, MODEL), (16, 16))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fake_world(world_size: int) -> None:
    """The default process group as a fake one of ``world_size`` ranks
    (this process is rank 0); a fake group of another size is replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; the "
                               "dry-run mesh needs a fake one")
        if dist.get_world_size() == world_size:
            return
        close_mesh()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


_FAKE_MESHES: Dict[MeshShape, object] = {}


def make_fake_mesh(shape: MeshShape):
    """A ``DeviceMesh`` of ``shape`` over a fake process group.  Its device
    type is ``cuda``, the cards' (no card is touched: the dry-run's tensors
    live on the meta device), so that ``DTensor`` runs the all-to-all
    NCCL runs where a ``cpu`` mesh would gather the whole tensor instead
    (Gloo has no all-to-all).  One mesh per shape and group: ``DTensor``
    caches its sharding decisions with the mesh they were made on, so a
    second mesh of the same layout would see collectives run on the
    first one's groups."""
    from torch.distributed.device_mesh import init_device_mesh

    _fake_world(shape.size)
    if shape not in _FAKE_MESHES:
        _FAKE_MESHES[shape] = init_device_mesh(
            "cuda", shape.sizes, mesh_dim_names=shape.axis_names)
    return _FAKE_MESHES[shape]


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh on a fake group of 256 (512) ranks."""
    return make_fake_mesh(production_shape(multi_pod))


def make_local_mesh(model: int = 1, device_type: str | None = None):
    """A ``(ranks // model, model)`` ``("data", "model")`` mesh over the
    ranks that exist: the default group when one is initialised, else a
    one-rank group of this process from a ``FileStore`` in a fresh temp
    directory (no ``MASTER_ADDR`` needed); ``nccl`` on the card, ``gloo``
    on the CPU.  :func:`close_mesh` destroys the group."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        path = os.path.join(tempfile.mkdtemp(prefix="repro_mesh_"), "store")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.FileStore(path, 1), rank=0, world_size=1)
    n = dist.get_world_size()
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=(DATA, MODEL))


def close_mesh() -> None:
    """Destroy the default process group (and every mesh built on it)."""
    _FAKE_MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
