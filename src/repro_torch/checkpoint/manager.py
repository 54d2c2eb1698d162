"""Train checkpoints and PTQ artifacts on disk (port of
``repro/checkpoint/manager.py``).

The files are the reference's, byte for byte in meaning, so a checkpoint or
an artifact saved by either package loads in the other: ``arrays.npz``
holds every leaf under its tree path joined by ``SEP``; bf16 is widened to
f32 (npz cannot store it).  Writes go to ``<dir>.tmp`` and are renamed
into place, so a crash never publishes half a directory.

**Train checkpoints** (:class:`CheckpointManager`): ``step_NNNNNNNN/`` with
``arrays.npz`` and ``meta.json`` (``{"step": N, ...}``), the last ``keep``
retained; a directory without ``meta.json`` (a partial write) is ignored.
The tree is ``(params, OptState)`` in the port's layout; on disk it has the
reference's: the layer stacks ``[L, ...]`` (``models/convert.py``), keys
``0␟<param path>`` for the params and ``1␟.step``, ``1␟.mu␟<param
path>``, ``1␟.nu␟…``, ``1␟.ef␟…`` for the optimizer state (the reference's
``OptState`` is a registered dataclass, whose path keys print as
``.field``).  :func:`install_sigterm_checkpoint` saves on preemption, at a
step's end.
Restoring re-lays the arrays onto the ``like`` tree's dtypes and a device;
the reference's ``shardings=`` re-mesh is not ported (the port has no
mesh).

**PTQ artifacts**: a quantized weight becomes ``…␟packed`` (uint8),
``…␟scales`` and ``…␟zeros``.  ``meta.json`` holds ``format_version``, the
``quantized`` paths and each entry's dtype under the reference's names
(``"float32"``, ``"bfloat16"``, ``"uint8"``), plus the caller's metadata.
The tree handed in and handed back is the reference's layout (stacked
``[L, ...]`` layers) with torch tensors on the host:
``repro_torch.models.convert.to_reference`` / ``from_reference`` map it to
and from the port's params; ``repro_torch.core.apply.save_ptq`` /
``load_ptq`` are the typed entry points.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.models import convert

SEP = "␟"  # path separator unlikely to appear in keys
PTQ_FORMAT_VERSION = 1
_QT_FIELDS = ("packed", "scales", "zeros")


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(npz-safe array, the reference's dtype name); bf16 widens to f32."""
    name = str(leaf.dtype).removeprefix("torch.")
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy(), name


def _publish_dir(tmp: Path, final: Path) -> None:
    """Atomically publish ``tmp`` as ``final``.  ``os.replace`` cannot swap
    non-empty directories, so an existing ``final`` is renamed aside first:
    a crash between the renames loses nothing (the previous version
    survives as ``<name>.old``)."""
    if final.exists():
        old = final.with_name(final.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)


# ------------------------------------------------------ train checkpoints --
def _ref_tree(tree):
    """A ``(params, OptState)`` tuple (or one of them) in the reference's
    layout, host tensors."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_ref_tree(t) for t in tree)
    return convert.to_reference(tree)


def _walk_ref(node, prefix=()):
    """(key, leaf) pairs under the reference's path keys: a sequence index,
    a dict key, ``.field`` for an optimizer state; None holds nothing."""
    if isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            yield from _walk_ref(v, prefix + (str(i),))
    elif convert.is_opt_state(node):
        for f in ("step", "mu", "nu", "ef"):
            yield from _walk_ref(getattr(node, f), prefix + ("." + f,))
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _walk_ref(v, prefix + (str(k),))
    elif node is not None:
        yield SEP.join(prefix), node


def _fill_ref(node, flat: Dict[str, np.ndarray], prefix=()):
    """``node``'s structure (reference layout) with each leaf read from
    ``flat`` at its key, in the leaf's dtype; a missing key or another
    shape raises."""
    if isinstance(node, (tuple, list)):
        return type(node)(_fill_ref(v, flat, prefix + (str(i),))
                          for i, v in enumerate(node))
    if convert.is_opt_state(node):
        return type(node)(**{f: _fill_ref(getattr(node, f), flat,
                                          prefix + ("." + f,))
                             for f in ("step", "mu", "nu", "ef")})
    if isinstance(node, dict):
        return {k: _fill_ref(v, flat, prefix + (str(k),))
                for k, v in node.items()}
    if node is None:
        return None
    key = SEP.join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(node.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"model {tuple(node.shape)}")
    return torch.from_numpy(arr).to(node.dtype)


def _port_tree(tree, device):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_port_tree(t, device) for t in tree)
    return convert.from_reference(tree, device)


class CheckpointManager:
    """Atomic, retained train checkpoints in ``directory``."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None
             ) -> Path:
        """Write ``tree`` (``(params, OptState)``, the port's layout) as
        step ``step``; then drop all but the last ``keep`` steps."""
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = {k: _to_numpy(v)[0] for k, v in _walk_ref(_ref_tree(tree))}
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, **(metadata or {})}, default=str))
        _publish_dir(tmp, final)
        self._gc()
        return final

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "meta.json").exists():
                continue  # an incomplete write is ignored
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None, *,
                device=None, mesh=None, specs=None) -> Tuple[Any, Dict]:
        """(the tree saved at ``step`` (the latest when None) in the
        structure and dtypes of ``like``, on ``device`` (``like``'s when
        None); its metadata).  With a ``DeviceMesh`` and a spec tree of
        ``like``'s structure (``sharding/rules.py``; a
        ``(params, OptState)`` pair takes a pair of spec trees), every leaf
        comes back as a ``DTensor`` with its spec's placements, each rank
        keeping its own shard of the file's data (the reference's
        ``restore(shardings=)``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        dev = device if device is not None else T.leaves(like)[0].device
        tree = _port_tree(_fill_ref(_ref_tree(like), flat), dev)
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor

            from repro_torch.sharding import rules

            tree = rules.map_specs(
                lambda t, sp: distribute_tensor(
                    t, mesh, rules.placements(sp, mesh), src_data_rank=None),
                tree, specs)
        return tree, json.loads((d / "meta.json").read_text())


class SigtermCheckpoint:
    """The SIGTERM handler :func:`install_sigterm_checkpoint` installs.

    Outside :meth:`deferred` a SIGTERM calls ``save_fn`` at once.  Inside
    it, the signal is only marked pending and the save runs when the block
    ends: the port's train step updates the params and the optimizer state
    in place, leaf by leaf, so a save in the middle of one would write some
    leaves at step N + 1 and others at N.  After the save the previous
    handler is put back and the signal raised again, so the scheduler sees
    the usual exit."""

    def __init__(self, save_fn: Callable[[], None]):
        self.save_fn = save_fn
        self.prev = signal.getsignal(signal.SIGTERM)
        self.busy = False
        self.pending = False

    def __call__(self, signum, frame):
        if self.busy:
            self.pending = True
        else:
            self._save_and_exit()

    def _save_and_exit(self):
        self.busy = True        # a second SIGTERM must not save again
        try:
            self.save_fn()
        finally:
            signal.signal(signal.SIGTERM, self.prev)
            signal.raise_signal(signal.SIGTERM)

    @contextlib.contextmanager
    def deferred(self):
        """Hold a SIGTERM until the block has run to its end; a block that
        raises saves nothing (its state may be half updated)."""
        self.busy = True
        try:
            yield
        finally:
            self.busy = False
        if self.pending:
            self._save_and_exit()


def install_sigterm_checkpoint(save_fn: Callable[[], None]
                               ) -> SigtermCheckpoint:
    """Checkpoint on preemption: call ``save_fn`` once on SIGTERM, then
    re-raise with the previous handler.  Run each train step under the
    returned handler's :meth:`~SigtermCheckpoint.deferred`."""
    handler = SigtermCheckpoint(save_fn)
    signal.signal(signal.SIGTERM, handler)
    return handler


# ------------------------------------------------------------ PTQ artifacts --
def _walk_ptq(tree, prefix=()):
    """Yield (path, leaf) pairs in sorted key order, quantized weights
    whole."""
    if isinstance(tree, QuantizedTensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_ptq(tree[k], prefix + (str(k),))
    elif tree is None:
        return
    else:
        yield prefix, tree


def save_ptq_artifact(directory: str | Path, tree: Any,
                      meta: Optional[Dict] = None) -> Path:
    """Atomically write a quantized param tree (reference layout, host
    tensors) and its metadata to ``directory``."""
    final = Path(directory)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    qpaths = []
    for path, leaf in _walk_ptq(tree):
        key = SEP.join(path)
        if isinstance(leaf, QuantizedTensor):
            qpaths.append(list(path))
            for f in _QT_FIELDS:
                fkey = key + SEP + f
                flat[fkey], dtypes[fkey] = _to_numpy(getattr(leaf, f))
        else:
            flat[key], dtypes[key] = _to_numpy(leaf)
    np.savez(tmp / "arrays.npz", **flat)
    (tmp / "meta.json").write_text(json.dumps({
        "format_version": PTQ_FORMAT_VERSION,
        "quantized": qpaths,
        "dtypes": dtypes,
        **(meta or {}),
    }))
    _publish_dir(tmp, final)
    return final


def has_ptq_artifact(directory: str | Path) -> bool:
    d = Path(directory)
    return (d / "meta.json").exists() and (d / "arrays.npz").exists()


def load_ptq_artifact(directory: str | Path) -> Tuple[Any, Dict]:
    """The tree :func:`save_ptq_artifact` wrote (quantized weights
    re-assembled with the default ``a8=True``, dtypes restored, host
    tensors) and its metadata."""
    d = Path(directory)
    if not has_ptq_artifact(d):
        raise FileNotFoundError(f"no PTQ artifact at {d}")
    meta = json.loads((d / "meta.json").read_text())
    if meta.get("format_version") != PTQ_FORMAT_VERSION:
        raise ValueError(
            f"PTQ artifact format {meta.get('format_version')} != "
            f"{PTQ_FORMAT_VERSION}")
    dtypes = meta["dtypes"]
    tree: Dict[str, Any] = {}
    with np.load(d / "arrays.npz") as z:
        for key in z.files:
            dt = getattr(torch, dtypes[key], None)
            if not isinstance(dt, torch.dtype):
                raise ValueError(f"PTQ artifact entry {key!r}: unknown dtype "
                                 f"{dtypes[key]!r}")
            leaf = torch.from_numpy(z[key]).to(dt)
            parts = key.split(SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
    for qp in meta["quantized"]:
        node = tree
        for p in qp[:-1]:
            node = node[p]
        node[qp[-1]] = QuantizedTensor(*(node[qp[-1]][f]
                                         for f in _QT_FIELDS))
    return tree, meta
