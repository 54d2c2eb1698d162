"""PTQ artifacts: a quantized param tree and its metadata on disk (port of
the PTQ half of ``repro/checkpoint/manager.py``; the train-checkpoint half
waits for ROADMAP queue A item 4).

The files are the reference's, byte for byte in meaning, so an artifact
saved by either package loads in the other: ``arrays.npz`` holds every leaf
under its tree path joined by ``SEP``; a quantized weight becomes
``…␟packed`` (uint8), ``…␟scales`` and ``…␟zeros``; bf16 is widened to f32
(npz cannot store it).  ``meta.json`` holds ``format_version``, the
``quantized`` paths and each entry's dtype under the reference's names
(``"float32"``, ``"bfloat16"``, ``"uint8"``), plus the caller's metadata.
A save writes ``<dir>.tmp`` and renames it into place, so a crash never
publishes half an artifact.

The tree handed in and handed back is the reference's layout (stacked
``[L, ...]`` layers) with torch tensors on the host:
``repro_torch.models.convert.to_reference`` / ``from_reference`` map it to
and from the port's params; ``repro_torch.core.apply.save_ptq`` /
``load_ptq`` are the typed entry points.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedTensor

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
