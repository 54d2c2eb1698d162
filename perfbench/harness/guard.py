"""The import check: the benchmark measures the PyTorch port alone, so no
module of JAX, Flax or the JAX package (``repro``) may be loaded in the
process that prints a result.  Names are compared by their whole top-level
part (before the first dot): ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List

BANNED = ("jax", "jaxlib", "flax", "repro")


def banned(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))
