"""A cell's files, found by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` of its entry in ``configs``;
- a traffic mix: ``traffic/<mix>.json``, and its loop, ``loops/<loop>.py``;
- a per-layer metric: ``metrics/<metric>.py`` and its ``read(rec)``;
- a model family's op list, ``roofline/<family>.py``, and its plain
  reference block, ``reference/<family>.py``.

Every function takes the directory to look in, so that a test can place
new files elsewhere and see them found.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

PB = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = PB.parent                                   # the checkout


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str, base: Path = PB) -> dict:
    return json.loads((Path(base) / "traffic" / f"{name}.json").read_text())


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _listed(m, cell)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The cell's per-layer metrics: those that list it, and those with no
    list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def _load(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: Path = PB) -> Callable:
    return _load(Path(base) / "metrics" / f"{name}.py",
                 "perfbench_metric_").read


def loop_kind(name: str, base: Path = PB):
    """The module ``loops/<name>.py``: ``feed(loop, now)`` and
    ``warm(loop)``."""
    return _load(Path(base) / "loops" / f"{name}.py", "perfbench_loop_")


def readers(names: List[str], base: Path = PB) -> Dict[str, Callable]:
    return {n: reader(n, base) for n in names}
