"""The traced run's device trace: ``torch.profiler`` over a steady slice
of the window, reduced to kernel intervals and the benchmark's host spans.

The slice starts and stops between two engine steps, each time after a
``torch.cuda.synchronize()``, so the kernels inside it are exactly those of
the steps run inside it.  Its length is the span ``perfbench.slice`` that
encloses it.  Device work is every kernel, copy and fill of the trace.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SLICE = "perfbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]   # (name, start s, end s)
    spans: List[Tuple[str, float, float]]     # host spans in the slice
    t0: float                                 # the slice's start (s)

    def device_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n))


class Slice:
    """Start with :meth:`start`, stop with :meth:`stop`, then :meth:`trace`."""

    def __init__(self):
        self.prof: Optional[torch.profiler.profile] = None
        self._mark = None
        self.cost: Dict[str, float] = {}

    @staticmethod
    def warm() -> None:
        """Profile one small kernel, so that the tracer's first start-up
        falls in the set-up and not in the window."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self._mark = torch.profiler.record_function(SLICE)
        self._mark.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.prof.stop()

    def trace(self) -> Trace:
        """The slice's trace; ``cost`` then holds the seconds the tracer's
        start, stop and export took on the host."""
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.prof = None
        return reduce(events)


def reduce(events: List[dict]) -> Trace:
    """Kernels and host spans of a Chrome trace, clipped to the slice."""
    mark = [e for e in events if e.get("name") == SLICE and "dur" in e]
    if not mark:
        raise RuntimeError("the profiled slice's span is not in the trace")
    lo = float(mark[0]["ts"]) * 1e-6
    hi = lo + float(mark[0]["dur"]) * 1e-6
    kernels, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"]) * 1e-6
        t = s + float(e["dur"]) * 1e-6
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            kernels.append((e.get("name", "?"), s, t))
        elif cat == "user_annotation" and e["name"] != SLICE:
            spans.append((e["name"], s, t))
    kernels.sort(key=lambda k: k[1])
    return Trace(window_s=hi - lo, busy_s=_union(kernels), kernels=kernels,
                 spans=spans, t0=lo)


def _union(iv) -> float:
    busy, end = 0.0, None
    for _, s, t in iv:
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy


def _short(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list, at most 120 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def device_ops(tr: Trace, top: int = 10) -> List[list]:
    tot: Dict[str, float] = defaultdict(float)
    for n, s, t in tr.kernels:
        tot[_short(n)] += t - s
    return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:top]]


def idle_gaps(tr: Trace, top: int = 10) -> List[list]:
    """Device idle time inside the slice, by the innermost host span open
    where each gap starts (``perfbench loop`` outside every span)."""
    gaps, end = [], tr.t0
    for _, s, t in tr.kernels:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if tr.t0 + tr.window_s > end:
        gaps.append((end, tr.t0 + tr.window_s))
    # the spans nest (one host thread): sweep them with a stack, whose top
    # is the innermost span open at the gap's start
    spans = sorted(tr.spans, key=lambda x: (x[1], -x[2]))
    tot: Dict[str, float] = defaultdict(float)
    stack: List[tuple] = []
    j = 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] <= a:
            while stack and stack[-1][2] <= spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] <= a:
            stack.pop()
        tot[stack[-1][0] if stack else "perfbench loop"] += b - a
    return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:top]]
