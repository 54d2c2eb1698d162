"""What the per-layer metric readers read, and the arithmetic they share.

A reader is ``perfbench/metrics/<metric name>.py`` with a function
``read(rec: Record) -> float | None``; None (nothing to read) leaves the
metric out of the result line.  A share of a roofline or of a peak is
never 0: with no work or no device time to divide by, it is None.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from perfbench.harness.profile import Trace
from perfbench.harness.stats import Rec
from perfbench.roofline import count


@dataclasses.dataclass
class Record:
    """One traced run: the cell's files, the window, every step the window
    ran, every request the loop sent, the engine's counters when the
    window opened and closed, and the profiled slice's trace."""
    config: dict
    mix: dict
    t0: float
    t1: float
    steps: list            # loop.StepRec
    requests: List[Rec]
    stats0: dict
    stats1: dict
    trace: Optional[Trace]


def step_mfu(rec: Record) -> Optional[float]:
    """Sum of the working steps' bounds over the sum of their host wall
    times, in %, over the window's steps outside the profiled slice."""
    steps = [s for s in rec.steps if s.worked > 0 and not s.profiled]
    wall = sum(s.t_b - s.t_a for s in steps)
    bound = sum(count.step_cost(rec.config, s.work).bound_s() for s in steps)
    return 100.0 * bound / wall if wall > 0 and bound > 0 else None


def kernel_roofline(rec: Record, calls_fn, pattern: str) -> Optional[float]:
    """The analytic bound of an op class's calls in the profiled steps over
    the device time of its kernels in the slice, in %."""
    if rec.trace is None:
        return None
    bound = sum(count.calls_bound_s(calls_fn(rec.config, s.work))
                for s in rec.steps if s.profiled)
    dev = rec.trace.device_s(pattern)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None


def device_idle_pct(rec: Record) -> Optional[float]:
    tr = rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def decode_rows_per_step(rec: Record) -> Optional[float]:
    steps = rec.stats1["steps"] - rec.stats0["steps"]
    rows = rec.stats1["active_slot_steps"] - rec.stats0["active_slot_steps"]
    return rows / steps if steps > 0 else None
