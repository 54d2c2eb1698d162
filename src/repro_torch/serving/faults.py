"""Deterministic fault injection for the serving stack (port of
``repro/serving/faults.py``).

A seedable :class:`FaultPlan` schedules faults at **named injection sites**
threaded through the pager, the swap path, the prefix cache and the engine
step, so a chaos run is reproducible: the same plan, seed and workload fire
the same faults at the same probes, and a regression is a diffable event
log, not a flake.  The draws are numpy's, consumed in probe order, so a plan
fires where the reference's fires on the same workload.

Injection sites (the component that probes each):

==================  =========================================================
``page_alloc``      ``PagePool.can_alloc`` reports an allocator outage
``page_grow``       ``PagePool.grow`` raises :class:`TransientFault` before
                    allocating (bounded retries; a fault mid-plan is rolled
                    back by the scheduler)
``pool_pressure``   ``PagePool.can_alloc`` withholds ``value`` phantom pages
                    for ``duration`` engine steps
``swap_drain``      ``_drain_swap_buffers`` leaves a device→host copy "in
                    flight" this step (resume before drain)
``swap_corrupt``    a drained host swap image has a byte flipped after its
                    CRC-32 was taken: caught at swap-in, the victim
                    re-prefills
``prefix_evict``    ``PrefixCache.match`` force-evicts the matched evictable
                    pages and reports a miss (the admission goes cold)
``decode_launch``   the decode launch fails before dispatch (nothing
                    written; the step retries on a bounded budget)
``prefill_launch``  the same for the chunk-prefill launch
``fixed_drain``     ``swap_drain`` for images carrying fixed-rows state
``enc_evict``       ``PrefixCache.match_exact`` force-evicts a matched
                    encoder page set (the admission encodes afresh)
==================  =========================================================

The engine probes ``fixed_drain`` on hybrid slots' images and
``enc_evict`` on an encoder-decoder's exact-match hits.  A probe costs one
``is None`` check when no plan is installed.

A :class:`FaultSpec` fires when all of its set conditions hold (``step``:
engine step index, ``op``: the site's N-th probe, ``every``: periodic,
``prob``: seeded Bernoulli per probe), at most ``times`` times (``None`` =
unlimited).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

SITES = (
    "page_alloc", "page_grow", "pool_pressure", "swap_drain", "swap_corrupt",
    "prefix_evict", "decode_launch", "prefill_launch", "fixed_drain",
    "enc_evict",
)


class TransientFault(RuntimeError):
    """An injected, retryable failure (a page allocation that would have
    succeeded).  Handlers retry on a bounded budget; exhausting it turns the
    request terminal (``finish_reason="failed"``)."""


class SimulatedDeviceError(RuntimeError):
    """An injected launch failure (decode / prefill dispatch), raised before
    any state changes, so a retry next step is always sound."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.  Conditions AND-combine; unset ones are ignored.
    ``times`` bounds the fires (``None`` = unlimited); ``value`` is the
    site's payload (``pool_pressure``: phantom pages withheld) and
    ``duration`` the steps a step-anchored pressure spike lasts."""
    site: str
    step: Optional[int] = None      # fire while the engine step index matches
    op: Optional[int] = None        # fire on the site's N-th probe (0-based)
    every: Optional[int] = None     # fire on every N-th probe
    prob: float = 0.0               # seeded Bernoulli per probe
    times: Optional[int] = 1        # max fires (None = unlimited)
    value: int = 0                  # site payload (pressure pages)
    duration: int = 1               # pool_pressure: steps the spike lasts

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known: {SITES}")
        if (self.step is None and self.op is None and self.every is None
                and not self.prob):
            raise ValueError(f"spec for {self.site!r} sets no firing "
                             "condition (step/op/every/prob)")
        if self.every is not None and self.every < 1:
            raise ValueError("every must be >= 1")


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    Components probe the plan (:meth:`fires`); the engine advances its step
    clock (:meth:`begin_step`).  All randomness comes from one
    ``np.random.default_rng(seed)`` consumed in probe order.  ``injected``
    counts fires per site, ``log`` holds ``(step, site, probe_index)`` per
    fire, and ``sink`` (the engine's metrics hook) receives every fired site
    the moment it fires."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._ops: Dict[str, int] = {s: 0 for s in SITES}
        self._fires_left = [s.times for s in self.specs]
        self._step = -1                  # before the first begin_step
        self.injected: Dict[str, int] = {s: 0 for s in SITES}
        self.log: List[tuple] = []
        self.pressure_hits = 0           # probes that saw an active window
        self.sink = None                 # callable(site) on fire (metrics)

    def begin_step(self, step_index: int) -> None:
        """The current engine step index (step-anchored specs key off it)."""
        self._step = step_index

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def fires(self, site: str) -> bool:
        """Probe ``site``: advance its op counter and fire if every condition
        of some spec holds (first match wins and spends its budget)."""
        opi = self._ops[site]
        self._ops[site] = opi + 1
        for i, spec in enumerate(self.specs):
            if spec.site != site or spec.site == "pool_pressure":
                continue
            left = self._fires_left[i]
            if left is not None and left <= 0:
                continue
            if spec.step is not None and spec.step != self._step:
                continue
            if spec.op is not None and spec.op != opi:
                continue
            if spec.every is not None and opi % spec.every != 0:
                continue
            if spec.prob and not (self._rng.random() < spec.prob):
                continue
            if left is not None:
                self._fires_left[i] = left - 1
            self.injected[site] += 1
            self.log.append((self._step, site, opi))
            if self.sink is not None:
                self.sink(site)
            return True
        return False

    def pressure_pages(self) -> int:
        """Phantom pages withheld from ``can_alloc`` this step: the summed
        ``value`` of every ``pool_pressure`` spec whose ``[step, step +
        duration)`` window covers the current step.  A condition, not an
        event: polling it spends no budget and no draw."""
        total = 0
        for spec in self.specs:
            if spec.site != "pool_pressure" or spec.step is None:
                continue
            if spec.step <= self._step < spec.step + spec.duration:
                total += spec.value
        if total:
            self.pressure_hits += 1
        return total

    def pressure_active(self) -> bool:
        return self.pressure_pages() > 0


def corrupt_host_image(rows):
    """``rows`` (a swap image, ``{"layers": [{leaf: tensor}]}`` on the host)
    with byte 0 of its first leaf (first layer, first leaf name in sorted
    order) flipped: the ``swap_corrupt`` payload.  The flip goes into a
    copy of that leaf, and the tree is rebuilt around it, so no buffer a
    device→host copy may still write is touched."""
    layers = rows["layers"]
    name = sorted(layers[0])[0]
    bad = layers[0][name].clone()
    bad.view(-1).view(torch.uint8)[0] ^= 0xFF
    return {"layers": [{**layers[0], name: bad}] + list(layers[1:])}


def corrupt_swap_image(rows, fixed):
    """A whole swap image (KV ``rows``, fixed-rows state ``fixed``, either
    None) with byte 0 of its first leaf flipped: the reference's first leaf
    of ``{"kv": rows, "fixed": fixed}``, i.e. the fixed rows' ``conv_bc``
    when the image has fixed rows, else :func:`corrupt_host_image`'s.
    Returns ``(rows, fixed)``; the flip goes into a copy."""
    if fixed is None:
        return corrupt_host_image(rows), None
    name = sorted(fixed)[0]
    bad = fixed[name].clone()
    bad.view(-1).view(torch.uint8)[0] ^= 0xFF
    return rows, {**fixed, name: bad}
