"""Per-request lifecycle timelines + per-step engine journal + Chrome export
(port of ``repro/serving/trace.py``; the export is byte-identical to the
reference's for the same recorder).

Two recording surfaces, both bounded-memory and host-only (no device work, no
RNG: recording must never perturb the decode step or the sampling stream):

- :class:`RequestTimeline` — timestamped lifecycle events of one request
  (``submit → admit → prefill_chunk* → first_token → preempt/swap_in →
  retry/fault → finish``), each ``(t, name, args)``.  The engine derives its
  latency histograms (TTFT, ITL, queue wait, swap stall, e2e) from these
  timestamps *as they are recorded*, so the histograms are engine-internal
  truth, not a benchmark-side stopwatch.  Finished timelines move to a
  bounded deque (oldest evicted), live ones are keyed by uid.

- :class:`StepRecord` — one journal row per engine step: decode batch size,
  chunk tokens scheduled, pages grown/COW/evicted this step, fault probes
  fired, pool occupancy.  The journal is a ring buffer (``deque(maxlen)``),
  so a million-step serve holds the last N steps only.

:func:`to_chrome_trace` renders both into Chrome ``trace_event`` JSON
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
— one track (tid) per slot plus a queue track, ``X`` complete-events for
decode/chunk work, ``C`` counter events for pool occupancy, ``i`` instants
for lifecycle marks, and ``s``/``f`` flow events stitching a request's
preempt to its resume across tracks.  Load the file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.  Field ordering and float
rounding are fixed so the export is byte-stable under a fake clock (golden
tested)."""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["RequestTimeline", "StepRecord", "TraceRecorder",
           "to_chrome_trace", "write_chrome_trace"]


@dataclasses.dataclass
class RequestTimeline:
    """Lifecycle events of one request + the derived-metric cursors the
    engine updates as it observes (when the request last emitted a token,
    when it was preempted, when it was admitted)."""
    uid: int
    events: List[Tuple[float, str, dict]] = dataclasses.field(
        default_factory=list)
    submit_t: Optional[float] = None
    admit_t: Optional[float] = None      # first admission only (queue wait)
    first_token_t: Optional[float] = None
    last_emit_t: Optional[float] = None  # previous token time (ITL anchor)
    preempt_t: Optional[float] = None    # open preemption (swap stall anchor)
    finish_t: Optional[float] = None

    def add(self, t: float, name: str, **args) -> None:
        self.events.append((t, name, args))


@dataclasses.dataclass
class StepRecord:
    """One engine step in the journal ring."""
    step: int
    t0: float
    t1: float
    decode_slots: Tuple[int, ...]          # slots that decoded a token
    chunks: Tuple[Tuple[int, int, int], ...]  # (slot, uid, chunk_tokens)
    preempts: Tuple[Tuple[int, int], ...]  # (uid, slot) swapped out
    resumes: Tuple[Tuple[int, int], ...]   # (uid, slot) swapped back in
    faults: Tuple[str, ...]                # fault sites fired this step
    pages_used: int
    pages_free: int
    pages_grown: int                       # lazy growth this step
    pages_cow: int                         # COW copies this step
    pages_evicted: int                     # cache evictions this step

    @property
    def chunk_tokens(self) -> int:
        return sum(c[2] for c in self.chunks)


class TraceRecorder:
    """Bounded recorder the engine writes through.  ``enabled=False`` turns
    every method into a no-op returning immediately — the metrics-off
    engine configuration used by the overhead benchmark."""

    def __init__(self, clock: Callable[[], float], *, enabled: bool = True,
                 journal_len: int = 2048, keep_finished: int = 1024):
        self.clock = clock
        self.enabled = enabled
        self.journal: deque = deque(maxlen=journal_len)
        self.live: Dict[int, RequestTimeline] = {}
        self.finished: deque = deque(maxlen=keep_finished)
        # per-step scratch, flushed by end_step()
        self._step: Optional[int] = None
        self._t0 = 0.0
        self._chunks: List[Tuple[int, int, int]] = []
        self._preempts: List[Tuple[int, int]] = []
        self._resumes: List[Tuple[int, int]] = []
        self._faults: List[str] = []

    # ------------------------------------------------------- timelines ---
    def timeline(self, uid: int) -> RequestTimeline:
        tl = self.live.get(uid)
        if tl is None:
            tl = self.live[uid] = RequestTimeline(uid)
        return tl

    def event(self, uid: int, name: str, **args) -> float:
        """Record a lifecycle event now; returns the timestamp used so the
        caller can derive a metric from the same reading."""
        t = self.clock()
        if self.enabled:
            self.timeline(uid).add(t, name, **args)
        return t

    def finish(self, uid: int) -> None:
        tl = self.live.pop(uid, None)
        if tl is not None:
            self.finished.append(tl)

    def all_timelines(self) -> List[RequestTimeline]:
        """Finished (oldest first) then live, by uid — stable export order."""
        return list(self.finished) + [
            self.live[u] for u in sorted(self.live)]

    # --------------------------------------------------------- journal ---
    def begin_step(self, step: int) -> None:
        if not self.enabled:
            return
        self._step = step
        self._t0 = self.clock()
        self._chunks = []
        self._preempts = []
        self._resumes = []
        self._faults = []

    def note_chunk(self, slot: int, uid: int, tokens: int) -> None:
        if self.enabled and self._step is not None:
            self._chunks.append((slot, uid, tokens))

    def note_preempt(self, uid: int, slot: int) -> None:
        if self.enabled and self._step is not None:
            self._preempts.append((uid, slot))

    def note_resume(self, uid: int, slot: int) -> None:
        if self.enabled and self._step is not None:
            self._resumes.append((uid, slot))

    def note_fault(self, site: str) -> None:
        if self.enabled and self._step is not None:
            self._faults.append(site)

    def end_step(self, decode_slots, *, pages_used: int, pages_free: int,
                 pages_grown: int, pages_cow: int,
                 pages_evicted: int) -> None:
        if not self.enabled or self._step is None:
            return
        self.journal.append(StepRecord(
            step=self._step, t0=self._t0, t1=self.clock(),
            decode_slots=tuple(decode_slots), chunks=tuple(self._chunks),
            preempts=tuple(self._preempts), resumes=tuple(self._resumes),
            faults=tuple(self._faults), pages_used=pages_used,
            pages_free=pages_free, pages_grown=pages_grown,
            pages_cow=pages_cow, pages_evicted=pages_evicted))
        self._step = None


# ------------------------------------------------------- chrome export ---
def _us(t: float, base: float) -> float:
    """Microseconds since base, rounded to 3 decimals (ns resolution) so the
    JSON is byte-stable across platforms' float formatting."""
    return round((t - base) * 1e6, 3)


def _ev(ph: str, name: str, ts: float, *, pid: int = 1, tid: int = 0,
        **extra) -> dict:
    """One trace event with fixed key order: name, ph, ts first — golden
    files diff cleanly."""
    d: Dict[str, Any] = {"name": name, "ph": ph, "ts": ts,
                         "pid": pid, "tid": tid}
    d.update(extra)
    return d


#: track ids: 0 = queue/lifecycle, slot s = s + 1
_QUEUE_TID = 0


def to_chrome_trace(rec: TraceRecorder, *, base: Optional[float] = None,
                    n_slots: Optional[int] = None) -> dict:
    """Render a recorder into a Chrome ``trace_event`` object.

    - metadata events name the process and one thread per slot (+ queue);
    - each journal step emits an ``X`` slice per decode slot ("decode") and
      per chunk row ("prefill_chunk", with token count), plus a ``C``
      counter sample of pool occupancy;
    - each timeline emits ``i`` instants for lifecycle marks and an
      ``s``→``f`` flow (id = uid) from every ``preempt`` to the matching
      ``swap_in``, which Perfetto draws as an arrow across slot tracks.
    """
    steps = list(rec.journal)
    tls = rec.all_timelines()
    if base is None:
        cands = [s.t0 for s in steps] + [
            tl.events[0][0] for tl in tls if tl.events]
        base = min(cands) if cands else 0.0
    if n_slots is None:
        seen = [s for st in steps for s in st.decode_slots]
        seen += [c[0] for st in steps for c in st.chunks]
        n_slots = (max(seen) + 1) if seen else 0

    events: List[dict] = [
        _ev("M", "process_name", 0, args={"name": "serving-engine"}),
        _ev("M", "thread_name", 0, tid=_QUEUE_TID,
            args={"name": "queue/lifecycle"}),
    ]
    for s in range(n_slots):
        events.append(_ev("M", "thread_name", 0, tid=s + 1,
                          args={"name": f"slot {s}"}))

    for st in steps:
        ts, dur = _us(st.t0, base), max(_us(st.t1, base) - _us(st.t0, base),
                                        0.001)
        for slot, uid, ntok in st.chunks:
            events.append(_ev("X", "prefill_chunk", ts, tid=slot + 1,
                              dur=dur,
                              args={"step": st.step, "uid": uid,
                                    "tokens": ntok}))
        for slot in st.decode_slots:
            events.append(_ev("X", "decode", ts, tid=slot + 1, dur=dur,
                              args={"step": st.step}))
        events.append(_ev("C", "pool_pages", ts,
                          args={"used": st.pages_used,
                                "free": st.pages_free}))
        for site in st.faults:
            events.append(_ev("i", f"fault:{site}", ts, s="p"))

    for tl in tls:
        for t, name, args in tl.events:
            ts = _us(t, base)
            slot = args.get("slot")
            tid = (slot + 1) if slot is not None else _QUEUE_TID
            if name == "preempt":
                # flow start: Perfetto draws preempt -> swap_in as an arrow
                events.append(_ev("i", "preempt", ts, tid=tid, s="t",
                                  args={"uid": tl.uid, **args}))
                events.append(_ev("s", "swap", ts, tid=tid, id=tl.uid,
                                  cat="swap"))
            elif name == "swap_in":
                events.append(_ev("f", "swap", ts, tid=tid, id=tl.uid,
                                  cat="swap", bp="e"))
                events.append(_ev("i", "swap_in", ts, tid=tid, s="t",
                                  args={"uid": tl.uid, **args}))
            else:
                events.append(_ev("i", name, ts, tid=tid, s="t",
                                  args={"uid": tl.uid, **args}))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, rec: TraceRecorder, *,
                       base: Optional[float] = None,
                       n_slots: Optional[int] = None) -> dict:
    """Serialize :func:`to_chrome_trace` to ``path`` (stable separators,
    sorted nothing — insertion order IS the stable order).  Returns the
    object written."""
    obj = to_chrome_trace(rec, base=base, n_slots=n_slots)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    return obj
