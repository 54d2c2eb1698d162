"""Continuous-batching serving engine with paged KV (port of the dense core
of ``repro/serving/engine.py``).

The paper's deployment story: fp weights are quantized on load
(SmoothQuant+, :func:`load_or_quantize`) and requests are served from a
fixed-slot continuous batcher over a paged KV cache:

- admission is FCFS and batched (``serving/scheduler.py``): slots and pages
  only; prompt tokens prefill in length-bucketed chunks under a token budget
  (``max_prefill_tokens``), interleaved with decode (mixed steps);
- every step decodes one token for every slot past its prompt, straight
  against the pages (W4A16 linears and the paged-attention kernels on the
  GPU), sampling per slot;
- ``cfg.kv_quant`` keeps the pages in int8 with f32 row scales;
  ``cfg.act_quant="a8_prefill"`` runs prefill-chunk GEMMs of A8-eligible
  layers on per-token int8 activations (decode stays A16);
- pages grow lazily as a slot's write position crosses a page boundary;
  finished slots free their pages at once.  On pool exhaustion the engine
  **preempts** the youngest active slot(s): their private pool rows are
  gathered and copied to pinned host buffers asynchronously (raw codes and
  scales, bit for bit; the copy is awaited after the step's decode, where
  the image's CRC-32 is recorded), and the request requeues at the queue
  head.  It resumes by swap-in (fresh pages, the rows scattered back in
  place), never by re-prefilling, unless its host image fails its CRC: then
  it re-prefills prompt + generated tokens once, and a second mismatch
  fails it.  An admission watermark (one free page per decoding slot) keeps
  preemption a pressure-relief valve;
- on a card the decode step runs as one CUDA graph per engine
  (``serving/decode_graph.py``), captured at the first decode step and
  replayed after in-place updates of its token, position and table inputs;
  the CPU runs it eagerly, as do prefill chunks everywhere.

- **shared-prefix KV cache** (``prefix_cache=True``): full prompt pages
  are block-hash indexed (``serving/prefix_cache.py``); a request whose
  prompt extends a cached prefix attaches the matched pages (refcounted,
  read-only; copy-on-write guards any write) and prefills only its
  uncached suffix, reading the prefix through the page table.  Finished
  slots index their generated full pages too.  Unreferenced cached pages
  stay resident as an LRU reserve and are evicted exactly when an
  allocation needs them; preemption never swaps them out;
- **request lifecycle**: every submitted request ends in one of
  :data:`FINISH_REASONS`; per-request TTFT and total deadlines, ``cancel``
  in any phase, a bounded queue (``max_queue``) that sheds load, and, with
  ``strict=False``, quarantine of a request that trips a pager invariant or
  stalls admission;
- **fault injection** (``fault_plan``, ``serving/faults.py``): seeded faults
  at the pager, prefix-cache, swap and launch sites, each recovered through
  a bounded retry budget, a requeue or a cold prefill;
- **observability** (``metrics=True``): TTFT, ITL, e2e, queue-wait and
  swap-stall histograms, a per-step journal and request timelines
  (``serving/metrics.py``, ``serving/trace.py``), all host-side and on one
  engine clock, read through :meth:`ServingEngine.metrics_snapshot` and
  exported as a Chrome trace.  Whether or not ``metrics`` is on, every
  step is cut into host phases (``serving/trace.py:span``): each phase's
  self host seconds and calls accumulate in ``EngineStats.host_s`` /
  ``host_n``, and while ``torch.profiler`` records each phase is a span
  ``engine.<phase>``, each call that blocks the host on the device a span
  ``sync.<site>`` (counted too), beside the device's kernels.

**State leaves** (``api.state_leaves``): a slot owns KV pages and, for the
hybrid SSM stack (Zamba2), fixed rows of per-layer Mamba2 state ``[M, B,
...]``: O(1) per slot, never paged, zeroed at every fresh admission (a
previous occupant's rows are stale and, unlike KV pages, cannot be masked
off), frozen for rows that do not decode (the decode step's ``active``
mask), and swapped in the same host image as the slot's private KV rows
(one CRC; the ``fixed_drain`` fault site).  An encoder-decoder slot
(Whisper) owns read-only encoder pages (``shared_ro``) in the pager's
``"enc"`` group: at admission the request's frames are hashed
(``PrefixCache.data_hashes``, the reference's bytes) and an exact match
attaches the resident pages of an earlier request with the same audio;
otherwise the encoder runs once and its cross K/V rows are scattered into
fresh pages, which are indexed for the next one (the ``enc_evict`` fault
site).  Those pages never enter a swap image: preemption detaches them
under swap holds and resume reattaches them.  A hybrid or encoder-decoder
engine refuses the token prefix cache: KV pages cannot capture an SSM
boundary state, and cross attention depends on the encoder input.  A
config with no paged path (RWKV6) raises :class:`UnsupportedModelError`
at construction.

Still to port (ROADMAP.md): per-bucket prefill graphs.

The engine runs on the GPU by default and raises when there is no card;
``device="cpu"`` runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import zipfile
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import kv_cache as KV
from repro_torch.serving.decode_graph import DecodeGraph
from repro_torch.serving.faults import (FaultPlan, TransientFault,
                                        corrupt_swap_image)
from repro_torch.serving.metrics import MetricsRegistry, format_pending
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import sample_per_slot
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.trace import ENCLOSING, TraceRecorder, span

#: Terminal states every submitted request reaches exactly one of:
#:   completed — decoded its EOS token
#:   length    — hit max_tokens or the max_seq cache cap
#:   deadline  — expired a TTFT/total deadline (queued, swapped, or active)
#:   cancelled — explicit :meth:`ServingEngine.cancel`
#:   rejected  — refused at :meth:`ServingEngine.submit` (validation or
#:               bounded-queue backpressure); never entered the queue
#:   failed    — gave up after exhausting its fault-retry budget, or was
#:               quarantined by a non-strict engine (invariant violation /
#:               admission stall)
FINISH_REASONS = ("completed", "length", "deadline", "cancelled", "rejected",
                  "failed")


class UnsupportedModelError(NotImplementedError):
    """Raised at :class:`ServingEngine` construction for a config with no
    paged serving path (RWKV6: its state is O(1) per slot); a
    :class:`NotImplementedError`, as in the reference."""


class RejectedRequest(ValueError):
    """Raised by :meth:`ServingEngine.submit` for an invalid request (empty
    prompt, ``max_tokens <= 0``, over-long prompt, missing or malformed
    encoder frames, frames on a decoder-only config), after marking it
    ``finish_reason="rejected"``.  Bounded-queue backpressure does not
    raise: a full queue returns False."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [T] int32
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    arrival_t: float = 0.0
    deadline_s: Optional[float] = None       # total wall budget from arrival
    ttft_deadline_s: Optional[float] = None  # first-token budget from arrival
    frames: Optional[np.ndarray] = None      # [T_enc, d_model] (enc-dec only)
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    finish_reason: Optional[str] = None      # one of FINISH_REASONS when done
    error: Optional[str] = None              # detail for rejected/failed
    retries: int = 0              # transient-fault retries charged so far
    reprefills: int = 0           # swap-corruption re-prefills (budget: 1)
    submit_seq: int = -1          # FCFS age; youngest (max) is preempted first
    # swap-corruption replay: the token that must feed the next decode step
    # after the re-prefill lands (instead of sampling a duplicate), and how
    # many output tokens were folded into the prompt by the re-prefill
    _replay_tok: Optional[int] = None
    _gen_in_prompt: int = 0
    # the prompt's chain hashes, memoized by the scheduler's first match
    _block_hashes: Optional[List[bytes]] = None
    # the frames' encoder-page hashes, memoized at the first admission
    _enc_hashes: Optional[List[bytes]] = None


@dataclasses.dataclass
class _SwapState:
    """Host image of a preempted slot: everything needed to resume it bit
    for bit without re-prefilling.  Shared and cached pages are not part of
    the image: they stay resident under a swap hold and resume re-acquires
    them (``kept``); only private pages round-trip as rows.  An enc-dec
    slot's encoder pages carry no bytes: they stay detached under swap
    holds (``enc_pages``) until resume reattaches them."""
    rows: Any                     # {"layers": [{leaf: [n, PS, ...]}]} (host)
    kept: List[Tuple[int, int]]   # (logical_idx, page) left resident
    private_lis: List[int]        # logical idxs of the swapped rows
    pos: int                      # next write position
    last_tok: int                 # token feeding the next decode step
    nbytes: int                   # swap-buffer bytes (stats)
    fbytes: int = 0               # of which fixed-rows (SSM state) bytes
    fixed_rows: Any = None        # {leaf: [M, 1, ...]} SSM state (host)
    dev_rows: Any = None          # device gather buffers until drained
    copied: Optional[Any] = None  # CUDA event: the device→host copy is done
    on_host: bool = False         # drained: device buffer freed, CRC taken
    checksum: Optional[int] = None  # CRC-32 of the host image (drain time)
    corrupted: bool = False       # injected rot applied (flip once only)
    enc_pages: Optional[List[int]] = None  # detached read-only encoder pages
    enc_len: int = 0              # valid encoder rows to restore


@dataclasses.dataclass
class EngineStats:
    decoded_tokens: int = 0
    prefilled_tokens: int = 0
    steps: int = 0
    completed: int = 0
    prefill_batches: int = 0      # joint prefill launches (≤ admitted reqs)
    preemptions: int = 0          # slots swapped out under pool pressure
    resumes: int = 0              # swapped slots re-admitted (swap-in)
    grown_pages: int = 0          # pages added by lazy decode growth
    swapped_out_bytes: int = 0    # pool bytes copied device -> host
    swapped_in_bytes: int = 0     # pool bytes copied host -> device
    swapped_fixed_bytes: int = 0  # of swapped_out: fixed-rows state bytes
    swapped_fixed_in_bytes: int = 0  # of swapped_in: fixed-rows state bytes
    idle_steps: int = 0           # drain iterations with nothing decodable
    max_active: int = 0           # peak concurrent decoding slots
    active_slot_steps: int = 0    # sum of active slots over steps (/steps)
    # shared-prefix cache:
    admitted: int = 0             # fresh admissions (resumes not counted)
    prefix_hits: int = 0          # admissions that matched >= 1 cached page
    prefix_matched_tokens: int = 0  # prompt tokens served from the cache
    pages_shared: int = 0         # page attachments (shared, not allocated)
    pages_inserted: int = 0       # pages newly indexed by the cache
    pages_evicted: int = 0        # unreferenced cached pages reclaimed (LRU)
    cow_copies: int = 0           # copy-on-write page duplications
    # encoder pages (enc-dec):
    enc_hits: int = 0             # admissions reusing cached encoder pages
    enc_encodes: int = 0          # admissions that ran the encoder
    # request lifecycle:
    rejected: int = 0             # refused at submit (validation/backpressure)
    expired: int = 0              # terminal by TTFT/total deadline
    cancelled: int = 0            # terminal by cancel()
    failed: int = 0               # terminal by retry exhaustion / quarantine
    retries: int = 0              # fault recoveries attempted (all kinds)
    faults_injected: int = 0      # FaultPlan fires observed (mirror of plan)
    # per prefill batch: (padded rows of its GEMMs, largest prefix_len)
    chunk_rows: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    # host phases of step() (serving/trace.py:span): self seconds and calls
    # by phase ("step", "admit", ..., "sync.<site>"), on the engine clock
    host_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    host_n: Dict[str, int] = dataclasses.field(default_factory=dict)


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, *, batch_size: int = 8,
                 max_seq: int = 256, page_size: int = 16,
                 num_pages: Optional[int] = None, eos_id: int = 1,
                 seed: int = 0, max_prefill_tokens: Optional[int] = None,
                 prefill_mode: str = "bucketed", reservation: str = "lazy",
                 prefix_cache: bool = False, max_queue: Optional[int] = None,
                 strict: bool = True, fault_plan: Optional[FaultPlan] = None,
                 retry_budget: int = 3, metrics: bool = True,
                 device="cuda"):
        ok, why = api.paged_supported(cfg)
        if not ok:
            raise UnsupportedModelError(f"paged serving: {why}")
        self.device = resolve_device(device)
        if cfg.act_quant not in ("a16", "a8_prefill"):
            raise ValueError(
                f"act_quant={cfg.act_quant!r}: expected 'a16' or 'a8_prefill' "
                "(a8_prefill routes prefill-chunk GEMMs on A8-eligible layers "
                "through the int8-activation kernel; decode stays A16)")
        self.cfg = cfg.check()
        self.params = params
        self.B = batch_size
        self.PS = page_size
        self.P = -(-max_seq // page_size)          # pages per slot
        self.S = self.P * page_size                # max_seq rounded to pages
        self.eos = eos_id
        # which state leaves a slot of this config owns
        self.leaves = api.state_leaves(cfg)
        self.has_fixed = api.FIXED_ROWS in self.leaves
        self.has_enc = api.SHARED_RO in self.leaves
        # +1: page 0 is the trash page.  An enc-dec slot also pages its
        # encoder K/V (the "enc" group, at most P pages), so the default
        # pool and the one-request floor double
        slot_pages = self.P * (2 if self.has_enc else 1)
        num_pages = num_pages or (batch_size * slot_pages + 1)
        if num_pages - 1 < slot_pages:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one max_seq request "
                f"({slot_pages} pages of {page_size} tokens + trash page)")
        self.pager = KV.PagePool(num_pages, page_size, batch_size, self.P,
                                 groups=("kv", "enc") if self.has_enc
                                 else ("kv",))
        if prefix_cache and (self.has_fixed or self.has_enc):
            raise ValueError(
                "prefix_cache=True is attention-only: KV pages cannot "
                "capture an SSM boundary state (hybrid) and cross-attention "
                "depends on the encoder input (enc-dec); enc-dec engines "
                "deduplicate encoder pages automatically instead")
        self.cache: Optional[PrefixCache] = (
            PrefixCache(self.pager, page_size,
                        mode=f"kvq={int(bool(cfg.kv_quant))}")
            if prefix_cache else None)
        # the exact-match index over read-only encoder pages: requests with
        # identical frames share one resident page set (the pool's evictor)
        self.enc_cache: Optional[PrefixCache] = (
            PrefixCache(self.pager, page_size, mode="enc")
            if self.has_enc else None)
        self.pools = api.init_paged_cache(cfg, num_pages, page_size,
                                          self.device)
        self.fixed = (api.init_fixed_state(cfg, batch_size, self.device)
                      if self.has_fixed else None)
        self.enc_len = np.zeros(batch_size, np.int32)  # valid encoder rows
        self.reservation = reservation
        self.sched = Scheduler(page_size=page_size, max_seq=self.S,
                               max_prefill_tokens=max_prefill_tokens,
                               mode=prefill_mode, reservation=reservation)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.pos = np.zeros(batch_size, np.int32)     # next write position
        self.last_tok = np.zeros(batch_size, np.int32)
        # a slot is prefilling while pos < pref_target, decoding after
        self.pref_target = np.zeros(batch_size, np.int32)
        self.queue: deque[Request] = deque()
        self.stats = EngineStats()
        self._swapped: Dict[int, _SwapState] = {}   # submit_seq -> image
        self._next_seq = 0

        # ----- request lifecycle -----
        # max_queue bounds the waiting line (submit sheds load past it);
        # strict keeps every invariant violation / admission stall a raise,
        # strict=False quarantines the offending request (failed) and keeps
        # serving everyone else
        self.max_queue = max_queue
        self.strict = strict
        self.retry_budget = retry_budget
        self.faults = fault_plan
        self.pager.faults = fault_plan
        for c in (self.cache, self.enc_cache):
            if c is not None:
                c.faults = fault_plan
        self._clock = time.perf_counter     # swappable in tests (deadlines)
        self._step_idx = 0                  # all engine steps (idle included)
        self._retry_pending = False         # a fault ate the last step's work

        # ----- observability -----
        # one clock (self._clock, bound late) drives the registry and the
        # recorder, so a test that swaps it gets deterministic histograms,
        # timelines and traces.  All recording is host-side bookkeeping: it
        # touches no tensor and no generator, so metrics on or off give the
        # same tokens; metrics=False keeps the registry (empty) so that
        # metrics_snapshot() stays well-formed
        self._obs = metrics
        self.metrics = MetricsRegistry(clock=lambda: self._clock())
        self.trace = TraceRecorder(lambda: self._clock(), enabled=metrics)
        self._h_ttft = self.metrics.histogram(
            "ttft_s", "submit -> first token (engine-internal)")
        # ITL gaps cluster within a decade, so 4x the bucket resolution
        self._h_itl = self.metrics.histogram(
            "itl_s", "gap between consecutive tokens of one request",
            per_decade=48)
        self._h_e2e = self.metrics.histogram(
            "e2e_s", "submit -> terminal state")
        self._h_qwait = self.metrics.histogram(
            "queue_wait_s", "submit -> first admission to a slot")
        self._h_swap = self.metrics.histogram(
            "swap_stall_s", "preempt (swap-out) -> swap-in resume")
        self._fault_ctr = self.metrics.counter(
            "faults_fired_total", "fault-plan probes fired, by site")
        if fault_plan is not None:
            fault_plan.sink = self._on_fault
        self._last_dec: List[int] = []      # decode slots of the last step
        self._sample_key = "sample"         # the phase _sample counts into

        # the compiled decode step (the reference jits it with the pools
        # donated): one CUDA graph on a card, eager on the CPU.  The graph
        # holds the pool tensors, so nothing may rebind self.pools; the step
        # holds no reference to the engine, so dropping the engine frees
        # the graph and its memory at once.
        # A hybrid step also holds the fixed-rows tensors (updated in place)
        # and reads an active[B] mask; an enc-dec step reads the rows'
        # encoder page tables and valid lengths.  These extra inputs
        # follow token, position and table, by name, in this order.
        extra = {}
        if self.has_fixed:
            extra["active"] = ((batch_size,), torch.bool)
        if self.has_enc:
            extra["enc_table"] = ((batch_size, self.P), torch.int32)
            extra["enc_len"] = ((batch_size,), torch.int32)
        self.step_extra = tuple(extra)
        self._decode_step = functools.partial(
            decode_step, params, self.pools, self.cfg, self.step_extra,
            fixed=self.fixed)
        self.decode_graph = (
            DecodeGraph(self._decode_step, batch_size, self.P, self.device,
                        extra)
            if self.device.type == "cuda" else None)

    # ----------------------------------------------------- observability ---
    def _phase(self, key: str) -> span:
        """The host phase ``key`` of a step: the span ``engine.<key>``,
        counted into ``stats.host_s`` / ``host_n`` on the engine clock."""
        return span("engine." + key, self.stats, self._clock, key)

    def _on_fault(self, site: str) -> None:
        """FaultPlan sink: each fire is a labeled counter increment and a
        journal mark, so a chaos run reconciles the plan's tally with the
        engine's counters."""
        if self._obs:
            self._fault_ctr.inc(site=site)
            self.trace.note_fault(site)

    def _note_finish(self, req: Request) -> None:
        """Close a request's timeline (any terminal reason but rejected)."""
        t = req.done_t
        tl = self.trace.timeline(req.uid)
        tl.add(t, "finish", reason=req.finish_reason)
        tl.finish_t = t
        self._h_e2e.observe(t - req.arrival_t)
        self.trace.finish(req.uid)

    # ------------------------------------------------------------- admin ---
    def _reject(self, req: Request, why: str, *, raise_: bool) -> bool:
        """Structured rejection: the request turns terminal now, never
        enters the queue and never holds a page."""
        req.finish_reason = "rejected"
        req.error = why
        req.done_t = self._clock()
        self.stats.rejected += 1
        if raise_:
            raise RejectedRequest(why)
        return False

    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; True when it entered the queue.  Invalid requests
        raise :class:`RejectedRequest`; a full bounded queue (``max_queue``)
        rejects without raising and returns False.  Either way the request
        is marked ``finish_reason="rejected"``."""
        if len(req.prompt) == 0:
            return self._reject(req, "empty prompt", raise_=True)
        if req.max_tokens <= 0:
            return self._reject(
                req, f"max_tokens must be >= 1, got {req.max_tokens}",
                raise_=True)
        if len(req.prompt) > self.S - 1:
            return self._reject(
                req, f"prompt of {len(req.prompt)} tokens exceeds "
                     f"max_seq-1={self.S - 1}", raise_=True)
        if self.has_enc:
            if req.frames is None:
                return self._reject(
                    req, "enc-dec config: request must carry encoder frames",
                    raise_=True)
            fr = np.asarray(req.frames)
            if fr.ndim != 2 or fr.shape[0] < 1 \
                    or fr.shape[1] != self.cfg.d_model:
                return self._reject(
                    req, f"frames must be [T_enc>=1, {self.cfg.d_model}], "
                         f"got {fr.shape}", raise_=True)
            if fr.shape[0] > self.S:
                return self._reject(
                    req, f"{fr.shape[0]} encoder frames exceed the "
                         f"{self.S}-row page budget", raise_=True)
            req.frames = fr
        elif req.frames is not None:
            return self._reject(
                req, "frames on a decoder-only config", raise_=True)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._reject(
                req, f"queue full ({self.max_queue} waiting)", raise_=False)
        req.prompt = np.asarray(req.prompt, np.int32)
        req.arrival_t = req.arrival_t or self._clock()
        req.submit_seq = self._next_seq
        self._next_seq += 1
        self.queue.append(req)
        if self._obs:
            tl = self.trace.timeline(req.uid)
            tl.submit_t = req.arrival_t
            tl.add(req.arrival_t, "submit", prompt=len(req.prompt))
        return True

    def cancel(self, uid: int) -> bool:
        """Cancel the request ``uid`` wherever it is: queued, swapped out,
        prefilling or decoding.  Its pages and swap holds free at once; the
        tokens it generated stay on ``req.output``.  False when no live
        request has ``uid``."""
        for r in list(self.queue):
            if r.uid == uid:
                self.queue.remove(r)
                self._finish_abnormal(r, "cancelled")
                return True
        for i, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self._evict_slot(i, "cancelled")
                return True
        return False

    # ------------------------------------------- terminal abnormal paths ---
    def _finish_abnormal(self, req: Request, reason: str,
                         error: Optional[str] = None) -> None:
        """Turn a request terminal off the happy path (deadline, cancelled,
        failed): its swap image is dropped and every kept-page hold
        released."""
        st = self._swapped.pop(req.submit_seq, None)
        if st is not None:
            for _, p in st.kept:
                self.pager.drop_hold(p)
            if st.enc_pages:
                self.pager.drop_group_holds(st.enc_pages)
        req.finish_reason = reason
        req.error = error
        req.done_t = self._clock()
        counter = {"deadline": "expired", "cancelled": "cancelled",
                   "failed": "failed"}[reason]
        setattr(self.stats, counter, getattr(self.stats, counter) + 1)
        if self._obs:
            self._note_finish(req)

    def _evict_slot(self, slot: int, reason: str,
                    error: Optional[str] = None) -> None:
        """Terminate the request in ``slot`` abnormally and free the slot
        and its pages (deadlines, cancel, quarantine)."""
        req = self.slots[slot]
        self.slots[slot] = None
        self.pos[slot] = self.last_tok[slot] = self.pref_target[slot] = 0
        self.enc_len[slot] = 0
        self.pager.free_slot(slot)
        self._finish_abnormal(req, reason, error)

    def _deadline_hit(self, req: Request, now: float) -> bool:
        age = now - req.arrival_t
        if req.deadline_s is not None and age > req.deadline_s:
            return True
        return (req.ttft_deadline_s is not None
                and req.first_token_t is None
                and age > req.ttft_deadline_s)

    def _expire_deadlines(self) -> None:
        """TTFT and total deadlines, checked every step: an expired request
        turns terminal (``deadline``) with its pages freed, wherever it is."""
        if not any(r.deadline_s is not None or r.ttft_deadline_s is not None
                   for r in list(self.queue) + self.slots if r is not None):
            return
        now = self._clock()
        for r in [r for r in self.queue if self._deadline_hit(r, now)]:
            self.queue.remove(r)
            self._finish_abnormal(r, "deadline")
        for i in self._active_slots():
            if self._deadline_hit(self.slots[i], now):
                self._evict_slot(i, "deadline")

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def _tensor(self, a, dtype=torch.int32,
                site: Optional[str] = None) -> torch.Tensor:
        """``a`` on the engine's device.  On a card the copy from pageable
        host memory waits for the stream to drain: ``site`` names that
        wait's span, ``sync.<site>``."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if site is None:
            return t.to(self.device)
        with span("sync." + site, ENCLOSING):
            return t.to(self.device)

    def _sample(self, logits, reqs) -> np.ndarray:
        """Tokens for ``reqs`` (None rows ignored), in the phase
        ``_sample_key`` names: the first tokens of a prefill or a decode
        step's."""
        with self._phase(self._sample_key):
            temps = [r.temperature if r else 0.0 for r in reqs]
            with span("sync.sample.temps", ENCLOSING):
                temps = torch.tensor(temps, dtype=torch.float32,
                                     device=logits.device)
            if any(r is not None and (r.top_k or r.top_p < 1.0)
                   for r in reqs):
                with span("sync.sample.top_k", ENCLOSING):
                    tks = torch.tensor([r.top_k if r else 0 for r in reqs],
                                       device=logits.device)
                with span("sync.sample.top_p", ENCLOSING):
                    tps = torch.tensor([r.top_p if r else 1.0 for r in reqs],
                                       device=logits.device)
                out = sample_per_slot(logits, self.gen, temps, tks, tps)
            else:
                out = sample_per_slot(logits, self.gen, temps)
            with span("sync.sample.cpu", ENCLOSING):
                out = out.cpu()
            return out.numpy()

    # -------------------------------------------------- prefix-cache glue --
    def _written_tokens(self, slot: int) -> np.ndarray:
        """Token ids at every written position of ``slot``: the prompt, then
        the generated tokens whose KV is in the pages (after a re-prefill,
        the first ``_gen_in_prompt`` of them are in the prompt already)."""
        req = self.slots[slot]
        n_gen = int(self.pos[slot]) - len(req.prompt)
        if n_gen <= 0:
            return req.prompt
        off = req._gen_in_prompt
        return np.concatenate([req.prompt, np.asarray(
            req.output[off:off + n_gen], np.int32)])

    def _cache_insert_slot(self, slot: int) -> None:
        """Index every full written page of ``slot`` (idempotent); only the
        pages of generated tokens are hashed here, the prompt's hashes are
        the scheduler's memo."""
        toks = self._written_tokens(slot)
        req = self.slots[slot]
        hashes = self.cache.block_hashes(toks, head=req._block_hashes or ())
        self.stats.pages_inserted += self.cache.insert(
            toks, self.pager.slot_pages(slot), len(toks) // self.PS,
            hashes=hashes)

    # ---------------------------------------------------- swap-out / -in ---
    def _preempt(self, slot: int) -> None:
        """Swap ``slot`` out and requeue its request at the queue head (it
        was admitted before anything still queued, so FCFS order holds).
        Only the slot's private pages round-trip through the host: their
        rows are gathered and the device→host copy into pinned buffers is
        started without waiting; :meth:`_drain_swap_buffers` awaits it after
        the step's decode and frees the device gather buffer.  Shared and
        cached pages stay in the pool under a swap hold, as do an enc-dec
        slot's encoder pages (detached, never in the image: the swap
        helpers walk ``pools["layers"]`` only)."""
        req = self.slots[slot]
        kept, private = self.pager.split_for_swap(slot)
        dev = {}
        if private:
            dev["kv"] = api.gather_pool_rows(
                self.pools, self._tensor([p for _, p in private],
                                         torch.long, "preempt.pages"))
        if self.has_fixed:
            # the slot's SSM state rides the same image and the same copy
            dev["fixed"] = api.gather_fixed_rows(
                self.fixed, self._tensor([slot], torch.long, "preempt.slot"))
        host, copied = self._to_host(dev)
        rows, frows = host.get("kv"), host.get("fixed")
        nbytes = api.rows_nbytes(rows) if rows is not None else 0
        fbytes = api.rows_nbytes(frows) if frows is not None else 0
        enc_pages, enc_len = None, 0
        if self.has_enc:
            enc_pages = self.pager.detach_group(slot, "enc")
            enc_len = int(self.enc_len[slot])
            self.enc_len[slot] = 0
        self.pager.swap_out(slot, (kept, private))
        self._swapped[req.submit_seq] = _SwapState(
            rows=rows, kept=kept, private_lis=[li for li, _ in private],
            pos=int(self.pos[slot]), last_tok=int(self.last_tok[slot]),
            nbytes=nbytes, fbytes=fbytes, fixed_rows=frows,
            dev_rows=dev or None, copied=copied, enc_pages=enc_pages,
            enc_len=enc_len)
        self.queue.appendleft(req)
        self.slots[slot] = None
        self.pos[slot] = self.last_tok[slot] = self.pref_target[slot] = 0
        self.stats.preemptions += 1
        # both sides charge KV + fixed bytes, so a drained engine shows
        # swapped_out_bytes == swapped_in_bytes
        self.stats.swapped_out_bytes += nbytes + fbytes
        self.stats.swapped_fixed_bytes += fbytes
        if self._obs:
            t = self.trace.event(req.uid, "preempt", slot=slot,
                                 bytes=nbytes + fbytes)
            self.trace.timeline(req.uid).preempt_t = t
            self.trace.note_preempt(req.uid, slot)

    def _to_host(self, image):
        """``image`` (``{"kv": rows, "fixed": rows}``, either may be absent)
        copied to pinned host buffers without blocking, and the event that
        marks the copy done (on the CPU: the image itself, a fresh gather
        already; None for an empty image)."""
        if self.device.type != "cuda" or not image:
            return image, None

        def pinned(t):
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t, non_blocking=True)

        host = {}
        if "kv" in image:
            host["kv"] = {"layers": [{k: pinned(t) for k, t in lr.items()}
                                     for lr in image["kv"]["layers"]]}
        if "fixed" in image:
            host["fixed"] = {k: pinned(t) for k, t in image["fixed"].items()}
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    def _resume(self, slot: int, req: Request) -> None:
        """Swap a preempted request back in: re-acquire its held pages,
        allocate fresh private ones and scatter the host rows into them in
        place (stream-ordered after the swap-out copy, drained or not),
        restore the decode cursor."""
        st = self._swapped.pop(req.submit_seq)
        fresh = self.pager.swap_in(slot, st.kept, st.private_lis)
        if st.rows is not None:
            api.scatter_pool_rows(self.pools, st.rows,
                                  self._tensor(fresh, torch.long,
                                               "resume.pages"))
        if st.fixed_rows is not None:
            # same dtypes both ways: the restored state is bit-identical
            api.scatter_fixed_rows(self.fixed, st.fixed_rows,
                                   self._tensor([slot], torch.long,
                                                "resume.slot"))
        if st.enc_pages is not None:
            self.pager.reattach_group(slot, "enc", st.enc_pages)
            self.enc_len[slot] = st.enc_len
        self.slots[slot] = req
        self.pos[slot] = st.pos
        self.last_tok[slot] = st.last_tok
        # a slot preempted mid-prefill resumes mid-prefill: its chunk cursor
        # (pos) restores below pref_target and chunking picks it back up
        self.pref_target[slot] = len(req.prompt)
        self.stats.resumes += 1
        self.stats.swapped_in_bytes += st.nbytes + st.fbytes
        self.stats.swapped_fixed_in_bytes += st.fbytes
        if self._obs:
            t = self.trace.event(req.uid, "swap_in", slot=slot,
                                 bytes=st.nbytes + st.fbytes)
            tl = self.trace.timeline(req.uid)
            if tl.preempt_t is not None:
                self._h_swap.observe(t - tl.preempt_t)
                tl.preempt_t = None
            self.trace.note_resume(req.uid, slot)

    def _charge_retry(self, slot: int, why: str) -> None:
        """Charge one fault retry to the request in ``slot``; past the budget
        it turns terminal (``failed``) instead of livelocking."""
        req = self.slots[slot]
        req.retries += 1
        self.stats.retries += 1
        self._retry_pending = True
        if self._obs:
            self.trace.event(req.uid, "retry", slot=slot, why=why,
                             n=req.retries)
        if req.retries > self.retry_budget:
            self._evict_slot(
                slot, "failed",
                f"fault-retry budget exhausted ({self.retry_budget}): {why}")

    def _ensure_pages(self) -> set:
        """Lazy growth: every active slot must own the pages covering its
        next write position before the step runs.  Oldest slots grow first;
        on pool exhaustion the youngest active slot is preempted (repeatedly,
        until the growth fits), possibly the growing slot itself, which then
        leaves the batch until pages free up.  Returns the slots whose
        growth hit an injected fault: they sit out this step's decode and
        retry on their bounded budget."""
        stalled: set = set()
        if self.reservation != "lazy":
            return stalled          # worst-case reservation never grows
        with self._phase("grow"):
            for i in sorted(self._active_slots(),
                            key=lambda j: self.slots[j].submit_seq):
                while self.slots[i] is not None:
                    need = int(self.pos[i]) // self.PS + 1
                    if len(self.pager.slot_pages(i)) >= need:
                        break
                    if self.pager.can_alloc(1):
                        try:
                            self.pager.grow(i, 1)
                            self.stats.grown_pages += 1
                        except TransientFault as e:
                            self._charge_retry(i, str(e))
                            stalled.add(i)
                            break
                    else:
                        self._preempt(max(
                            self._active_slots(),
                            key=lambda j: self.slots[j].submit_seq))
        return stalled

    def _verify_swap_image(self, req: Request) -> bool:
        """Check a drained swap image's CRC before its rows reach the pool.
        On a mismatch the image is dropped (holds released) and the request
        turns into a re-prefill of its written tokens (prompt + generated),
        after which decoding resumes from the restored last token; a second
        mismatch fails it.  Returns False when the request must not resume
        by swap-in."""
        st = self._swapped[req.submit_seq]
        has_img = st.rows is not None or st.fixed_rows is not None
        if (not has_img or not st.on_host
                or api.swap_image_checksum(st.rows, st.fixed_rows)
                == st.checksum):
            return True
        # a poisoned image never reaches the pools: KV rows and SSM state
        # alike re-derive from the token replay
        self._swapped.pop(req.submit_seq)
        for _, p in st.kept:
            self.pager.drop_hold(p)
        if st.enc_pages:
            # the encoder pages never entered the image: dropping the holds
            # leaves them indexed and evictable, and the re-admission's
            # exact match normally attaches them again without encoding
            self.pager.drop_group_holds(st.enc_pages)
        req.reprefills += 1
        self.stats.retries += 1
        self._retry_pending = True
        if req.reprefills > 1:      # re-prefill at most once
            self.queue.remove(req)
            self._finish_abnormal(
                req, "failed", "swap image corrupted twice — giving up")
            return False
        n_gen = st.pos - len(req.prompt)
        if n_gen > 0:
            # replay prompt + generated tokens through prefill; the next
            # decode must feed the already-sampled last token, not sample a
            # duplicate from the final chunk's logits
            req._replay_tok = st.last_tok
            off = req._gen_in_prompt
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(req.output[off:off + n_gen],
                                        np.int32)])
            req._gen_in_prompt = off + n_gen
            req._block_hashes = None    # memoized over the old prompt
        # req stays at the queue head, now unswapped: plan() admits it as a
        # fresh prefill (FCFS holds: it was admitted first)
        return False

    def _admit(self) -> None:
        """Expire deadlines, then admit (:meth:`_admit_queue`)."""
        with self._phase("admit"):
            self._expire_deadlines()
            self._admit_queue()

    def _admit_queue(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        # preempted requests sit at the queue head (FCFS); resume them by
        # swap-in before planning fresh prefills, and if the head cannot
        # resume yet, nothing behind it may jump the line
        while self.queue and self.queue[0].submit_seq in self._swapped:
            if not free:
                return
            if not self._verify_swap_image(self.queue[0]):
                break           # corrupt: the head re-prefills (or failed)
            st = self._swapped[self.queue[0].submit_seq]
            reserve = self.B - len(free)          # watermark: active slots
            if not self.pager.can_alloc(len(st.private_lis) + reserve):
                return
            self._resume(free.pop(0), self.queue.popleft())
        if not free or not self.queue:
            return
        # the planner must never see a swap-resumable request: a re-prefill
        # head can leave still-swapped requests behind it, so they sit out
        # the plan and rejoin in FCFS order after it
        parked = [r for r in self.queue if r.submit_seq in self._swapped]
        for r in parked:
            self.queue.remove(r)
        reserve = (self.B - len(free)) if self.reservation == "lazy" else 0
        for bkt in self.sched.plan(self.queue, free, self.pager, reserve,
                                   self.cache):
            # COW first: a page-aligned full match re-prefills its last
            # prompt token into a private copy of the final matched page, so
            # the copies exist before any chunk reads them.  The plan held
            # each source against reuse until its rows are copied here.
            pairs = [p for p in bkt.cow if p is not None]
            if pairs:
                api.copy_pool_page(
                    self.pools, self._tensor([s for s, _ in pairs],
                                             torch.long, "cow.src"),
                    self._tensor([d for _, d in pairs], torch.long,
                                 "cow.dst"))
                for src, _ in pairs:
                    self.pager.drop_hold(src)
                self.stats.cow_copies += len(pairs)
            # the slot's chunk cursor starts at the cached prefix's length;
            # the rest of the prompt prefills in budgeted chunks
            for r, (slot, req) in enumerate(zip(bkt.slots, bkt.reqs)):
                pfx = int(bkt.prefix_lens[r])
                self.slots[slot] = req
                self.pos[slot] = pfx
                self.pref_target[slot] = len(req.prompt)
                self.last_tok[slot] = 0
                if self.has_fixed:
                    # the previous occupant's state is stale: zero it
                    # before the first chunk
                    for leaf in self.fixed.values():
                        leaf[:, slot].zero_()
                if self.has_enc:
                    self._admit_enc(slot, req)
                self.stats.admitted += 1
                self.stats.prefix_matched_tokens += pfx
                self.stats.prefix_hits += int(pfx > 0)
                self.stats.pages_shared += bkt.shared[r]
                if self._obs:
                    t = self.trace.event(req.uid, "admit", slot=slot,
                                         cached_tokens=pfx)
                    tl = self.trace.timeline(req.uid)
                    if tl.admit_t is None:   # first admission = queue wait
                        tl.admit_t = t
                        self._h_qwait.observe(t - req.arrival_t)
        if self.sched.last_plan_aborted and self.queue:
            # an injected grow fault aborted the plan mid-admission and the
            # scheduler rolled the victim back to the queue head: charge its
            # bounded budget so an endlessly faulting admission fails
            head = self.queue[0]
            head.retries += 1
            self.stats.retries += 1
            self._retry_pending = True
            if head.retries > self.retry_budget:
                self.queue.popleft()
                self._finish_abnormal(
                    head, "failed",
                    f"admission fault-retry budget exhausted "
                    f"({self.retry_budget})")
        if parked:
            merged = sorted(list(self.queue) + parked,
                            key=lambda r: r.submit_seq)
            self.queue.clear()
            self.queue.extend(merged)

    @torch.no_grad()
    def _admit_enc(self, slot: int, req: Request) -> None:
        """Fill ``slot``'s encoder pages at admission.  The plan allocated
        fresh ones (the "enc" group); an exact-match hit frees them and
        attaches the resident pages of the same frames, a miss runs the
        encoder once, scatters its K/V rows (padded to whole pages) into
        the fresh pages and indexes them for the next request with these
        frames."""
        fr = req.frames
        npg = self.pager.pages_needed(len(fr))
        if req._enc_hashes is None:
            req._enc_hashes = self.enc_cache.data_hashes(fr, npg)
        cached = self.enc_cache.match_exact(req._enc_hashes)
        if cached:
            self.pager.free_group(slot, "enc")
            self.pager.attach(slot, cached, group="enc")
            self.stats.enc_hits += 1
            self.stats.pages_shared += len(cached)
        else:
            pages = self.pager.slot_pages(slot, "enc")
            with span("sync.enc.frames", ENCLOSING):
                frames = torch.as_tensor(fr).to(self.device,
                                                self.cfg.tdtype)
            kv = api.encode_kv_fn(self.params, frames[None], self.cfg)
            idx = self._tensor(pages, torch.long, "enc.pages")
            pad = npg * self.PS - len(fr)
            for k, pool in self.pools["enc"].items():
                rows = torch.nn.functional.pad(kv[k][:, 0],
                                               (0, 0, 0, 0, 0, pad))
                pool.index_copy_(1, idx, rows.reshape(
                    rows.shape[0], npg, self.PS, *rows.shape[2:]).to(
                        pool.dtype))
            self.enc_cache.insert_exact(req._enc_hashes, pages)
            self.stats.enc_encodes += 1
        self.enc_len[slot] = len(fr)

    def _drain_swap_buffers(self) -> None:
        """Finish the swap-out copies started this step: wait for each, free
        its device gather buffer (a long-preempted request must not keep its
        image alive in device memory, which is what swap-out exists to
        release) and record the host image's CRC-32.  The ``swap_drain``
        fault leaves an image in flight another step (resume then reads it
        stream-ordered); ``fixed_drain`` is its twin for images carrying
        fixed-rows state (probed instead, so attention-only probe sequences
        stay as they were); ``swap_corrupt`` flips a byte of a drained
        image after its CRC was taken, caught at swap-in."""
        with self._phase("drain"):
            for st in self._swapped.values():
                has_img = st.rows is not None or st.fixed_rows is not None
                if has_img and not st.on_host:
                    site = ("fixed_drain" if st.fixed_rows is not None
                            else "swap_drain")
                    if self.faults is not None and self.faults.fires(site):
                        continue            # the copy is "still in flight"
                    if st.copied is not None:
                        with span("sync.drain.copied", ENCLOSING):
                            st.copied.synchronize()
                    st.dev_rows = st.copied = None
                    st.on_host = True
                    st.checksum = api.swap_image_checksum(st.rows,
                                                          st.fixed_rows)
                if (st.on_host and has_img and not st.corrupted
                        and self.faults is not None
                        and self.faults.fires("swap_corrupt")):
                    st.rows, st.fixed_rows = corrupt_swap_image(
                        st.rows, st.fixed_rows)
                    st.corrupted = True

    @torch.no_grad()
    def _prefill_chunks(self) -> int:
        """Advance every prefilling slot by its scheduled chunk (one fused
        [n, blen] launch per bucket); sample the first token on rows whose
        chunk completes the prompt.  Returns the chunk rows worked."""
        with self._phase("prefill"):
            items = [(i, int(self.pos[i]), int(self.pref_target[i]))
                     for i in sorted((j for j in self._active_slots()
                                      if self.pos[j] < self.pref_target[j]),
                                     key=lambda j: self.slots[j].submit_seq)]
            if not items:
                return 0
            if self.faults is not None \
                    and self.faults.fires("prefill_launch"):
                # the launch died before any KV write: every chunk retries
                # next step, the oldest row carrying the bounded charge
                self._charge_retry(items[0][0], "prefill launch faulted")
                return 0
            return sum(self._prefill_bucket(bkt)
                       for bkt in self.sched.plan_chunks(items))

    def _prefill_bucket(self, bkt) -> int:
        """One bucket's fused [n, blen] chunk launch, its first tokens and
        the cache's index of its finished prompts; returns its rows."""
        with self._phase("prefill.stage"):
            n, blen = len(bkt.slots), bkt.pad_len
            starts = np.asarray(bkt.starts, np.int32)
            lens = np.asarray(bkt.lens, np.int32)
            toks = np.zeros((n, blen), np.int32)
            for r, slot in enumerate(bkt.slots):
                prompt = self.slots[slot].prompt
                toks[r, :lens[r]] = prompt[starts[r]:starts[r] + lens[r]]
            tok_t = self._tensor(toks, site="prefill.tokens")
            table_t = self._tensor(self.pager.table()[bkt.slots],
                                   site="prefill.table")
            start_t = self._tensor(starts, site="prefill.starts")
            len_t = self._tensor(lens, site="prefill.lens")
            last_t = self._tensor(lens - 1, site="prefill.last_idx")
            leaves = self._leaf_inputs(bkt.slots)
        with self._phase("prefill.launch"):
            logits = api.prefill_chunk_fn(
                self.params, {"tokens": tok_t}, self.pools, table_t, start_t,
                len_t, self.cfg, last_idx=last_t, **leaves)[0]
        finals = [self.slots[s] if f else None
                  for s, f in zip(bkt.slots, bkt.final)]
        if any(bkt.final):
            self._sample_key = "prefill.sample"
            firsts = self._sample(logits, finals)
            now = self._clock()
        for r, slot in enumerate(bkt.slots):
            self.pos[slot] += int(lens[r])
            self.stats.prefilled_tokens += int(lens[r])
            if self._obs:
                self.trace.note_chunk(slot, self.slots[slot].uid,
                                      int(lens[r]))
            if bkt.final[r]:
                req = self.slots[slot]
                if req._replay_tok is not None:
                    # a re-prefill replayed tokens sampled long ago:
                    # restore the decode feed, append no duplicate
                    self.last_tok[slot] = req._replay_tok
                    req._replay_tok = None
                else:
                    first = int(firsts[r])
                    req.output.append(first)
                    req.first_token_t = now
                    self.last_tok[slot] = first
                    if self._obs:
                        tl = self.trace.timeline(req.uid)
                        tl.add(now, "first_token", slot=slot)
                        tl.first_token_t = now
                        tl.last_emit_t = now
                        self._h_ttft.observe(now - req.arrival_t)
                if self.cache is not None:
                    with self._phase("prefill.cache"):
                        self._cache_insert_slot(slot)
        self.stats.prefill_batches += 1
        self.stats.chunk_rows.append((n * blen, int(starts.max())))
        return n

    # -------------------------------------------------------------- step ---
    def _decode_inputs(self, dec: List[int]):
        """The decode step's host inputs for decoding slots ``dec``: token
        [B, 1], position [B] and table [B, P], then the leaves' extra
        inputs.  Mid-prefill and empty rows ride the launch like idle
        slots, their table rows pointing at the trash page, which absorbs
        the dummy write.  Trash-masking covers the KV write but not a
        recurrence: a hybrid's ``active`` mask freezes the state rows of
        every other slot.  An enc-dec's other rows read the trash encoder
        page with 0 valid rows, and their logits are discarded."""
        tbl = self.pager.table().copy()
        pos = self.pos.copy()
        tok = self.last_tok.copy()
        idle = np.ones(self.B, bool)
        idle[dec] = False
        tbl[idle], pos[idle], tok[idle] = KV.TRASH_PAGE, 0, 0
        inputs = (tok[:, None], pos, tbl)
        if self.has_fixed:
            inputs += (~idle,)
        if self.has_enc:
            etbl = self.pager.table("enc").copy()
            elen = self.enc_len.copy()
            etbl[idle], elen[idle] = KV.TRASH_PAGE, 0
            inputs += (etbl, elen)
        return inputs

    def _leaf_inputs(self, slots: List[int]) -> dict:
        """A prefill chunk's inputs for the state leaves of bucket rows
        ``slots`` (keywords of ``api.prefill_chunk_fn``): a hybrid's
        fixed-rows tree and slot indices, an enc-dec's encoder page table
        and valid encoder rows."""
        extra = {}
        if self.has_fixed:
            extra.update(fixed=self.fixed,
                         slots=self._tensor(slots, torch.long,
                                            "prefill.slots"))
        if self.has_enc:
            extra.update(enc_table=self._tensor(
                self.pager.table("enc")[slots], site="prefill.enc_table"),
                enc_len=self._tensor(self.enc_len[slots],
                                     site="prefill.enc_len"))
        return extra

    @torch.no_grad()
    def step(self) -> int:
        """One mixed step: expire deadlines, admit (swap-ins first), grow
        tables (preempting under pressure), advance prefilling slots by one
        budgeted chunk round, decode one token for every decoding slot, then
        finish the step's swap-out copies.  Returns the rows worked (decode
        slots + chunk rows).  Its host phases tile it (``_phase``)."""
        with self._phase("step"):
            self._step_idx += 1
            self._retry_pending = False
            if self._obs:
                self.trace.begin_step(self._step_idx)
                pc0 = dict(self.pager.counts)
            pre_injected = 0
            if self.faults is not None:
                self.faults.begin_step(self._step_idx)
                pre_injected = self.faults.total_injected
            worked = self._step_inner()
            if self.cache is not None:
                # evictions happen during admission too: mirror on every step
                self.stats.pages_evicted = self.cache.stats.evicted_pages
            if self.faults is not None:
                self.stats.faults_injected = self.faults.total_injected
                # a fire this step or an active pressure window makes a
                # zero-work step a fault's back-off, not a stall
                if (self.faults.total_injected > pre_injected
                        or self.faults.pressure_active()):
                    self._retry_pending = True
            self._drain_swap_buffers()
            if self._obs:
                with self._phase("observe"):
                    pc1 = self.pager.counts
                    used = (self.pager.num_pages - 1) - self.pager.free_pages
                    self.metrics.gauge("pool_used_pages").set(used)
                    self.metrics.gauge("active_slots").set(
                        sum(s is not None for s in self.slots))
                    self.trace.end_step(
                        self._last_dec,
                        pages_used=used, pages_free=self.pager.free_pages,
                        pages_grown=pc1["grown"] - pc0["grown"],
                        pages_cow=pc1["cow"] - pc0["cow"],
                        pages_evicted=pc1["evicted"] - pc0["evicted"])
            return worked

    def _step_inner(self) -> int:
        self._last_dec = []
        self._admit()
        stalled = self._ensure_pages()
        chunked = self._prefill_chunks()
        # slots whose growth hit an injected fault sit the decode out
        dec = [i for i in self._active_slots()
               if i not in stalled and self.pos[i] >= self.pref_target[i]]
        if not dec:
            return chunked
        with self._phase("decode.stage"):
            # pager tripwires: no active slot points at the trash page,
            # every refcount matches the tables + holds, and the page under
            # each write cursor is private
            try:
                KV.assert_live_tables(
                    self.pager.table(), self.pos, self.PS,
                    [s is not None and i not in stalled
                     for i, s in enumerate(self.slots)],
                    refs=self.pager.refs(), held=self.pager.held(),
                    cached=self.pager.cached_mask(),
                    aux_tables=tuple(self.pager.table(g)
                                     for g in self.pager.groups
                                     if g != "kv"))
            except KV.PagerInvariantError as e:
                if self.strict or e.slot is None:
                    raise
                # quarantine: fail the offending request, free what it
                # held, skip this launch; the next step checks again from
                # scratch
                self._evict_slot(int(e.slot), "failed",
                                 f"pager invariant violated: {e}")
                self._retry_pending = True
                return chunked
            if self.faults is not None and self.faults.fires("decode_launch"):
                # the launch died before dispatch (nothing launched, written
                # or sampled), so the retry next step is sound; the oldest
                # decode slot carries the bounded charge
                oldest = min(dec, key=lambda j: self.slots[j].submit_seq)
                self._charge_retry(oldest, "decode launch faulted")
                return chunked
            inputs = self._decode_inputs(dec)
            if self.decode_graph is None:
                inputs = tuple(self._tensor(a, torch.bool if a.dtype == bool
                                            else torch.int32) for a in inputs)
        if self.decode_graph is not None:
            # the graph stages its inputs and replays in phases of its own
            logits = self.decode_graph(*inputs)
        else:
            with self._phase("decode.launch"):
                logits = self._decode_step(*inputs)
        dset = set(dec)
        rows = [self.slots[i] if i in dset else None for i in range(self.B)]
        self._sample_key = "sample"
        nxt = self._sample(logits, rows)
        with self._phase("emit"):
            self._emit(dec, nxt)
        return len(dec) + chunked

    def _emit(self, dec: List[int], nxt: np.ndarray) -> None:
        """Append each decoding slot's sampled token; finish and free the
        slots whose request is done."""
        self.stats.steps += 1
        self.stats.max_active = max(self.stats.max_active, len(dec))
        self.stats.active_slot_steps += len(dec)
        self._last_dec = dec
        # one clock reading covers every token this step emitted (the ITL
        # anchor and done_t share it)
        now = self._clock()
        for i in dec:
            req = self.slots[i]
            t = int(nxt[i])
            req.output.append(t)
            self.pos[i] += 1
            self.last_tok[i] = t
            self.stats.decoded_tokens += 1
            if self._obs:
                tl = self.trace.timeline(req.uid)
                if tl.last_emit_t is not None:
                    self._h_itl.observe(now - tl.last_emit_t)
                tl.last_emit_t = now
            hit_eos = t == self.eos
            if len(req.output) >= req.max_tokens or hit_eos \
                    or self.pos[i] >= self.S:
                req.done_t = now
                req.finish_reason = "completed" if hit_eos else "length"
                self.stats.completed += 1
                if self._obs:
                    self._note_finish(req)
                if self.cache is not None:
                    # index the generated full pages too before the refs
                    # drop: identical continuations (multi-turn) match
                    self._cache_insert_slot(i)
                self.slots[i] = None
                self.pos[i] = self.last_tok[i] = self.pref_target[i] = 0
                self.enc_len[i] = 0
                self.pager.free_slot(i)

    # ----------------------------------------------------------- reports ---
    def _deadline_left_s(self, r: Request, now: float) -> Optional[float]:
        """Tightest remaining deadline of ``r`` in seconds (negative: past
        due; None: no deadline)."""
        rem = []
        age = now - r.arrival_t
        if r.deadline_s is not None:
            rem.append(r.deadline_s - age)
        if r.ttft_deadline_s is not None and r.first_token_t is None:
            rem.append(r.ttft_deadline_s - age)
        return min(rem) if rem else None

    def metrics_snapshot(self) -> dict:
        """The one structured view of engine state: the latency histograms
        (TTFT, ITL, e2e, queue wait, swap stall; p50/p90/p99 under the
        documented percentile rule), :class:`EngineStats`, the labeled
        counters and gauges, the scheduler's and pager's counters, pager
        occupancy and the live pending set (uid, phase, progress, remaining
        deadline).  Serve's stat lines and the stall reports read it."""
        now = self._clock()
        pending = []
        for r in self.queue:
            pending.append({
                "uid": r.uid,
                "phase": ("swapped" if r.submit_seq in self._swapped
                          else "queued"),
                "slot": None, "pos": None, "prompt": len(r.prompt),
                "out": len(r.output), "max_tokens": r.max_tokens,
                "retries": r.retries,
                "deadline_left_s": self._deadline_left_s(r, now)})
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            pending.append({
                "uid": r.uid,
                "phase": ("prefilling" if self.pos[i] < self.pref_target[i]
                          else "decoding"),
                "slot": i, "pos": int(self.pos[i]), "prompt": len(r.prompt),
                "out": len(r.output), "max_tokens": r.max_tokens,
                "retries": r.retries,
                "deadline_left_s": self._deadline_left_s(r, now)})
        m = self.metrics.snapshot()
        return {
            "step": self._step_idx,
            "engine": dataclasses.asdict(self.stats),
            "latency": {
                name: self.metrics.histogram(name).summary()
                for name in ("ttft_s", "itl_s", "e2e_s", "queue_wait_s",
                             "swap_stall_s")},
            "counters": m["counters"],
            "gauges": m["gauges"],
            "scheduler": dict(self.sched.counts),
            "pager": {
                "free_pages": self.pager.free_pages,
                "total_pages": self.pager.num_pages - 1,
                "held": int(self.pager.held().sum()),
                "evictable": self.pager.evictable_pages(),
                "swapped_images": len(self._swapped),
                "counts": dict(self.pager.counts),
            },
            "pending": pending,
        }

    def _pending_report(self) -> str:
        """Stall / max_steps diagnostic text (a rendering of
        :meth:`metrics_snapshot`)."""
        return format_pending(self.metrics_snapshot())

    def run_until_drained(self, max_steps: int = 10_000) -> EngineStats:
        """Step until queue and slots are empty.  ``max_steps`` bounds every
        iteration, idle ones included.  An iteration that works nothing
        while requests wait is an idle step: unless a fault ate its work
        (``_retry_pending``; the retry budgets bound the spin), admission is
        stalled, which raises under ``strict`` (naming every pending
        request) and fails the blocked head under ``strict=False``.
        Reaching ``max_steps`` with work left raises."""
        iters = 0
        while self.queue or any(s is not None for s in self.slots):
            if iters >= max_steps:
                raise RuntimeError(
                    f"run_until_drained hit max_steps={max_steps} with work "
                    f"left: {len(self.queue)} queued, "
                    f"{len(self._active_slots())} active slot(s) — raise "
                    f"max_steps or shrink the workload; pending:\n"
                    f"{self._pending_report()}")
            iters += 1
            if self.step() == 0 and self.queue:
                self.stats.idle_steps += 1
                if self._retry_pending:
                    continue
                head = self.queue[0]
                swapped = self._swapped.get(head.submit_seq)
                need = (len(swapped.private_lis) if swapped is not None
                        else self.sched.pages_needed(head, self.pager,
                                                     self.cache))
                msg = (
                    f"admission stalled: queue head request uid={head.uid} "
                    f"(prompt {len(head.prompt)} tokens, "
                    f"{'swapped-out, ' if swapped is not None else ''}"
                    f"needs {need} pages) cannot be admitted with "
                    f"free_pages={self.pager.free_pages}/"
                    f"{self.pager.num_pages - 1} "
                    f"(+{self.pager.evictable_pages()} evictable), "
                    f"free_slots={sum(s is None for s in self.slots)}/"
                    f"{self.B}, and no "
                    f"active slot can unblock it; pending:\n"
                    f"{self._pending_report()}")
                if not self.strict:
                    # the head alone is unservable: fail it, keep draining
                    self.queue.popleft()
                    self._finish_abnormal(head, "failed", msg)
                    continue
                raise RuntimeError(msg)
        return self.stats


def decode_step(params, pools, cfg: ModelConfig, names: tuple,
                tok: torch.Tensor, pos: torch.Tensor, table: torch.Tensor,
                *extra: torch.Tensor, fixed=None) -> torch.Tensor:
    """One decode step over all B rows: logits [B, V]; the pools (and a
    hybrid stack's ``fixed`` rows) are written in place (the step the
    engine's CUDA graph captures).  ``extra`` are the state leaves' inputs,
    passed to ``api.decode_paged_fn`` under ``names``: a hybrid's
    ``active[B]`` (other rows keep their state bit for bit), an enc-dec's
    ``enc_table[B, P]`` / ``enc_len[B]`` (the encoder pool is only
    read)."""
    return api.decode_paged_fn(params, {"token": tok, "position": pos}, pools,
                               table, cfg, fixed=fixed,
                               **dict(zip(names, extra, strict=True)))[0]


def load_or_quantize(params_fp, cfg: ModelConfig, calibration_batches,
                     qcfg: QuantConfig = QuantConfig(), *, artifact_dir=None,
                     refresh: bool = False, device="cuda"):
    """Load or quantize at boot (quantize once, serve many; paper §2.3).

    If ``artifact_dir`` holds a PTQ artifact (saved by either package) whose
    config hash matches ``(cfg, qcfg)``, the quantized params and report
    load from disk onto the device of ``params_fp`` (``device`` when it is
    None): no calibration batch is read and no α is searched.  Otherwise
    (no artifact, a stale hash, an unknown format, a corrupt ``meta.json``
    or ``arrays.npz``) the full SmoothQuant+ recipe runs on ``params_fp``,
    in place, and with ``artifact_dir`` its result is saved for the next
    boot; with ``params_fp=None`` the load error is raised instead.  The
    hash covers the configs, not the weight values: after swapping
    checkpoints under an unchanged config pass ``refresh=True`` to
    re-quantize.  The report carries the per-path W4A8 flags
    (``a8_eligibility``) and the errors that decided them."""
    from repro_torch.core import apply as AP

    if artifact_dir is not None and not refresh and AP.has_ptq(artifact_dir):
        dev = (device if params_fp is None
               else next(_tensors(params_fp)).device)
        try:
            return AP.load_ptq(artifact_dir, cfg, qcfg, device=dev)
        except (ValueError, KeyError, OSError, zipfile.BadZipFile):
            if params_fp is None:
                raise
    qp, rep = AP.smoothquant_plus(params_fp, cfg, calibration_batches, qcfg)
    if artifact_dir is not None:
        AP.save_ptq(artifact_dir, qp, rep, cfg, qcfg)
    return qp, rep


def _tensors(node):
    """The tensor leaves of a param tree, depth first."""
    if isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, list):
        for v in node:
            yield from _tensors(v)
    elif isinstance(node, torch.Tensor):
        yield node
