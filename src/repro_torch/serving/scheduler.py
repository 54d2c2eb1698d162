"""Admission scheduler: length-bucketed batched prefill planning and
token-budget chunk planning (port of ``repro/serving/scheduler.py``).

Admission is strict FCFS: the queue head is admitted only if a free slot and
enough free pages exist (plus the lazy-reservation watermark of one growth
page per decoding slot); nothing behind it jumps ahead.  Admitted prompts
prefill in chunks (:meth:`Scheduler.plan_chunks`): each engine step packs up
to ``max_prefill_tokens`` chunk tokens into power-of-two buckets of the page
size; non-final chunks end on page boundaries.

``reservation="lazy"`` reserves the prompt plus one decode token and lets
the engine grow tables page by page; ``"worstcase"`` reserves
``prompt + max_tokens`` up front.  ``mode="slotwise"`` gives every request
its own exact-length bucket (the seed engine's strategy).

**Prefix cache** (``cache=`` on :meth:`Scheduler.plan`): the head's prompt
is matched against the block-hash index first.  Matched whole pages are
attached (shared, refcounted: no allocation, no prefill) and admission is
charged for the uncached suffix only; buckets are keyed by the suffix's
bucket length.  At least one token is always prefilled (the engine samples
the first output from the last prompt token's logits): on a page-aligned
full match the plan takes a copy-on-write of the final matched page and
re-prefills the last prompt token into the private copy.  An injected
``page_grow`` fault mid-admission rolls that admission back
(``last_plan_aborted``) and ends the plan.

An encoder-decoder request (``req.frames``) is also charged the read-only
encoder pages its frames cover, allocated fresh in the pager's ``"enc"``
group; on an encoder-cache hit the engine frees them again and attaches
the shared pages.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.serving.faults import TransientFault
from repro_torch.serving.kv_cache import PagePool


@dataclasses.dataclass
class PrefillBucket:
    pad_len: int          # joint prefill length (suffix tokens)
    reqs: list            # admitted Requests, FCFS order
    slots: List[int]      # slot id per request
    needs: List[int]      # fresh pages allocated per request
    # matched prefix tokens per request (0 = cold)
    prefix_lens: List[int] = dataclasses.field(default_factory=list)
    # pages attached (shared, not allocated) per request
    shared: List[int] = dataclasses.field(default_factory=list)
    # (src, dst) pool pages whose rows the engine copies before prefill
    cow: List[Optional[Tuple[int, int]]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class ChunkBucket:
    """One fused ``[n, pad_len]`` prefill-chunk launch of a mixed step."""
    pad_len: int
    slots: List[int]
    starts: List[int]     # tokens already written per row (chunk cursor)
    lens: List[int]       # valid chunk tokens per row (<= pad_len)
    final: List[bool]     # True when this chunk completes the row's prompt


@dataclasses.dataclass
class _AdmissionCost:
    """Page arithmetic for admitting one request, shared by
    :meth:`Scheduler.plan` and its diagnostic twin
    :meth:`Scheduler.pages_needed`."""
    total: int            # pages covering _tokens_wanted, ignoring the cache
    matched: list         # cached whole pages the prefix cache matched
    mtok: int             # tokens those pages cover
    full_match: bool      # page-aligned whole-prompt match (needs a COW)
    fresh: int            # pages to allocate (incl. the COW destination)
    pinned: int           # matched-but-unreferenced pages the attach pins
    enc: int = 0          # read-only encoder pages (enc-dec requests only)


class Scheduler:
    def __init__(self, *, page_size: int, max_seq: int,
                 max_prefill_tokens: Optional[int] = None,
                 mode: str = "bucketed", reservation: str = "lazy"):
        if mode not in ("bucketed", "slotwise"):
            raise ValueError(f"unknown prefill mode {mode!r}")
        if reservation not in ("lazy", "worstcase"):
            raise ValueError(f"unknown page reservation {reservation!r}")
        if max_prefill_tokens is not None and max_prefill_tokens < 1:
            raise ValueError(
                f"max_prefill_tokens must be >= 1, got {max_prefill_tokens}")
        self.page_size = page_size
        self.max_seq = max_seq
        self.max_prefill_tokens = max_prefill_tokens
        self.mode = mode
        self.reservation = reservation
        # True when the last plan() aborted an admission on an injected
        # transient fault (rolled back, the request back at the queue head)
        self.last_plan_aborted = False
        # cumulative planning counters (the engine's metrics_snapshot())
        self.counts = {"plans": 0, "admitted": 0, "chunk_rounds": 0,
                       "chunk_tokens": 0, "aborted_plans": 0}

    def bucket_len(self, prompt_len: int) -> int:
        b = self.page_size
        while b < prompt_len:
            b *= 2
        return min(b, self.max_seq)

    def _tokens_wanted(self, req) -> int:
        if self.reservation == "worstcase":
            return min(len(req.prompt) + req.max_tokens, self.max_seq)
        return min(len(req.prompt) + 1, self.max_seq)

    def _admission_cost(self, req, pool: PagePool, cache=None,
                        probe_faults: bool = True) -> _AdmissionCost:
        """The one admission page arithmetic: the cold total, the cached
        prefix's credit, the full match's COW page, and the matched but
        unreferenced pages the attach is about to pin (which must not count
        as evictable headroom for the fresh allocation), and an enc-dec
        request's encoder pages, counted as fresh."""
        total = pool.pages_needed(self._tokens_wanted(req))
        frames = getattr(req, "frames", None)
        enc = pool.pages_needed(len(frames)) if frames is not None else 0
        if cache is None:
            return _AdmissionCost(total, [], 0, False, total, 0, enc)
        # chain hashes are pure in the prompt: computed once per request
        hs = getattr(req, "_block_hashes", None)
        if hs is None:
            hs = req._block_hashes = cache.block_hashes(req.prompt)
        matched, mtok = cache.match(req.prompt, hashes=hs,
                                    probe_faults=probe_faults)
        full_match = bool(matched) and mtok == len(req.prompt)
        fresh = total - len(matched) + (1 if full_match else 0)
        pinned = sum(1 for p in matched if pool.page_ref(p) == 0)
        return _AdmissionCost(total, matched, mtok, full_match, fresh,
                              pinned, enc)

    def pages_needed(self, req, pool: PagePool, cache=None) -> int:
        """Pages that must be allocatable to admit ``req`` (the diagnostic
        twin of :meth:`plan`: no fault budget spent)."""
        cost = self._admission_cost(req, pool, cache, probe_faults=False)
        return cost.fresh + cost.pinned + cost.enc

    def plan(self, queue: Deque, free_slots: List[int], pool: PagePool,
             reserve: int = 0, cache=None) -> List[PrefillBucket]:
        """Pop admissible requests off ``queue`` (FCFS), attach their cached
        prefix pages, allocate the rest and their slots, and bucket them by
        the length of the suffix they prefill.  ``reserve`` is the admission
        watermark (free pages that must remain after each admit)."""
        slots = deque(free_slots)
        budget = self.max_prefill_tokens
        buckets: dict = {}
        spent = 0
        self.last_plan_aborted = False
        self.counts["plans"] += 1
        while queue and slots:
            req = queue[0]
            t = len(req.prompt)
            # no admission needs fewer than one fresh page: a drained pool
            # blocks the head before its prompt is matched
            if not pool.can_alloc(1 + reserve):
                break
            cost = self._admission_cost(req, pool, cache)
            matched, full_match, fresh = (cost.matched, cost.full_match,
                                          cost.fresh)
            # never a zero-token prefill: a page-aligned full match
            # re-prefills the last prompt token into a COW copy
            suffix = 1 if full_match else t - cost.mtok
            prefix = t - suffix
            if not pool.can_alloc(fresh + reserve + cost.pinned + cost.enc):
                break                       # FCFS: head blocks the line
            blen = (suffix if self.mode == "slotwise"
                    else self.bucket_len(suffix))
            if budget is not None and spent and spent + blen > budget:
                break                       # chunk the backlog across steps
            queue.popleft()
            slot = slots.popleft()
            cow_pair = None
            try:
                if matched:
                    pool.attach(slot, matched)
                # hold_src: the engine copies src → dst later (per bucket,
                # before its prefill); the hold keeps src from being
                # reclaimed by an allocation in the rest of this plan
                cow_pair = (pool.cow(slot, len(matched) - 1, hold_src=True)
                            if full_match else None)
                if fresh - (1 if full_match else 0):
                    pool.grow(slot, fresh - (1 if full_match else 0))
                if cost.enc:
                    # fresh encoder pages; the engine swaps them for the
                    # shared ones on an encoder-cache hit
                    pool.grow(slot, cost.enc, group="enc")
            except TransientFault:
                # roll the admission back (attached pages, the COW copy and
                # its hold), requeue at the head and stop planning
                if cow_pair is not None:
                    pool.drop_hold(cow_pair[0])
                pool.free_slot(slot)
                queue.appendleft(req)
                self.last_plan_aborted = True
                self.counts["aborted_plans"] += 1
                break
            if self.reservation == "lazy":
                reserve += 1                # growth headroom for the new slot
            key = (blen if self.mode == "bucketed" else (blen, slot),
                   prefix > 0)
            bkt = buckets.get(key)
            if bkt is None:
                bkt = buckets[key] = PrefillBucket(blen, [], [], [])
            bkt.reqs.append(req)
            bkt.slots.append(slot)
            bkt.needs.append(fresh)
            bkt.prefix_lens.append(prefix)
            bkt.shared.append(len(matched) - (1 if full_match else 0))
            bkt.cow.append(cow_pair)
            self.counts["admitted"] += 1
            spent += blen
        return list(buckets.values())

    def plan_chunks(self, prefilling: List[Tuple[int, int, int]],
                    budget: Optional[int] = None) -> List[ChunkBucket]:
        """Pack up to ``budget`` chunk tokens (default
        ``max_prefill_tokens``; None = everything) across the
        ``[(slot, written, target)]`` rows still prefilling, FCFS, into
        power-of-two buckets.  The head always makes progress."""
        if budget is None:
            budget = self.max_prefill_tokens
        left = budget
        buckets: dict = {}
        for slot, written, target in prefilling:
            remaining = target - written
            if remaining <= 0:
                continue
            c = remaining if left is None else min(remaining, left)
            if c <= 0:
                break
            if c < remaining:
                aligned = ((written + c) // self.page_size) * self.page_size
                if aligned > written:
                    c = aligned - written
            blen = c if self.mode == "slotwise" else self.bucket_len(c)
            key = blen if self.mode == "bucketed" else (blen, slot)
            bkt = buckets.get(key)
            if bkt is None:
                bkt = buckets[key] = ChunkBucket(blen, [], [], [], [])
            bkt.slots.append(slot)
            bkt.starts.append(written)
            bkt.lens.append(c)
            bkt.final.append(written + c == target)
            self.counts["chunk_tokens"] += c
            if left is not None:
                left -= c
        if buckets:
            self.counts["chunk_rounds"] += 1
        return list(buckets.values())
