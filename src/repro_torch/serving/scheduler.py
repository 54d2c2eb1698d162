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
its own exact-length bucket (the seed engine's strategy).  The fault hooks
and the prefix-cache match of the reference planner wait for the slices that
port those features.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.serving.kv_cache import PagePool


@dataclasses.dataclass
class PrefillBucket:
    pad_len: int          # joint prefill length
    reqs: list            # admitted Requests, FCFS order
    slots: List[int]      # slot id per request
    needs: List[int]      # pages allocated per request


@dataclasses.dataclass
class ChunkBucket:
    """One fused ``[n, pad_len]`` prefill-chunk launch of a mixed step."""
    pad_len: int
    slots: List[int]
    starts: List[int]     # tokens already written per row (chunk cursor)
    lens: List[int]       # valid chunk tokens per row (<= pad_len)
    final: List[bool]     # True when this chunk completes the row's prompt


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

    def bucket_len(self, prompt_len: int) -> int:
        b = self.page_size
        while b < prompt_len:
            b *= 2
        return min(b, self.max_seq)

    def _tokens_wanted(self, req) -> int:
        if self.reservation == "worstcase":
            return min(len(req.prompt) + req.max_tokens, self.max_seq)
        return min(len(req.prompt) + 1, self.max_seq)

    def pages_needed(self, req, pool: PagePool) -> int:
        """Pages that must be allocatable to admit ``req``."""
        return pool.pages_needed(self._tokens_wanted(req))

    def plan(self, queue: Deque, free_slots: List[int], pool: PagePool,
             reserve: int = 0) -> List[PrefillBucket]:
        """Pop admissible requests off ``queue`` (FCFS), allocate their pages
        and slots, and bucket them by prompt length."""
        slots = deque(free_slots)
        budget = self.max_prefill_tokens
        buckets: dict = {}
        spent = 0
        while queue and slots:
            req = queue[0]
            need = self.pages_needed(req, pool)
            if not pool.can_alloc(need + reserve):
                break                       # FCFS: head blocks the line
            t = len(req.prompt)
            blen = t if self.mode == "slotwise" else self.bucket_len(t)
            if budget is not None and spent and spent + blen > budget:
                break
            queue.popleft()
            slot = slots.popleft()
            pool.grow(slot, need)
            if self.reservation == "lazy":
                reserve += 1                # growth headroom for the new slot
            key = blen if self.mode == "bucketed" else (blen, slot)
            bkt = buckets.get(key)
            if bkt is None:
                bkt = buckets[key] = PrefillBucket(blen, [], [], [])
            bkt.reqs.append(req)
            bkt.slots.append(slot)
            bkt.needs.append(need)
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
            if left is not None:
                left -= c
        return list(buckets.values())
