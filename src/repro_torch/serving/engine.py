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
  finished slots free their pages at once.

Under the default pool (``batch·pages + 1``) no request can run out of
pages.  Preemption and swap are not ported yet: a step that would have to
preempt raises instead of stalling.  The prefix cache, faults, deadlines,
metrics and trace wait for later slices (ROADMAP.md).

The engine runs on the GPU by default and raises when there is no card;
``device="cpu"`` runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import kv_cache as KV
from repro_torch.serving.sampling import sample_per_slot
from repro_torch.serving.scheduler import Scheduler


class RejectedRequest(ValueError):
    """Raised by :meth:`ServingEngine.submit` for an invalid request."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [T] int32
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    arrival_t: float = 0.0
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    submit_seq: int = -1


@dataclasses.dataclass
class EngineStats:
    decoded_tokens: int = 0
    prefilled_tokens: int = 0
    steps: int = 0
    completed: int = 0
    prefill_batches: int = 0
    grown_pages: int = 0
    max_active: int = 0
    rejected: int = 0
    # per prefill batch: (padded rows of its GEMMs, largest prefix_len)
    chunk_rows: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, *, batch_size: int = 8,
                 max_seq: int = 256, page_size: int = 16,
                 num_pages: Optional[int] = None, eos_id: int = 1,
                 seed: int = 0, max_prefill_tokens: Optional[int] = None,
                 prefill_mode: str = "bucketed", reservation: str = "lazy",
                 device="cuda"):
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
        num_pages = num_pages or (batch_size * self.P + 1)
        if num_pages - 1 < self.P:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one max_seq request "
                f"({self.P} pages of {page_size} tokens + trash page)")
        self.pager = KV.PagePool(num_pages, page_size, batch_size, self.P)
        self.pools = api.init_paged_cache(cfg, num_pages, page_size,
                                          self.device)
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
        self._next_seq = 0
        self._clock = time.perf_counter

    # ------------------------------------------------------------- admin ---
    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; invalid requests raise :class:`RejectedRequest`
        after being marked ``finish_reason="rejected"``."""
        why = None
        if len(req.prompt) == 0:
            why = "empty prompt"
        elif req.max_tokens <= 0:
            why = f"max_tokens must be >= 1, got {req.max_tokens}"
        elif len(req.prompt) > self.S - 1:
            why = (f"prompt of {len(req.prompt)} tokens exceeds "
                   f"max_seq-1={self.S - 1}")
        if why is not None:
            req.finish_reason, req.error = "rejected", why
            req.done_t = self._clock()
            self.stats.rejected += 1
            raise RejectedRequest(why)
        req.prompt = np.asarray(req.prompt, np.int32)
        req.arrival_t = req.arrival_t or self._clock()
        req.submit_seq = self._next_seq
        self._next_seq += 1
        self.queue.append(req)
        return True

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _sample(self, logits, reqs) -> np.ndarray:
        temps = torch.tensor([r.temperature if r else 0.0 for r in reqs],
                             dtype=torch.float32, device=logits.device)
        if any(r is not None and (r.top_k or r.top_p < 1.0) for r in reqs):
            tks = torch.tensor([r.top_k if r else 0 for r in reqs],
                               device=logits.device)
            tps = torch.tensor([r.top_p if r else 1.0 for r in reqs],
                               device=logits.device)
            out = sample_per_slot(logits, self.gen, temps, tks, tps)
        else:
            out = sample_per_slot(logits, self.gen, temps)
        return out.cpu().numpy()

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        reserve = (self.B - len(free)) if self.reservation == "lazy" else 0
        for bkt in self.sched.plan(self.queue, free, self.pager, reserve):
            for slot, req in zip(bkt.slots, bkt.reqs):
                self.slots[slot] = req
                self.pos[slot] = 0
                self.pref_target[slot] = len(req.prompt)
                self.last_tok[slot] = 0

    def _ensure_pages(self) -> None:
        """Lazy growth: every active slot owns the pages covering its next
        write position before the step runs, oldest slots first."""
        if self.reservation != "lazy":
            return
        for i in sorted(self._active_slots(),
                        key=lambda j: self.slots[j].submit_seq):
            need = int(self.pos[i]) // self.PS + 1
            short = need - len(self.pager.slot_pages(i))
            if short <= 0:
                continue
            if not self.pager.can_alloc(short):
                raise RuntimeError(
                    f"page pool exhausted: slot {i} (uid "
                    f"{self.slots[i].uid}) needs {short} more page(s) at "
                    f"position {int(self.pos[i])}, {self.pager.free_pages} "
                    "free — this needs preemption, which is not ported yet; "
                    "use the default num_pages (batch·pages + 1)")
            self.pager.grow(i, short)
            self.stats.grown_pages += short

    @torch.no_grad()
    def _prefill_chunks(self) -> int:
        """Advance every prefilling slot by its scheduled chunk (one fused
        [n, blen] launch per bucket); sample the first token on rows whose
        chunk completes the prompt.  Returns the chunk rows worked."""
        items = [(i, int(self.pos[i]), int(self.pref_target[i]))
                 for i in sorted((j for j in self._active_slots()
                                  if self.pos[j] < self.pref_target[j]),
                                 key=lambda j: self.slots[j].submit_seq)]
        worked = 0
        for bkt in self.sched.plan_chunks(items):
            n, blen = len(bkt.slots), bkt.pad_len
            starts = np.asarray(bkt.starts, np.int32)
            lens = np.asarray(bkt.lens, np.int32)
            toks = np.zeros((n, blen), np.int32)
            for r, slot in enumerate(bkt.slots):
                prompt = self.slots[slot].prompt
                toks[r, :lens[r]] = prompt[starts[r]:starts[r] + lens[r]]
            logits, self.pools = api.prefill_chunk_fn(
                self.params, {"tokens": self._tensor(toks)}, self.pools,
                self._tensor(self.pager.table()[bkt.slots]),
                self._tensor(starts), self._tensor(lens), self.cfg,
                last_idx=self._tensor(lens - 1))
            finals = [self.slots[s] if f else None
                      for s, f in zip(bkt.slots, bkt.final)]
            if any(bkt.final):
                firsts = self._sample(logits, finals)
                now = self._clock()
            for r, slot in enumerate(bkt.slots):
                self.pos[slot] += int(lens[r])
                self.stats.prefilled_tokens += int(lens[r])
                worked += 1
                if bkt.final[r]:
                    req = self.slots[slot]
                    first = int(firsts[r])
                    req.output.append(first)
                    req.first_token_t = now
                    self.last_tok[slot] = first
            self.stats.prefill_batches += 1
            self.stats.chunk_rows.append((n * blen, int(starts.max())))
        return worked

    # -------------------------------------------------------------- step ---
    @torch.no_grad()
    def step(self) -> int:
        """One mixed step: admit, grow tables, advance prefilling slots by
        one budgeted chunk round, decode one token for every decoding slot.
        Returns the rows worked (decode slots + chunk rows)."""
        self._admit()
        self._ensure_pages()
        chunked = self._prefill_chunks()
        dec = [i for i in self._active_slots()
               if self.pos[i] >= self.pref_target[i]]
        if not dec:
            return chunked
        KV.assert_live_tables(self.pager.table(), self.pos, self.PS,
                              [s is not None for s in self.slots],
                              refs=self.pager.refs())
        # mid-prefill and empty rows ride the launch like idle slots: their
        # table rows point at the trash page, which absorbs the dummy write
        dset = set(dec)
        tbl = self.pager.table().copy()
        pos = self.pos.copy()
        tok = self.last_tok.copy()
        for i in range(self.B):
            if i not in dset:
                tbl[i], pos[i], tok[i] = KV.TRASH_PAGE, 0, 0
        logits, self.pools = api.decode_paged_fn(
            self.params, {"token": self._tensor(tok[:, None]),
                          "position": self._tensor(pos)},
            self.pools, self._tensor(tbl), self.cfg)
        rows = [self.slots[i] if i in dset else None for i in range(self.B)]
        nxt = self._sample(logits, rows)
        self.stats.steps += 1
        self.stats.max_active = max(self.stats.max_active, len(dec))
        now = self._clock()
        for i in dec:
            req = self.slots[i]
            t = int(nxt[i])
            req.output.append(t)
            self.pos[i] += 1
            self.last_tok[i] = t
            self.stats.decoded_tokens += 1
            hit_eos = t == self.eos
            if len(req.output) >= req.max_tokens or hit_eos \
                    or self.pos[i] >= self.S:
                req.done_t = now
                req.finish_reason = "completed" if hit_eos else "length"
                self.stats.completed += 1
                self.slots[i] = None
                self.pos[i] = self.last_tok[i] = self.pref_target[i] = 0
                self.pager.free_slot(i)
        return len(dec) + chunked

    def run_until_drained(self, max_steps: int = 10_000) -> EngineStats:
        """Step until queue and slots are empty; a step that works nothing
        while requests wait is a stall and raises."""
        iters = 0
        while self.queue or any(s is not None for s in self.slots):
            if iters >= max_steps:
                raise RuntimeError(
                    f"run_until_drained hit max_steps={max_steps} with "
                    f"{len(self.queue)} queued and "
                    f"{len(self._active_slots())} active request(s)")
            iters += 1
            if self.step() == 0 and self.queue:
                head = self.queue[0]
                raise RuntimeError(
                    f"admission stalled: queue head uid={head.uid} (prompt "
                    f"{len(head.prompt)} tokens, needs "
                    f"{self.sched.pages_needed(head, self.pager)} pages) with "
                    f"free_pages={self.pager.free_pages}/"
                    f"{self.pager.num_pages - 1} and no active slot")
        return self.stats


def load_or_quantize(params_fp, cfg: ModelConfig, calibration_batches,
                     qcfg: QuantConfig = QuantConfig()):
    """Quantize-on-load (paper §2.3): fp params in, W4A16 params out, via the
    full SmoothQuant+ recipe (in place); the report carries the per-path
    W4A8 flags (``a8_eligibility``) and the errors that decided them.  The
    PTQ artifact branch of the reference waits for a later slice."""
    from repro_torch.core import apply as AP

    return AP.smoothquant_plus(params_fp, cfg, calibration_batches, qcfg)
