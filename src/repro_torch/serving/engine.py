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

Still to port (ROADMAP.md): the prefix cache (and with it copy-on-write and
the pager's evictor), faults and their injection sites, deadlines, cancel
and backpressure, metrics and the trace, the hybrid SSM and encoder-decoder
state leaves, and per-bucket prefill graphs.

The engine runs on the GPU by default and raises when there is no card;
``device="cpu"`` runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import kv_cache as KV
from repro_torch.serving.decode_graph import DecodeGraph
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
    reprefills: int = 0           # swap-corruption re-prefills (budget: 1)
    submit_seq: int = -1          # FCFS age; youngest (max) is preempted first
    # swap-corruption replay: the token that must feed the next decode step
    # after the re-prefill lands (instead of sampling a duplicate), and how
    # many output tokens were folded into the prompt by the re-prefill
    _replay_tok: Optional[int] = None
    _gen_in_prompt: int = 0


@dataclasses.dataclass
class _SwapState:
    """Host image of a preempted slot: everything needed to resume it bit
    for bit without re-prefilling.  Shared pages are not part of the image:
    they stay resident under a swap hold and resume re-acquires them
    (``kept``); only private pages round-trip as rows."""
    rows: Any                     # {"layers": [{leaf: [n, PS, ...]}]} (host)
    kept: List[Tuple[int, int]]   # (logical_idx, page) left resident
    private_lis: List[int]        # logical idxs of the swapped rows
    pos: int                      # next write position
    last_tok: int                 # token feeding the next decode step
    nbytes: int                   # swap-buffer bytes (stats)
    dev_rows: Any = None          # device gather buffer until drained
    copied: Optional[Any] = None  # CUDA event: the device→host copy is done
    on_host: bool = False         # drained: device buffer freed, CRC taken
    checksum: Optional[int] = None  # CRC-32 of the host image (drain time)


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
    idle_steps: int = 0           # drain iterations with nothing decodable
    max_active: int = 0           # peak concurrent decoding slots
    active_slot_steps: int = 0    # sum of active slots over steps (/steps)
    rejected: int = 0             # refused at submit (validation)
    failed: int = 0               # terminal after a second corrupt swap image
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
        self._swapped: Dict[int, _SwapState] = {}   # submit_seq -> image
        self._next_seq = 0
        self._clock = time.perf_counter
        self._retry_pending = False     # a corrupt swap image ate the step
        # the compiled decode step (the reference jits it with the pools
        # donated): one CUDA graph on a card, eager on the CPU.  The graph
        # holds the pool tensors, so nothing may rebind self.pools; the step
        # holds no reference to the engine, so dropping the engine frees
        # the graph and its memory at once.
        self._decode_step = functools.partial(decode_step, params,
                                              self.pools, self.cfg)
        self.decode_graph = (
            DecodeGraph(self._decode_step, batch_size, self.P, self.device)
            if self.device.type == "cuda" else None)

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

    # ---------------------------------------------------- swap-out / -in ---
    def _preempt(self, slot: int) -> None:
        """Swap ``slot`` out and requeue its request at the queue head (it
        was admitted before anything still queued, so FCFS order holds).
        Only the slot's private pages round-trip through the host: their
        rows are gathered and the device→host copy into pinned buffers is
        started without waiting; :meth:`_drain_swap_buffers` awaits it after
        the step's decode and frees the device gather buffer.  Shared pages
        stay in the pool under a swap hold."""
        req = self.slots[slot]
        kept, private = self.pager.split_for_swap(slot)
        rows = dev_rows = copied = None
        nbytes = 0
        if private:
            dev_rows = api.gather_pool_rows(
                self.pools, self._tensor([p for _, p in private],
                                         torch.long))
            rows, copied = self._to_host(dev_rows)
            nbytes = api.rows_nbytes(rows)
        self.pager.swap_out(slot, (kept, private))
        self._swapped[req.submit_seq] = _SwapState(
            rows=rows, kept=kept, private_lis=[li for li, _ in private],
            pos=int(self.pos[slot]), last_tok=int(self.last_tok[slot]),
            nbytes=nbytes, dev_rows=dev_rows, copied=copied)
        self.queue.appendleft(req)
        self.slots[slot] = None
        self.pos[slot] = self.last_tok[slot] = self.pref_target[slot] = 0
        self.stats.preemptions += 1
        self.stats.swapped_out_bytes += nbytes

    def _to_host(self, rows):
        """``rows`` copied to pinned host buffers without blocking, and the
        event that marks the copy done (on the CPU: ``rows`` themselves, a
        fresh gather already)."""
        if self.device.type != "cuda":
            return rows, None
        host = {"layers": [
            {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True) for k, t in lr.items()}
            for lr in rows["layers"]]}
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    def _resume(self, slot: int, req: Request) -> None:
        """Swap a preempted request back in: re-acquire its held pages,
        allocate fresh private ones and scatter the host rows into them in
        place, restore the decode cursor."""
        st = self._swapped.pop(req.submit_seq)
        fresh = self.pager.swap_in(slot, st.kept, st.private_lis)
        if st.rows is not None:
            api.scatter_pool_rows(self.pools, st.rows,
                                  self._tensor(fresh, torch.long))
        self.slots[slot] = req
        self.pos[slot] = st.pos
        self.last_tok[slot] = st.last_tok
        # a slot preempted mid-prefill resumes mid-prefill: its chunk cursor
        # (pos) restores below pref_target and chunking picks it back up
        self.pref_target[slot] = len(req.prompt)
        self.stats.resumes += 1
        self.stats.swapped_in_bytes += st.nbytes

    def _ensure_pages(self) -> None:
        """Lazy growth: every active slot must own the pages covering its
        next write position before the step runs.  Oldest slots grow first;
        on pool exhaustion the youngest active slot is preempted (repeatedly,
        until the growth fits), possibly the growing slot itself, which then
        leaves the batch until pages free up."""
        if self.reservation != "lazy":
            return                  # worst-case reservation never grows
        for i in sorted(self._active_slots(),
                        key=lambda j: self.slots[j].submit_seq):
            while self.slots[i] is not None:
                need = int(self.pos[i]) // self.PS + 1
                if len(self.pager.slot_pages(i)) >= need:
                    break
                if self.pager.can_alloc(1):
                    self.pager.grow(i, 1)
                    self.stats.grown_pages += 1
                else:
                    self._preempt(max(self._active_slots(),
                                      key=lambda j: self.slots[j].submit_seq))

    def _verify_swap_image(self, req: Request) -> bool:
        """Check a drained swap image's CRC before its rows reach the pool.
        On a mismatch the image is dropped (holds released) and the request
        turns into a re-prefill of its written tokens (prompt + generated),
        after which decoding resumes from the restored last token; a second
        mismatch fails it.  Returns False when the request must not resume
        by swap-in."""
        st = self._swapped[req.submit_seq]
        if (st.rows is None or not st.on_host
                or api.swap_image_checksum(st.rows) == st.checksum):
            return True
        self._swapped.pop(req.submit_seq)
        for _, p in st.kept:
            self.pager.drop_hold(p)
        req.reprefills += 1
        self._retry_pending = True
        if req.reprefills > 1:      # re-prefill at most once
            self.queue.remove(req)
            req.finish_reason = "failed"
            req.error = "swap image corrupted twice"
            req.done_t = self._clock()
            self.stats.failed += 1
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
        # req stays at the queue head, now unswapped: plan() admits it as a
        # fresh prefill (FCFS holds: it was admitted first)
        return False

    def _admit(self) -> None:
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
        for bkt in self.sched.plan(self.queue, free, self.pager, reserve):
            for slot, req in zip(bkt.slots, bkt.reqs):
                self.slots[slot] = req
                self.pos[slot] = 0
                self.pref_target[slot] = len(req.prompt)
                self.last_tok[slot] = 0
        if parked:
            merged = sorted(list(self.queue) + parked,
                            key=lambda r: r.submit_seq)
            self.queue.clear()
            self.queue.extend(merged)

    def _drain_swap_buffers(self) -> None:
        """Finish the swap-out copies started this step: wait for each, free
        its device gather buffer (a long-preempted request must not keep its
        image alive in device memory, which is what swap-out exists to
        release) and record the host image's CRC-32."""
        for st in self._swapped.values():
            if st.rows is None or st.on_host:
                continue
            if st.copied is not None:
                st.copied.synchronize()
            st.dev_rows = st.copied = None
            st.on_host = True
            st.checksum = api.swap_image_checksum(st.rows)

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
            logits = api.prefill_chunk_fn(
                self.params, {"tokens": self._tensor(toks)}, self.pools,
                self._tensor(self.pager.table()[bkt.slots]),
                self._tensor(starts), self._tensor(lens), self.cfg,
                last_idx=self._tensor(lens - 1))[0]
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
            self.stats.prefill_batches += 1
            self.stats.chunk_rows.append((n * blen, int(starts.max())))
        return worked

    # -------------------------------------------------------------- step ---
    def _decode_inputs(self, dec: List[int]):
        """The decode step's host inputs (token [B, 1], position [B], table
        [B, P]) for decoding slots ``dec``: mid-prefill and empty rows ride
        the launch like idle slots, their table rows pointing at the trash
        page, which absorbs the dummy write."""
        tbl = self.pager.table().copy()
        pos = self.pos.copy()
        tok = self.last_tok.copy()
        idle = np.ones(self.B, bool)
        idle[dec] = False
        tbl[idle], pos[idle], tok[idle] = KV.TRASH_PAGE, 0, 0
        return tok[:, None], pos, tbl

    @torch.no_grad()
    def step(self) -> int:
        """One mixed step: admit (swap-ins first), grow tables (preempting
        under pressure), advance prefilling slots by one budgeted chunk
        round, decode one token for every decoding slot, then finish the
        step's swap-out copies.  Returns the rows worked (decode slots +
        chunk rows)."""
        self._retry_pending = False
        worked = self._step_inner()
        self._drain_swap_buffers()
        return worked

    def _step_inner(self) -> int:
        self._admit()
        self._ensure_pages()
        chunked = self._prefill_chunks()
        dec = [i for i in self._active_slots()
               if self.pos[i] >= self.pref_target[i]]
        if not dec:
            return chunked
        KV.assert_live_tables(self.pager.table(), self.pos, self.PS,
                              [s is not None for s in self.slots],
                              refs=self.pager.refs(), held=self.pager.held())
        tok, pos, tbl = self._decode_inputs(dec)
        if self.decode_graph is not None:
            logits = self.decode_graph(tok, pos, tbl)
        else:
            logits = self._decode_step(self._tensor(tok), self._tensor(pos),
                                       self._tensor(tbl))
        dset = set(dec)
        rows = [self.slots[i] if i in dset else None for i in range(self.B)]
        nxt = self._sample(logits, rows)
        self.stats.steps += 1
        self.stats.max_active = max(self.stats.max_active, len(dec))
        self.stats.active_slot_steps += len(dec)
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
        """Step until queue and slots are empty.  ``max_steps`` bounds every
        iteration, idle ones included.  An iteration that works nothing
        while requests wait counts as an idle step; unless a corrupt swap
        image ate its work (the request then re-prefills), admission is
        stalled, and it raises."""
        iters = 0
        while self.queue or any(s is not None for s in self.slots):
            if iters >= max_steps:
                raise RuntimeError(
                    f"run_until_drained hit max_steps={max_steps} with "
                    f"{len(self.queue)} queued and "
                    f"{len(self._active_slots())} active request(s)")
            iters += 1
            if self.step() == 0 and self.queue:
                self.stats.idle_steps += 1
                if self._retry_pending:
                    continue
                head = self.queue[0]
                swapped = self._swapped.get(head.submit_seq)
                need = (len(swapped.private_lis) if swapped is not None
                        else self.sched.pages_needed(head, self.pager))
                raise RuntimeError(
                    f"admission stalled: queue head uid={head.uid} (prompt "
                    f"{len(head.prompt)} tokens, "
                    f"{'swapped out, ' if swapped is not None else ''}needs "
                    f"{need} pages) with free_pages={self.pager.free_pages}/"
                    f"{self.pager.num_pages - 1} and no active slot")
        return self.stats


def decode_step(params, pools, cfg: ModelConfig, tok: torch.Tensor,
                pos: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One decode step over all B rows: logits [B, V]; the pools are written
    in place (the step the engine's CUDA graph captures)."""
    return api.decode_paged_fn(params, {"token": tok, "position": pos}, pools,
                               table, cfg)[0]


def load_or_quantize(params_fp, cfg: ModelConfig, calibration_batches,
                     qcfg: QuantConfig = QuantConfig()):
    """Quantize-on-load (paper §2.3): fp params in, W4A16 params out, via the
    full SmoothQuant+ recipe (in place); the report carries the per-path
    W4A8 flags (``a8_eligibility``) and the errors that decided them.  The
    reference's PTQ artifact branch (a saved quantization reloaded instead
    of recomputed) is not ported yet (ROADMAP A3)."""
    from repro_torch.core import apply as AP

    return AP.smoothquant_plus(params_fp, cfg, calibration_batches, qcfg)
