"""The benchmark's single-threaded serving loop: it submits each request
with ``ServingEngine.submit`` once the request is due, then calls
``ServingEngine.step()``, until the window ends.

When a request is due is the mix's loop's business: ``loops/<loop>.py``
(the mix's ``loop``), with ``feed(loop, now)``, which submits what is due
and returns when the next request falls due (None: the engine always has
work), and ``warm(loop)``, the warm-up on the cell's own traffic.

In a traced run :class:`Hooks` wraps the engine's layers in
``torch.profiler`` spans and records each step's live work (its decoding
rows and its prefill-chunk buckets) for the roofline arithmetic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from perfbench.harness import program
from perfbench.harness.stats import Rec
from perfbench.harness.traffic import Item
from perfbench.roofline.count import Work

CLOCK = time.perf_counter


@dataclasses.dataclass
class StepRec:
    t_a: float
    t_b: float
    worked: int
    work: Work
    profiled: bool


class Hooks:
    """Spans around the engine's layers, named for the port's modules, and
    the live work of each step (traced runs only)."""

    SPANS = (("step", "serving.engine.ServingEngine.step"),
             ("_admit", "serving.engine.ServingEngine._admit"),
             ("_sample", "serving.engine.ServingEngine._sample"))

    def __init__(self, engine):
        self.work: Optional[Work] = None
        self.api = program.api_module()
        self._orig_chunk = self.api.prefill_chunk_fn
        for attr, name in self.SPANS:
            setattr(engine, attr, self._span(name, getattr(engine, attr)))
        self.api.prefill_chunk_fn = self._span("models.api.prefill_chunk_fn",
                                               self._orig_chunk)
        plan = engine.sched.plan_chunks

        def plan_chunks(*a, **k):
            bkts = plan(*a, **k)
            if self.work is not None:
                self.work.chunks.extend(
                    [list(zip(b.starts, b.lens)) for b in bkts])
            return bkts

        engine.sched.plan_chunks = plan_chunks
        attr = "decode_graph" if engine.decode_graph is not None \
            else "_decode_step"
        decode = getattr(engine, attr)
        span = self._span("serving.decode_graph.DecodeGraph", decode)

        def decode_call(*inputs):
            pos = inputs[1]
            pos = pos.cpu().numpy() if isinstance(pos, torch.Tensor) \
                else np.asarray(pos)
            if self.work is not None:
                # idle rows sit at position 0; a decoding row is past its
                # prompt, so its keys are its position plus its own
                self.work.decode.extend(int(p) + 1 for p in pos if p > 0)
            return span(*inputs)

        setattr(engine, attr, decode_call)

    @staticmethod
    def _span(name: str, fn: Callable) -> Callable:
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return wrapped

    def close(self) -> None:
        self.api.prefill_chunk_fn = self._orig_chunk


class Capture:
    """The program's best logit at each sampling: ``ServingEngine._sample``
    is wrapped to queue one max-reduction of the logits it is handed
    (copied to the host only after the window) and to note which request
    and which of its tokens each row is.  Greedy decoding serves the best
    token, so this is the logit of the token served."""

    def __init__(self, engine):
        self.maxes: List[torch.Tensor] = []
        self.rows: List[list] = []
        sample = engine._sample

        def wrapped(logits, reqs):
            self.maxes.append(logits.max(dim=-1).values)
            self.rows.append([(r.uid, len(r.output)) if r is not None
                              else None for r in reqs])
            return sample(logits, reqs)

        engine._sample = wrapped

    def best(self, uids) -> dict:
        """``uid -> {token index: best logit}`` of the given requests."""
        vals = torch.cat(self.maxes).cpu().numpy() if self.maxes else []
        out: dict = {u: {} for u in uids}
        i = 0
        for rows in self.rows:
            for row in rows:
                if row is not None and row[0] in out:
                    out[row[0]][row[1]] = float(vals[i])
                i += 1
        return out


class Loop:
    def __init__(self, engine, items: Iterator[Item], mix: dict, kind,
                 hooks: Optional[Hooks] = None):
        self.engine = engine
        self.items = items
        self.mix = mix
        self.kind = kind                     # the module loops/<loop>.py
        self.hooks = hooks
        self.sent: List[tuple] = []          # (item, request, submit_t, due)
        self.steps: List[StepRec] = []
        self.record_steps = False
        self.profiling = False

    clock = staticmethod(CLOCK)

    # ------------------------------------------------------------ submit --
    def submit(self, item: Item, due: float) -> None:
        req = program.request(item, due)
        t = CLOCK()
        self.engine.submit(req)
        self.sent.append((item, req, t, due))

    def busy(self) -> bool:
        e = self.engine
        return bool(e.queue) or any(s is not None for s in e.slots)

    def _step(self) -> int:
        if self.hooks is not None:
            self.hooks.work = Work() if self.record_steps else None
        t_a = CLOCK()
        worked = self.engine.step()
        t_b = CLOCK()
        if self.record_steps:
            self.steps.append(StepRec(t_a, t_b, worked, self.hooks.work
                                      if self.hooks else Work(),
                                      self.profiling))
        return worked

    def run_until(self, t_end: float,
                  stop: Optional[Callable[[], bool]] = None,
                  between: Optional[Callable[[float], None]] = None) -> float:
        """Run the mix's loop until ``t_end`` (or ``stop()``); returns the
        clock after the last step."""
        while True:
            now = CLOCK()
            nxt = self.kind.feed(self, now)
            if between is not None:
                between(now)
            if self.busy():
                self._step()
            elif nxt is not None:
                time.sleep(max(0.0, min(nxt, t_end) - CLOCK()))
            now = CLOCK()
            if now >= t_end or (stop is not None and stop()):
                return now

    # ------------------------------------------------------------ report --
    def emitted(self) -> int:
        return sum(len(r.output) for _, r, _, _ in self.sent)

    def records(self) -> List[Rec]:
        out = []
        for item, r, t, due in self.sent:
            out.append(Rec(uid=item.uid, prompt_len=len(item.prompt),
                           max_tokens=item.max_tokens, due=due, submit_t=t,
                           first_t=r.first_token_t, done_t=r.done_t,
                           n_out=len(r.output), finish=r.finish_reason))
        return out

    def finished_tokens(self, uid_set) -> dict:
        """``uid -> (prompt, output)`` of the given requests."""
        return {i.uid: (np.asarray(i.prompt), np.asarray(r.output, np.int64))
                for i, r, _, _ in self.sent if i.uid in uid_set}
