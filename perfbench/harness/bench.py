"""One run of one cell: set-up, warm-up, the measured window, the traced
slice when asked, then the check against the reference.

Set-up is everything from the process's start to the window's start: the
imports, the weights made and quantized on the device, the engine, the
kernels' build (cached in the checkout after a cell's first run) and the
warm-up.  The warm-up runs the cell's own traffic, as the mix's loop
(``loops/<loop>.py``) says: a backlog until the batch is full and
completions have begun.  The window then runs the same loop on for
``seconds``.
"""
from __future__ import annotations

import dataclasses
import gc
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from perfbench.harness import cell as C
from perfbench.harness import correct, program, stats, traffic
from perfbench.harness.loop import CLOCK, Capture, Hooks, Loop
from perfbench.harness.profile import Slice, device_ops, idle_gaps
from perfbench.harness.readers import Record

PROFILE_AT = 0.3          # the slice starts this far into the window
PROFILE_S = 3.0           # and lasts this long (at most 0.3 of the window)


@dataclasses.dataclass
class Run:
    config: dict
    mix: dict
    name: str                       # the cell
    chips: int
    e2e: List[dict]                 # end-to-end metric entries
    per_layer: List[dict]           # per-layer metric entries
    base: Path = C.PB               # where the cell's files are found


def from_bench(workload: str, root: Path = C.ROOT) -> Run:
    """The cell named ``workload`` in ``root``'s ``BENCHMARK.json``, its
    files found under ``root/perfbench``."""
    root = Path(root)
    bench = C.load_bench(root)
    w = C.workload(bench, workload)
    return Run(C.config(bench, w["config"], root),
               C.mix(w["traffic"], root / "perfbench"), workload,
               int(w["chips"]), C.end_to_end(bench, workload),
               C.per_layer(bench, workload), root / "perfbench")


def _e2e(name: str, recs, t0: float, t1: float, emitted: int,
         setup_s: float) -> Optional[float]:
    if name == "setup_s":
        return setup_s
    if name == "output_tok_s":
        return emitted / (t1 - t0)
    if name == "tpot_p90_ms":
        # every request that was decoding in the window: those that ended
        # in it over their whole span, those still decoding up to its end
        v = stats.tpots([r for r in recs if r.done_t is None
                         or r.done_t >= t0], t1)
        return stats.percentile(v, 0.9) * 1e3 if v else None
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def run(spec: Run, seed: int, seconds: float, trace: bool, device,
        t_start: float, on_engine: Optional[Callable] = None,
        control: bool = False) -> dict:
    """The result line's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``trace`` also ``breakdown``) and the
    numbers compared, under ``checks``.  ``control`` also runs the
    reference at the lower precision over the same tokens and reports its
    numbers in the program's place: they are what ``checks`` holds and
    ``correct`` judges, and the program's own go under ``program``
    (``tools/control.py``)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    phases = {"imports_s": CLOCK() - t_start}
    cfg = program.model_config(spec.config)
    params = program.build_params(spec.config, cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    phases["weights_s"] = CLOCK() - t_start - sum(phases.values())
    engine = program.build_engine(params, cfg, spec.mix["engine"], seed,
                                  device)
    if on_engine is not None:        # tests plant faults here
        on_engine(engine)
    capture = Capture(engine)
    hooks = Hooks(engine) if trace else None
    if trace and cuda:
        Slice.warm()
    items = traffic.stream(spec.mix, seed, spec.config["model"]["vocab_size"])
    loop = Loop(engine, items, spec.mix,
                C.loop_kind(spec.mix["loop"], spec.base), hooks)
    loop.kind.warm(loop)
    if cuda:
        torch.cuda.synchronize()
    t0 = CLOCK()
    setup_s = t0 - t_start
    phases["engine_and_warmup_s"] = setup_s - sum(phases.values())
    emitted0 = loop.emitted()
    queued0 = len(engine.queue)
    stats0 = dataclasses.asdict(engine.stats)
    prof = Slice() if trace and cuda else None
    p_on = t0 + PROFILE_AT * seconds
    state = {"on": False, "done": False, "off": math.inf}

    def between(now: float) -> None:
        if prof is None or state["done"]:
            return
        if not state["on"] and now >= p_on:
            t = CLOCK()
            prof.start()
            prof.cost["start_s"] = CLOCK() - t
            # the slice's length counts from the tracer's start-up's end
            state["off"] = CLOCK() + min(PROFILE_S, 0.3 * seconds)
            state["on"] = loop.profiling = True
        elif state["on"] and now >= state["off"]:
            t = CLOCK()
            prof.stop()
            prof.cost["stop_s"] = CLOCK() - t
            state["done"], loop.profiling = True, False

    loop.record_steps = trace
    t1 = loop.run_until(t0 + seconds, between=between)
    if prof is not None and state["on"] and not state["done"]:
        prof.stop()
    loop.record_steps = False
    emitted = loop.emitted() - emitted0
    recs = loop.records()
    stats1 = dataclasses.asdict(engine.stats)
    load = {"queued_at_open": queued0, "queued_at_close": len(engine.queue),
            "finished": sum(1 for r in recs if r.done_t is not None
                            and t0 <= r.done_t <= t1), "setup": phases}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out: Dict = {}
    metrics: Dict[str, dict] = {}
    if trace:
        t = CLOCK()
        tr = prof.trace() if prof is not None and state["on"] else None
        if tr is not None:
            prof.cost["export_s"] = CLOCK() - t
            out["tracing"] = dict(prof.cost)
        rec = Record(spec.config, spec.mix, t0, t1, loop.steps, recs, stats0,
                     stats1, tr)
        reads = C.readers([m["name"] for m in spec.per_layer], spec.base)
        for m in spec.per_layer:
            v = reads[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            out["breakdown"] = {"device_ops": device_ops(tr),
                                "idle_gaps": idle_gaps(tr)}
    else:
        for m in spec.e2e:
            v = _e2e(m["name"], recs, t0, t1, emitted, setup_s)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    window = [r for r in recs if r.due <= t1 and (r.done_t is None
                                                  or r.done_t >= t0)]
    bad = [r for r in recs if r.finish in stats.TERMINAL_BAD]
    short = [r for r in recs if r.finish == "length"
             and r.n_out != r.max_tokens]
    uids = correct.sample(recs, t0, t1, seed, int(spec.mix["check"]["sample"]))
    seqs = loop.finished_tokens(set(uids))
    best = capture.best(set(uids))
    # free the program's state before the reference runs
    if hooks is not None:
        hooks.close()
    del loop, engine, params, hooks, items, prof, capture
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = (correct.compare(spec.config, seed, seqs, best, device,
                           control=control) if seqs else {})
    mine = {k: v for k, v in got.items() if not k.startswith("control_")}
    judged = ({k[len("control_"):]: v for k, v in got.items()
               if k.startswith("control_")} if control else mine)
    if control:
        out["program"] = mine
    # the configuration names the numbers it is held to, with their limits
    checks = {k: {"value": judged.get(k), "limit": float(v)}
              for k, v in spec.config["correct"].items()}
    checks.update(failed={"value": len(bad), "limit": 0},
                  short={"value": len(short), "limit": 0})
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    out.update(correct=ok, attempted=len(window), failed=len(bad),
               metrics=metrics, device=dev, checks=checks,
               load=load,
               compared={"numbers": judged,
                         "requests": len(seqs),
                         "tokens": int(sum(len(o) for _, o in seqs.values())),
                         "window_s": t1 - t0})
    return out
