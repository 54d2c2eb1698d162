"""Serve a smoke batch with a forced preemption and export its Chrome trace
(port of ``scripts/trace_viewer.py``).

    PYTHONPATH=src python -m repro_torch.launch.trace_viewer \\
        [--out trace.json] [--arch codellama-7b] [--requests 6] [--summary] \\
        [--device cuda|cpu]

Drives a small engine with a tight page budget and one explicit
preemption, so that the trace shows everything the engine records: the
per-slot decode and prefill-chunk slices, pool-occupancy counters,
lifecycle instants, and the ``s`` → ``f`` flow arrow from every preempt to
its swap-in resume.  Open the JSON in https://ui.perfetto.dev or
``chrome://tracing``.

As a library, :func:`drive_traced_engine` returns the drained engine to
export from.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.trace import write_chrome_trace


def drive_traced_engine(arch: str = "codellama-7b", requests: int = 6,
                        seed: int = 0, device="cuda") -> ServingEngine:
    """Serve ``requests`` synthetic prompts on a smoke config with a pool
    tight enough that lazy growth must preempt; one preemption is also
    forced after 4 steps, so the trace has a preempt → resume flow."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    params = api.init_model(cfg, seed=seed, device=dev)
    eng = ServingEngine(params, cfg, batch_size=3, max_seq=32, page_size=4,
                        num_pages=13, seed=seed, max_prefill_tokens=8,
                        device=dev)
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, 6 + i % 5)
                    .astype(np.int32), max_tokens=10)
            for i in range(requests)]
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    victims = [i for i in eng._active_slots()
               if eng.pos[i] >= eng.pref_target[i]]
    if victims:
        eng._preempt(victims[-1])
    eng.run_until_drained(max_steps=500)
    return eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--arch", default="codellama-7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--summary", action="store_true",
                    help="print an event-count summary of the written trace")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    eng = drive_traced_engine(args.arch, args.requests, device=args.device)
    obj = write_chrome_trace(args.out, eng.trace, n_slots=eng.B)
    evs = obj["traceEvents"]
    flows = sum(1 for e in evs if e["ph"] == "s")
    print(f"wrote {len(evs)} trace events ({flows} preempt->resume flows) "
          f"to {args.out} — open in https://ui.perfetto.dev")
    if args.summary:
        by_ph: dict = {}
        for e in evs:
            by_ph[e["ph"]] = by_ph.get(e["ph"], 0) + 1
        snap = eng.metrics_snapshot()
        print("events by phase:", json.dumps(by_ph, sort_keys=True))
        print("latency p50/p99 (ms):", {
            k: [round(v["p50"] * 1e3, 2), round(v["p99"] * 1e3, 2)]
            for k, v in snap["latency"].items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
