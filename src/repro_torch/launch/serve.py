"""Serving entry point: fp weights → SmoothQuant+ quantize-on-load →
continuous-batching engine (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch codellama-7b \\
        [--smoke] [--requests 12] [--no-quant] [--device cuda] \\
        [--act-quant a16|a8_prefill]

Runs on the GPU by default (``--device cuda``) and raises when there is no
card.  The weights are random, drawn from ``--seed``; PTQ runs in f32 with
group size 128 (16 under ``--smoke``).  TF32 is off for matmuls and
convolutions, so f32 work is full f32.  ``--act-quant a8_prefill`` runs
prefill-chunk GEMMs of A8-eligible layers on per-token int8 activations
(decode stays A16).  ``main`` returns the engine, the
requests and the timings for callers that drive it as a library; such a
caller may pass ``attn_impl="flash"``, which, as in the JAX CLI, has no
flag.  Serve
the Granite MoE on the CPU with ``--arch granite-moe-1b-a400m --smoke
--device cpu``, DeepSeek-V2 (MLA, shared experts) with ``--arch
deepseek-v2-236b --smoke --device cpu``.  ``--num-pages`` below the default
``batch·pages + 1`` serves under pool pressure: the engine preempts and
swaps (the pager line counts both).  On a card the decode step runs as one
CUDA graph.  ``--ptq-artifact DIR`` quantizes and saves the result to DIR
on the first boot and loads it on later ones (no calibration, no α
search); an artifact saved by the JAX package's serve loads too, and one
saved here loads there.  ``--ptq-refresh`` re-quantizes (and re-saves)
even when the artifact matches: its hash covers the configs, not the
weight values.  The boot line says which path was taken,
``[artifact-load]`` or ``[quantize-on-load]``.

Requests arrive as a Poisson stream (``--rate`` per second), stamped on the
engine's clock.  ``--shared-prefix-len N`` puts the same N tokens (a system
prompt) in front of every synthetic prompt; with ``--prefix-cache on`` (the
default, as in the JAX CLI) requests after the first prefill only their
uncached suffix.  ``--max-queue``, ``--deadline-s`` and ``--ttft-deadline-s``
bound the waiting line and each request's time; ``--chaos`` installs the
seeded fault plan of :func:`chaos_plan` (``--fault-seed``) and serves
non-strict, so the drain must survive every injection site.  The stat lines
render ``ServingEngine.metrics_snapshot()``; ``--no-metrics`` turns the
engine's recording off, and ``--trace-out PATH`` writes the step journal
and request timelines as a Chrome trace (open it in https://ui.perfetto.dev
or chrome://tracing).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.calibration import (collect_stats,
                                          synthetic_calibration_set)
from repro_torch.core.smoothing import smoothing_groups
from repro_torch.device import resolve_device, strict_fp32_matmul
from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import GROUP_MULTIPLE
from repro_torch.models import api
from repro_torch.serving.engine import Request, ServingEngine, load_or_quantize
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.trace import write_chrome_trace


def chaos_plan(seed: int = 0) -> FaultPlan:
    """``--chaos``: a seeded plan that fires at every injection site (the JAX
    CLI's plan, spec for spec)."""
    return FaultPlan([
        FaultSpec("page_alloc", every=11, times=3),
        FaultSpec("page_grow", prob=0.05, times=3),
        FaultSpec("pool_pressure", step=4, value=2, duration=3),
        FaultSpec("swap_drain", op=0, times=1),
        FaultSpec("swap_corrupt", op=1, times=1),
        FaultSpec("prefix_evict", every=5, times=2),
        FaultSpec("decode_launch", step=6, times=2),
        FaultSpec("prefill_launch", op=2, times=1),
        FaultSpec("fixed_drain", op=0, times=1),
        FaultSpec("enc_evict", op=1, times=1),
    ], seed=seed)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, attn_impl=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codellama-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--min-prompt", type=int, default=10,
                    help="shortest synthetic prompt (tokens)")
    ap.add_argument("--max-prompt", type=int, default=10,
                    help="longest synthetic prompt (tokens)")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--act-quant", choices=("a16", "a8_prefill"),
                    default="a16",
                    help="a16 (default) or a8_prefill: per-token int8 "
                         "activations on prefill-chunk GEMMs of A8-eligible "
                         "layers; decode stays A16")
    ap.add_argument("--group-size", type=int, default=None,
                    help="PTQ group size G (default 128, 16 under --smoke); "
                         "the W4 kernels take any positive multiple of 8")
    ap.add_argument("--ptq-artifact", default=None,
                    help="dir for the PTQ artifact: save on first boot, "
                         "load (skip calibration + alpha search) after")
    ap.add_argument("--ptq-refresh", action="store_true",
                    help="force re-quantization even if a matching artifact "
                         "exists (use after swapping checkpoints: the "
                         "artifact hash covers configs, not weight values)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-mode", choices=("bucketed", "slotwise"),
                    default="bucketed")
    ap.add_argument("--max-prefill-tokens", type=int, default=None)
    ap.add_argument("--reservation", choices=("lazy", "worstcase"),
                    default="lazy")
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="request arrival rate (Poisson, requests/s)")
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="on",
                    help="shared-prefix KV cache: block-hash reuse of full "
                         "prompt pages + suffix-only prefill (default on)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="give every synthetic request this many identical "
                         "leading prompt tokens (a shared system prompt)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded waiting line: submit() sheds load "
                         "(finish_reason='rejected') past this depth")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request total wall budget from arrival")
    ap.add_argument("--ttft-deadline-s", type=float, default=None,
                    help="per-request first-token budget from arrival")
    ap.add_argument("--chaos", action="store_true",
                    help="install a seeded fault plan firing at every "
                         "injection site and serve non-strict")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the --chaos fault plan")
    ap.add_argument("--no-metrics", action="store_true",
                    help="disable the engine's histograms, timelines and "
                         "step journal")
    ap.add_argument("--trace-out", default=None,
                    help="write the step journal + request timelines as "
                         "Chrome trace_event JSON")
    args = ap.parse_args(argv)
    if args.trace_out and args.no_metrics:
        ap.error("--trace-out needs metrics enabled (drop --no-metrics)")
    gs = (args.group_size if args.group_size is not None
          else 16 if args.smoke else 128)
    if not args.no_quant and (gs <= 0 or gs % GROUP_MULTIPLE):
        # refused before the model is built: no W4 kernel takes this group
        ap.error(f"--group-size {gs}: the W4 kernels take a positive "
                 f"multiple of {GROUP_MULTIPLE}")

    device = resolve_device(args.device)
    strict_fp32_matmul()
    if device.type == "cuda":
        # build every kernel now, in parallel, not inside the first request
        print(f"[kernels] built in {_build.build_all():.1f}s")
    cfg = get_config(args.arch, smoke=args.smoke).with_(
        act_quant=args.act_quant)
    if attn_impl is not None:
        cfg = cfg.with_(attn_impl=attn_impl)
    if not args.no_quant:
        cfg = cfg.with_(dtype="float32")      # PTQ math in f32
    t0 = time.perf_counter()
    params = api.init_model(cfg, seed=args.seed, device=device)
    _sync(device)
    boot_s = time.perf_counter() - t0

    rep, ptq_s, calib, mode, used = None, 0.0, [], None, 0
    if not args.no_quant:
        calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
        t0 = time.perf_counter()
        seen = collect_stats.batches
        params, rep = load_or_quantize(
            params, cfg, calib, QuantConfig(group_size=gs),
            artifact_dir=args.ptq_artifact, refresh=args.ptq_refresh)
        _sync(device)
        ptq_s = time.perf_counter() - t0
        # label the boot by the path taken: a boot that read no calibration
        # batch loaded the artifact
        used = collect_stats.batches - seen
        mode = "quantize-on-load" if used else "artifact-load"
        print(f"[{mode}] alpha={rep.alpha:.2f} "
              f"{rep.fp_bytes / 1e6:.1f}MB -> {rep.quant_bytes / 1e6:.1f}MB "
              f"in {ptq_s:.1f}s")
        flags = rep.a8_eligibility
        groups = smoothing_groups(cfg)
        n_groups = sum(flags[f"layers/{'/'.join(g.weights[0])}"]
                       for g in groups)
        print(f"[w4a8] act_quant={args.act_quant}; A8-eligible groups "
              f"{n_groups}/{len(groups)}, weight paths "
              f"{sum(flags.values())}/{len(flags)}: "
              + ", ".join(f"{k.split('/', 1)[1]}={'a8' if v else 'a16'}"
                          for k, v in flags.items()))

    fault_plan = chaos_plan(args.fault_seed) if args.chaos else None
    prefix_cache = args.prefix_cache == "on"
    eng = ServingEngine(params, cfg, batch_size=args.batch_size,
                        max_seq=args.max_seq, page_size=args.page_size,
                        num_pages=args.num_pages,
                        prefill_mode=args.prefill_mode,
                        max_prefill_tokens=args.max_prefill_tokens,
                        reservation=args.reservation, seed=args.seed,
                        prefix_cache=prefix_cache, max_queue=args.max_queue,
                        fault_plan=fault_plan, strict=not args.chaos,
                        metrics=not args.no_metrics, device=device)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(args.min_prompt, args.max_prompt + 1, args.requests)
    sys_p = rng.integers(2, cfg.vocab_size,
                         args.shared_prefix_len).astype(np.int32)
    reqs = [Request(uid=i, prompt=np.concatenate(
                        [sys_p, rng.integers(2, cfg.vocab_size, int(n)
                                             ).astype(np.int32)]),
                    max_tokens=args.max_tokens,
                    deadline_s=args.deadline_s,
                    ttft_deadline_s=args.ttft_deadline_s)
            for i, n in enumerate(lens)]
    # Poisson arrival offsets, drawn after the prompts, rebased on the
    # engine's clock at submit time: deadlines count from arrival
    gaps = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    _sync(device)
    t0 = time.perf_counter()
    base = eng._clock()
    for r, g in zip(reqs, gaps):
        r.arrival_t = base + float(g)
    accepted = sum(eng.submit(r) for r in reqs)
    eng.run_until_drained()
    _sync(device)
    dt = time.perf_counter() - t0

    # every stat line renders the engine's metrics_snapshot()
    snap = eng.metrics_snapshot()
    st = snap["engine"]

    def ms(h, k="p50"):
        return f"{snap['latency'][h][k] * 1e3:.1f}ms"

    print(f"served {st['completed']}/{args.requests} requests "
          f"({accepted} accepted), {st['decoded_tokens']} decoded + "
          f"{st['prefilled_tokens']} prefilled tokens in {dt:.2f}s "
          f"({st['decoded_tokens'] / dt:.1f} decode tok/s)")
    if not args.no_metrics:
        print(f"latency: ttft p50={ms('ttft_s')} max={ms('ttft_s', 'max')} "
              f"p99={ms('ttft_s', 'p99')}  itl p50={ms('itl_s')} "
              f"p99={ms('itl_s', 'p99')}  e2e p50={ms('e2e_s')} "
              f"p99={ms('e2e_s', 'p99')}  queue-wait "
              f"p50={ms('queue_wait_s')}  swap-stall "
              f"p50={ms('swap_stall_s')}")
    print(f"lifecycle: rejected={st['rejected']} expired={st['expired']} "
          f"cancelled={st['cancelled']} failed={st['failed']} "
          f"retries={st['retries']} faults_injected={st['faults_injected']}")
    if fault_plan is not None:
        print(f"chaos: fault counters "
              f"{snap['counters'].get('faults_fired_total', {})}")
    pg = snap["pager"]
    print(f"pager: peak concurrency {st['max_active']}/{args.batch_size}, "
          f"{st['grown_pages']} pages grown lazily, "
          f"{st['preemptions']} preemptions "
          f"({st['swapped_out_bytes'] / 1e6:.1f}MB swapped out, "
          f"{st['swapped_in_bytes'] / 1e6:.1f}MB back in); "
          f"free={pg['free_pages']}/{pg['total_pages']} "
          f"counts={pg['counts']}")
    if prefix_cache:
        hit = st["prefix_hits"] / max(st["admitted"], 1)
        print(f"prefix-cache: hit-rate {hit:.0%} "
              f"({st['prefix_hits']}/{st['admitted']} admissions, "
              f"{st['prefix_matched_tokens']} prompt tokens served from "
              f"cache), {st['pages_shared']} pages shared, "
              f"{st['pages_inserted']} inserted, "
              f"{st['pages_evicted']} evicted, "
              f"{st['cow_copies']} copy-on-writes")
    if args.trace_out:
        obj = write_chrome_trace(args.trace_out, eng.trace,
                                 n_slots=args.batch_size)
        print(f"trace: {len(obj['traceEvents'])} events -> "
              f"{args.trace_out}")
    ttft = [r.first_token_t - r.arrival_t for r in reqs
            if r.first_token_t is not None]
    art = Path(args.ptq_artifact) if args.ptq_artifact else None
    return {"engine": eng, "requests": reqs, "report": rep, "cfg": cfg,
            "boot_s": boot_s, "ptq_s": ptq_s, "serve_s": dt, "ttft_s": ttft,
            "calib_batches": len(calib) if used else 0, "ptq_mode": mode,
            "ptq_artifact_bytes": (sum(f.stat().st_size for f in art.iterdir())
                                   if art is not None and art.is_dir()
                                   else 0)}


if __name__ == "__main__":
    main()
