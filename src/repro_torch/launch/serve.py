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
    args = ap.parse_args(argv)
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

    eng = ServingEngine(params, cfg, batch_size=args.batch_size,
                        max_seq=args.max_seq, page_size=args.page_size,
                        num_pages=args.num_pages,
                        prefill_mode=args.prefill_mode,
                        max_prefill_tokens=args.max_prefill_tokens,
                        reservation=args.reservation, seed=args.seed,
                        device=device)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(args.min_prompt, args.max_prompt + 1, args.requests)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, int(n)
                                               ).astype(np.int32),
                    max_tokens=args.max_tokens)
            for i, n in enumerate(lens)]
    _sync(device)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    _sync(device)
    dt = time.perf_counter() - t0
    st = eng.stats
    ttft = [r.first_token_t - r.arrival_t for r in reqs]
    print(f"served {st.completed}/{args.requests} requests, "
          f"{st.decoded_tokens} decoded + {st.prefilled_tokens} prefilled "
          f"tokens in {dt:.2f}s ({st.decoded_tokens / dt:.1f} decode tok/s); "
          f"ttft p50={np.median(ttft) * 1e3:.1f}ms max={max(ttft) * 1e3:.1f}ms")
    print(f"pager: peak concurrency {st.max_active}/{args.batch_size}, "
          f"{st.grown_pages} pages grown lazily, "
          f"{st.preemptions} preemptions "
          f"({st.swapped_out_bytes / 1e6:.1f}MB swapped out, "
          f"{st.swapped_in_bytes / 1e6:.1f}MB back in); "
          f"free={eng.pager.free_pages}/{eng.pager.num_pages - 1}")
    art = Path(args.ptq_artifact) if args.ptq_artifact else None
    return {"engine": eng, "requests": reqs, "report": rep, "cfg": cfg,
            "boot_s": boot_s, "ptq_s": ptq_s, "serve_s": dt, "ttft_s": ttft,
            "calib_batches": len(calib) if used else 0, "ptq_mode": mode,
            "ptq_artifact_bytes": (sum(f.stat().st_size for f in art.iterdir())
                                   if art is not None and art.is_dir()
                                   else 0)}


if __name__ == "__main__":
    main()
