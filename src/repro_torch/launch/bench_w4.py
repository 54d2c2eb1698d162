"""Device times of the port's four int4-weight GEMM kernels on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_w4 [--reps N]
        [--only REGEX] [--json PATH]

K1 (``w4a16_matmul_cuda``) and B5 (``w4a8_matmul_cuda``) at codellama-7b's
linear shapes, B6 (``w4a16_grouped_cuda``) and B7 (``w4a8_grouped_cuda``)
at granite-moe-1b-a400m's expert shapes, G=128, f32 and bf16 activations;
B5/B7 with a group whose zero fold needs the clip.  A case's time is that
of ``chip_smoke.py``: a CUDA graph of 24 wrapper calls cycling through
weight copies that together exceed L2, replayed, CUDA-event time per call
(device time; B5/B7 include the activation quantization).  Each case is
timed ``--reps`` times, the passes interleaved over the cases; ``--only``
keeps the cases whose "KERNEL CASE" label (as printed) matches a regex.

The script calls only the kernels' public wrappers with arguments every
version of the port takes (no ``rows``), so a copy of it runs in an older
checkout: to compare two versions, run each checkout's copy in turns
(A, B, B, A) in one session on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

L2_BYTES = 50 * 2 ** 20
LINEARS = ((4096, 4096), (4096, 11008), (11008, 4096))   # codellama-7b
EXPERTS = ((1024, 512), (512, 1024))     # granite-moe-1b-a400m, E=32
CLIP_ZEROS = (140.0, 130.0, -150.0, -114.0)


def graph_ms(fns, stream, calls=24, min_total_ms=60.0):
    """Mean device time of one call: ``calls`` calls cycling through
    ``fns`` captured in one CUDA graph on ``stream``, replayed."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(calls):
            fns[i % len(fns)]()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    reps = int(min(max(min_total_ms / max(start.elapsed_time(end), 1e-3),
                       3), 100))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _copies(qt, n_bytes):
    n = max(1, math.ceil(2 * L2_BYTES / n_bytes))
    return [qt] + [qt.map(torch.clone) for _ in range(n - 1)]


def _clip_group(qt):
    zeros = qt.zeros.clone()
    zeros[..., 0, :len(CLIP_ZEROS)] = torch.tensor(CLIP_ZEROS)
    return dataclasses.replace(qt, zeros=zeros)


def cases(dev, keep):
    """(name, case, [calls], quantizer call or None) for every case whose
    label ``keep`` accepts."""
    from repro_torch.core.quantize import quantize, quantize_acts_per_token
    from repro_torch.kernels import w4a16_grouped as W4G
    from repro_torch.kernels import w4a16_matmul as W4

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for ci, co in LINEARS:
        w = torch.randn(ci, co, generator=gen, device=dev) * ci ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            qt = quantize(w, group_size=128, dtype=dt)
            for name, fn, ts, q in (
                    ("K1", W4.w4a16_matmul_cuda, (4, 512), qt),
                    ("B5", W4.w4a8_matmul_cuda, (64, 512), _clip_group(qt))):
                labels = [f"T={t} {ci}x{co} {str(dt)[6:]}" for t in ts]
                if not any(keep(f"{name} {c}") for c in labels):
                    continue
                qts = _copies(q, q.nbytes_quant())
                for t, label in zip(ts, labels):
                    if not keep(f"{name} {label}"):
                        continue
                    x = torch.randn(t, ci, generator=gen, device=dev).to(dt)
                    out.append((name, label,
                                [lambda q=q_, x=x, f=fn: f(x, q)
                                 for q_ in qts],
                                (lambda x=x: quantize_acts_per_token(x))
                                if name == "B5" else None))
    for ci, co in EXPERTS:
        w = torch.randn(32, ci, co, generator=gen, device=dev) * ci ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            qt = quantize(w, group_size=128, dtype=dt)
            for name, fn, cs, q in (
                    ("B6", W4G.w4a16_grouped_cuda, (8, 160), qt),
                    ("B7", W4G.w4a8_grouped_cuda, (160,), _clip_group(qt))):
                labels = [f"E=32 C={c} {ci}x{co} {str(dt)[6:]}" for c in cs]
                if not any(keep(f"{name} {c}") for c in labels):
                    continue
                qts = _copies(q, q.nbytes_quant())
                for c, label in zip(cs, labels):
                    if not keep(f"{name} {label}"):
                        continue
                    x = torch.randn(32, c, ci, generator=gen,
                                    device=dev).to(dt)
                    out.append((name, label,
                                [lambda q=q_, x=x, f=fn: f(x, q)
                                 for q_ in qts],
                                (lambda x=x: quantize_acts_per_token(x))
                                if name == "B7" else None))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="regex: keep the cases whose label matches")
    ap.add_argument("--json", default=None,
                    help="also write every time to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_w4: no CUDA device available")
    from repro_torch.device import strict_fp32_matmul
    from repro_torch.kernels import _build

    strict_fp32_matmul()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"kernel build: {_build.build_all():.1f}s", flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.Stream()
    todo = cases(dev, re.compile(args.only).search)
    times = [[] for _ in todo]
    for _ in range(args.reps):
        for i, (_, _, fns, _) in enumerate(todo):
            times[i].append(graph_ms(fns, stream))
    rows = []
    for (name, case, _, quant), ms in zip(todo, times):
        q_ms = graph_ms([quant], stream) if quant else None
        rows.append(dict(kernel=name, case=case, ms=ms,
                         median_ms=statistics.median(ms), act_quant_ms=q_ms))
        extra = "" if q_ms is None else f"  (quantizer {q_ms:.4f})"
        print(f"{name} {case:28s} median {statistics.median(ms):.4f} ms  "
              f"[{' '.join(f'{m:.4f}' for m in ms)}]{extra}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(dict(card=card, rows=rows),
                                              indent=1))


if __name__ == "__main__":
    main()
