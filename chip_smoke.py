"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--json PATH]

Needs one NVIDIA GPU (sm_90a) and nvcc; exits non-zero without printing a
result when there is no card or when run outside a checkout of the repo.
Imports neither JAX nor the JAX package.  Phases, each fatal on failure:

1. setup — card name and power limit, torch/CUDA versions, kernel build time
   (one nvcc per source, in parallel);
2. kernels — K1 (W4A16 GEMM), K2 (paged decode), K3 (paged chunked prefill),
   B5 (W4A8 GEMM), the int8-pool branches of K2/K3, B6/B7 (grouped W4A16 /
   W4A8 expert GEMMs, ragged zero capacity rows; B6 also on deepseek's
   routed decode with per-expert ``rows`` and the idle experts' scales
   NaN), B4 (flash attention, on K3's tile; path 3's calibration shape
   too), B8/B9 (absorbed MLA paged decode / chunked prefill, fp and int8
   latent pools), K1/B6 with an offset-only group and K1/B5/B6/B7 with
   G=256, against their plain PyTorch versions at the paths' shapes, with
   CUDA-event times beside the plain version's, one PyTorch library call's
   (never used by the port) and the card's bound.  Every kernel and its
   library call are timed as CUDA graphs of the calls, their kernels'
   device time (B5/B7: with the activation quantization, whose graph time
   alone is printed beside; K2/B8: the split kernel and its combine), with
   the eager wrapper's time beside it, over copies of the weights, pools or
   operands that together exceed L2; K1/B6's bound counts the function's
   2*rows*Ci*Co operations at the bf16 tensor-core rate (989 TFLOP/s) for
   f32 and bf16 X alike, K3's, B4's and B8/B9's their multiply-adds
   likewise (the f32 CUDA-core rate's bound beside it), B5/B7's at the int8
   rate (1,979 TOP/s) and, with ``rows``, only the live experts' bytes;
   K2/K3 also at the paths' own shapes, K3 also behind a 1920-token prefix
   with peaked scores (fp and int8 pools: P V sums past 2048 keys); then
   the phase's peak memory;
3. paths — full width with random seeded weights, 8 requests (prompts of
   32-200 tokens, 16 new tokens, batch 4, greedy), every launch counter set
   to 0 just before and read just after each path; during each path the
   operands of every kernel's first launch at each distinct shape are kept
   (the decode step's from an eager rerun of the path's first decode step,
   its launches not counted), and after it each kernel is held against its
   plain version on them.  Every engine decodes through one CUDA graph:
   after each counted run the replays must equal the decode steps, and in
   the decode profile one replay's logits and pool writes are held bitwise
   against an eager step on a copy of the pools:
   path 1 — codellama-7b, SmoothQuant+ quantize-on-load in f32 (G=128)
   through the serve entry, fp pools, A16; one prefill and one decode step
   checked against the same step on the dequantized weights with the
   dense-gather oracle; path 1b — path 1's params, the same requests, page
   size 4 and 72 pages: at least two preemptions, every one resumed by
   swap-in, the bytes swapped out equal to those swapped in, the outputs
   token-identical to path 1's, launch counts as path 1's prediction;
   path 2 — codellama-7b, seeded hot channels injected into the embedding,
   quantize-on-load with the W4A8 eligibility pass, then the engine with
   int8 KV pools and ``act_quant="a8_prefill"`` (``max_prefill_tokens=128``);
   its launch counts must equal the counts predicted from the A8 flags and
   the engine's chunk log; step checks (a) int8-pool steps vs the gather
   oracle, (b) decode under a8_prefill bitwise equal to a16, (c) an A8
   prefill chunk within a stated limit of A16, with the same next token;
   path 3 — granite-moe-1b-a400m (32 experts, top-8) through the serve entry
   with ``attn_impl="flash"`` and ``act_quant="a8_prefill"``, fp pools: the
   calibration passes run B4, prefill chunks run B7 on A8-eligible expert
   stacks (capacity >= 16 rows) and decode runs B6; launch counts must equal
   the prediction from the A8 flags, the chunk log and the calibration set;
   step checks (a)-(c) as path 2's, and (d) ``api.forward_fn`` on a
   2048-token sequence under flash against chunked (both A16), with the
   flash forward's device time (torch.profiler) and B4's share; then the
   same model served with ``--group-size 256`` (4 requests): K1/B6 and
   B7 launch, each held against its plain version on the path's operands;
   path 4 — deepseek-v2-236b at full width, depth cut to 2 layers (MLA with
   128 heads over a 512-wide latent, 160 routed experts top-6 beside 2
   shared ones), SmoothQuant+ quantize-on-load in f32 (G=128) through the
   library entry points, then the engine with ``max_prefill_tokens=128``,
   A16, fp latent pools: prefill chunks run B9 over prefix pages, decode
   runs B8, the absorbed ``wk_t``/``wv`` pair and the experts run B6, the
   other linears K1; path 4b — a second engine over the same quantized
   params with int8 latent pools (the int8 instances of B8/B9), the same
   requests.  Each: launch counts equal to the prediction from the engine's
   steps and prefill batches, operand checks, step check (a);
4. summary — a ``kernels`` JSON line, the card line, and the final ``ok``
   line.  ``--json PATH`` also writes every measurement to PATH.

TF32 is disabled for matmuls and convolutions: f32 work is full f32.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: src/repro_torch not found beside this script — "
             "run it from a checkout of the repository")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device available")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core.quantize import (QuantizedTensor, dequantize,  # noqa: E402,E501
                                        quantize, quantize_acts_per_token)
from repro_torch.device import strict_fp32_matmul  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import w4a16_grouped as W4G  # noqa: E402
from repro_torch.kernels import w4a16_matmul as W4  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import mlp as MLP  # noqa: E402
from repro_torch.serving.decode_graph import DecodeGraph  # noqa: E402

HBM_BYTES_S = 3.35e12                 # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12,   # CUDA-core f32 (the kernels' route)
              torch.bfloat16: 989e12,
              torch.int8: 1979e12}    # int8 tensor cores
L2_BYTES = 50 * 2 ** 20
DEV = torch.device("cuda")
# one stream for every graph's warm-up and capture: each new stream that
# runs a cuBLAS call (the library rows) gets a cuBLAS workspace that lives
# as long as the process and would count in every later peak memory
GRAPH_STREAM = torch.cuda.Stream()
RESULTS = {"kernels": {}, "rows": []}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fns, min_total_ms=60.0):
    """Mean CUDA-event time of one call, cycling through ``fns`` (distinct
    operand copies, so a weight set larger than L2 is read cold)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    torch.cuda.synchronize()
    once = max((time.perf_counter() - t0) * 1e3, 1e-3)
    iters = int(min(max(min_total_ms / once, 5), 200))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, calls=24, min_total_ms=60.0):
    """Device time of one call: ``calls`` calls cycling through ``fns``
    captured in one CUDA graph, replayed, CUDA-event time over the calls.
    No host launch cost is in it: where a call's kernels take less time
    than the Python wrapper needs to launch them, :func:`time_ms` measures
    the wrapper."""
    side = GRAPH_STREAM
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    once = max((time.perf_counter() - t0) * 1e3, 1e-3)
    reps = int(min(max(min_total_ms / once, 3), 100))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def bound(nbytes, flops, dtype):
    t_b, t_f = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def tc_bound(nbytes, macs):
    """K1/B6's bound: the function's ``macs`` multiply-adds at the bf16
    tensor-core rate, whatever X's type (the three MMA passes that f32 X
    costs the tile are its design's, not the function's), against the
    bytes."""
    return bound(nbytes, 2.0 * macs, torch.bfloat16)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def record(kernel, case, err, tol, ms, plain_ms, lib_ms, bnd, by,
           wrapper_ms=None, quant_ms=None, extra=None):
    row = dict(kernel=kernel, case=case, max_abs_err=err, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
               bound_by=by, **(extra or {}))
    if wrapper_ms is not None:
        row["wrapper_ms"] = wrapper_ms
    if quant_ms is not None:
        row["act_quant_ms"] = quant_ms
    RESULTS["rows"].append(row)
    wrap = "" if wrapper_ms is None else f" (eager wrapper {wrapper_ms:.4f}ms)"
    if quant_ms is not None:
        wrap += f" (of which activation quantization {quant_ms:.4f}ms)"
    if extra:
        wrap += "".join(f" {k}={v:.4f}" if isinstance(v, float)
                        else f" {k}={v}" for k, v in extra.items())
    print(f"  {kernel:18s} {case:44s} err={err:.3g} (tol {tol:.3g}) "
          f"kernel={ms:.4f}ms{wrap} plain={plain_ms:.4f}ms "
          f"library={lib_ms:.4f}ms bound={bnd:.4f}ms ({by})", flush=True)
    require(err <= tol, f"{kernel} {case}: max |kernel - plain| = {err} > {tol}")
    return row


# --------------------------------------------------------------- kernels ---
def _gemm_case(name, cuda_fn, plain_fn, qt, x, a8, tag):
    """One K1 (``a8=False``) or B5 case: the kernel against its plain
    version, then timed over copies of the weight that together exceed L2,
    beside the plain version and bf16 ``torch.matmul`` on the dequantized
    weight (the library).  The kernel's time is its device time (a CUDA
    graph of the wrapper's calls: for B5 the activation quantization and
    the kernels; the library likewise), the eager wrapper's time beside it;
    for B5 also the graph time of the activation quantization alone."""
    t, ci = x.shape
    co, dt = qt.shape[-1], x.dtype
    n_copy = max(1, math.ceil(2 * L2_BYTES / qt.nbytes_quant()))
    qts = [qt] + [qt.map(torch.clone) for _ in range(n_copy - 1)]
    w_lib = dequantize(qt, torch.bfloat16)
    libs = [w_lib] + [w_lib.clone() for _ in range(
        max(0, math.ceil(2 * L2_BYTES / w_lib.nbytes) - 1))]
    ref = plain_fn(x, qt)
    y = cuda_fn(x, qt)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    tol = (1e-5 if dt == torch.float32 else 1e-2) * scale
    kern_fns = [lambda q=q: cuda_fn(x, q) for q in qts]
    ms = graph_ms(kern_fns)
    wrapper = time_ms(kern_fns)
    quant = graph_ms([lambda: quantize_acts_per_token(x)]) if a8 else None
    plain = time_ms([lambda q=q: plain_fn(x, q) for q in qts])
    xb = x.to(torch.bfloat16)
    lib = graph_ms([lambda m=m: torch.matmul(xb, m) for m in libs])
    el = x.element_size()
    if a8:   # int8 codes and a scale per token, at the int8 rate
        bnd, by = bound((t * ci + t * 4) + qt.nbytes_quant() + t * co * el,
                        2.0 * t * ci * co, torch.int8)
    else:
        bnd, by = tc_bound(t * ci * el + qt.nbytes_quant() + t * co * el,
                           t * ci * co)
    case = f"T={t} {ci}x{co} G={qt.group_size}{tag} {str(dt)[6:]}"
    return record(name, case, max_err(y, ref), tol, ms, plain, lib, bnd, by,
                  wrapper, quant)


def _check_gemm(name, cuda_fn, plain_fn, ts, a8):
    """K1 (``a8=False``) or B5 at the paths' GEMM shapes, G=128, f32 and
    bf16 X.  For B5 group 0 holds zeros whose int8 fold needs the clip."""
    rows = {}
    for ci, co in ((4096, 4096), (4096, 11008), (11008, 4096)):
        gen = torch.Generator(device=DEV).manual_seed(ci + co + 5 * a8)
        w = torch.randn(ci, co, generator=gen, device=DEV) * ci ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            qt = quantize(w, group_size=128, dtype=dt)
            if a8:
                zeros = qt.zeros.clone()
                zeros[0, :4] = torch.tensor([140.0, 130.0, -150.0, -114.0])
                qt = dataclasses.replace(qt, zeros=zeros)
            for t in ts:
                x = torch.randn(t, ci, generator=gen, device=DEV).to(dt)
                rows[(t, ci, co, dt)] = _gemm_case(
                    name, cuda_fn, plain_fn, qt, x, a8,
                    " clip-group" if a8 else "")
    return rows


def check_offset_only():
    """K1 and B6 with an offset-only group (group 0's zero point -15000,
    past bf16's exact integers), f32 and bf16 X: K1 at T=4 and 512 on
    4096x11008, B6 at granite's decode and prefill capacities (E=32,
    1024x512, every row live)."""
    print("K1 / B6 with an offset-only group (zero point -15000)")
    from repro_torch.configs import get_config

    c_pre = MLP.moe_capacity(512, get_config("granite-moe-1b-a400m").moe)
    gen = torch.Generator(device=DEV).manual_seed(15000)
    w1 = torch.randn(4096, 11008, generator=gen, device=DEV) * 4096 ** -0.5
    w6 = torch.randn(32, 1024, 512, generator=gen, device=DEV) * 1024 ** -0.5
    for dt in (torch.float32, torch.bfloat16):
        qt = quantize(w1, group_size=128, dtype=dt)
        zeros = qt.zeros.clone()
        zeros[0] = -15000.0
        qt = dataclasses.replace(qt, zeros=zeros)
        for t in (4, 512):
            x = torch.randn(t, 4096, generator=gen, device=DEV).to(dt)
            _gemm_case("w4a16_matmul", W4.w4a16_matmul_cuda,
                       W4.w4a16_matmul_plain, qt, x, False,
                       " offset-only group")
        qt = quantize(w6, group_size=128, dtype=dt)
        zeros = qt.zeros.clone()
        zeros[:, 0] = -15000.0
        qt = dataclasses.replace(qt, zeros=zeros)
        for c in (8, c_pre):
            x = torch.randn(32, c, 1024, generator=gen, device=DEV).to(dt)
            _grouped_case(qt, x, torch.full((32,), c, device=DEV), False,
                          " offset-only group")
    del w1, w6


def check_large_groups():
    """G=256, where a group walks two ring stages: K1 at T=4 and 512 and B5
    at T=64 and 512 (a clip group) on codellama's 4096x11008, B6 at
    granite's decode capacity and B7 at its prefill capacity (E=32,
    1024x512, rows), f32."""
    print("K1 / B5 / B6 / B7 with G=256 (two ring stages a group)")
    from repro_torch.configs import get_config

    gen = torch.Generator(device=DEV).manual_seed(256)
    w = torch.randn(4096, 11008, generator=gen, device=DEV) * 4096 ** -0.5
    qt = quantize(w, group_size=256)
    for t in (4, 512):
        x = torch.randn(t, 4096, generator=gen, device=DEV)
        _gemm_case("w4a16_matmul", W4.w4a16_matmul_cuda,
                   W4.w4a16_matmul_plain, qt, x, False, "")
    zeros = qt.zeros.clone()
    zeros[0, :4] = torch.tensor([140.0, 130.0, -150.0, -114.0])
    qt = dataclasses.replace(qt, zeros=zeros)
    for t in (64, 512):
        x = torch.randn(t, 4096, generator=gen, device=DEV)
        _gemm_case("w4a8_matmul", W4.w4a8_matmul_cuda, W4.w4a8_matmul_plain,
                   qt, x, True, " clip-group")
    del w, qt
    moe = get_config("granite-moe-1b-a400m").moe
    w = torch.randn(32, 1024, 512, generator=gen, device=DEV) * 1024 ** -0.5
    qt = quantize(w, group_size=256)
    for c, a8 in ((8, False), (MLP.moe_capacity(512, moe), True)):
        filled = torch.randint(c // 2, c + 1, (32,), generator=gen,
                               device=DEV)
        x = torch.where(torch.arange(c, device=DEV)[None, :, None]
                        < filled[:, None, None],
                        torch.randn(32, c, 1024, generator=gen, device=DEV),
                        0.0)
        _grouped_case(qt, x, filled, a8, ", rows" if a8 else "",
                      rows=filled.to(torch.int32) if a8 else None)
    del w, qt


def check_k1():
    print("K1 w4a16_matmul (replaces repro/kernels/w4a16_matmul.py:_kernel)")
    return _check_gemm("w4a16_matmul", W4.w4a16_matmul_cuda,
                       W4.w4a16_matmul_plain, (4, 64, 512), False)


def check_b5():
    print("B5 w4a8_matmul (replaces repro/kernels/w4a16_matmul.py:"
          "_kernel_a8)")
    return _check_gemm("w4a8_matmul", W4.w4a8_matmul_cuda,
                       W4.w4a8_matmul_plain, (64, 512), True)


def _paged_inputs(b, lengths, kind, rows, ps=16, seed=0):
    """Two pools (K/V, or MLA's ckv/kpe) whose rows have the shapes ``rows``
    for ``lengths`` (one trash page 0 + shuffled live pages) of ``kind`` —
    f32, bf16, or int8 codes with f32 row scales: the plain version's clean
    (pool, pool, scale, scale), the kernel's copy with the trash page
    poisoned (NaN; int8: codes -128 and NaN scales), the table, and the
    generator for the rest of the case."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    pages = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(pages)
    shps = [(n_pages, ps, *r) for r in rows]
    if kind == torch.int8:
        clean = tuple(torch.randint(-127, 128, shp, generator=gen, device=DEV,
                                    dtype=torch.int8) for shp in shps) \
            + tuple(torch.rand(shp[:-1], generator=gen, device=DEV) * 0.03
                    + 1e-3 for shp in shps)
    else:
        clean = tuple(torch.randn(shp, generator=gen, device=DEV).to(kind)
                      for shp in shps) + (None, None)
    bad = tuple(None if t is None else t.clone() for t in clean)
    for t in bad:
        if t is not None:
            t[0] = -128 if t.dtype == torch.int8 else float("nan")
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    table = torch.zeros(b, max(max(pages), 1), dtype=torch.int32)
    k = 0
    for i, n in enumerate(pages):
        table[i, :n] = perm[k:k + n].to(torch.int32)
        k += n
    return clean, bad, table.to(DEV), gen


def _dense(pool, scales, table, rows):
    """Gathered (dequantized) dense [B, Hkv, rows, D] for the library
    yardstick."""
    g = PA._gather(pool, table)[:, :rows]
    if scales is not None:
        g = g.float() * PA._gather(scales, table)[:, :rows, :, None]
    return g.permute(0, 2, 1, 3).contiguous()


def _row_bytes(pools):
    """Bytes of one pool row (and head), K and V or ckv and kpe (int8: with
    their scales)."""
    k, v, ks, _ = pools
    return k.shape[-1] * k.element_size() + v.shape[-1] * v.element_size() \
        + (8 if ks is not None else 0)


def _pool_label(kind):
    return "int8 pools" if kind == torch.int8 else str(kind)[6:]


def _copies(tensors, nbytes):
    """``tensors`` and clones of them that together exceed twice the L2
    cache: a path's layers each read their own pool, so a timed call must
    not find the previous call's pool in L2."""
    n = max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))
    return [tensors] + [tuple(None if t is None else t.clone()
                              for t in tensors) for _ in range(n - 1)]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _attn_times(kern_fn, plain_fn, lib_fn, pools, lib_ops):
    """Graph (device) time of the kernel's wrapper cycling over copies of
    its pools, the eager wrapper's time, the plain version's time and the
    library call's graph time over copies of its dense operands."""
    pcs = _copies(pools, _nbytes(pools))
    kern = [lambda c=c: kern_fn(c) for c in pcs]
    lcs = _copies(lib_ops, _nbytes(lib_ops))
    return (graph_ms(kern), time_ms(kern), time_ms([plain_fn]),
            graph_ms([lambda c=c: lib_fn(*c) for c in lcs]))


# K2 cases: the table's (B=4, 32 heads, lens 1024/700/333/17, grp 1 and 8)
# and the paths' own decode shapes (path 1: codellama-7b, path 2 the same
# with int8 pools, path 3: granite, Hkv=8, grp=2, Dh=64; batch 4, lens as
# at a path's last decode steps, page size 16)
K2_CASES = [(f"grp={grp}", 4, 32, grp, 128, [1024, 700, 333, 17], kind)
            for grp in (1, 8)
            for kind in (torch.float32, torch.bfloat16, torch.int8)] + [
    ("path 1", 4, 32, 1, 128, [216, 150, 90, 33], torch.float32),
    ("path 2", 4, 32, 1, 128, [216, 150, 90, 33], torch.int8),
    ("path 3", 4, 8, 2, 64, [216, 150, 90, 33], torch.float32)]


def check_k2():
    print("K2 gqa_paged_decode (replaces repro/kernels/paged_attention.py:"
          "_gqa_kernel; fp pools and the int8 branch): split-KV; kernel "
          "time = CUDA graph of the wrapper's calls (both kernels), eager "
          "wrapper beside it")
    rows = {}
    for tag, b, hkv, grp, dh, lengths, kind in K2_CASES:
        clean, bad, table, gen = _paged_inputs(
            b, lengths, kind, ((hkv, dh),) * 2, seed=grp + dh)
        quant = kind == torch.int8
        name = "gqa_paged_decode_int8" if quant else "gqa_paged_decode"
        kern = (PA.gqa_paged_attention_int8_cuda if quant
                else PA.gqa_paged_attention_cuda)
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
        q = torch.randn(b, hkv, grp, dh, generator=gen, device=DEV)
        sc = dh ** -0.5
        pargs = (q, clean[0], clean[1], table, lens, *clean[2:])
        ref = PA.gqa_paged_attention_plain(*pargs, sm_scale=sc)
        out = kern(q, bad[0], bad[1], table, lens,
                   *(bad[2:] if quant else ()), sm_scale=sc)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(out).all()),
                f"{name} read the trash page")
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        s = max(lengths)
        kd = _dense(clean[0], clean[2], table, s).repeat_interleave(
            grp, dim=1)
        vd = _dense(clean[1], clean[3], table, s).repeat_interleave(
            grp, dim=1)
        mask = (torch.arange(s, device=DEV)[None, :]
                < lens[:, None].long())[:, None, None, :]
        qd = q.reshape(b, hkv * grp, 1, dh).to(kd.dtype)
        ms, wrapper, plain, lib = _attn_times(
            lambda c: kern(q, c[0], c[1], table, lens,
                           *(c[2:] if quant else ()), sm_scale=sc),
            lambda: PA.gqa_paged_attention_plain(*pargs, sm_scale=sc),
            lambda k, v: torch.nn.functional.scaled_dot_product_attention(
                qd, k, v, attn_mask=mask), bad, (kd, vd))
        live = sum(lengths)
        nbytes = (q.numel() * 4 + live * hkv * _row_bytes(clean)
                  + table.numel() * 4 + b * 4 + out.numel() * 4)
        flops = 2.0 * live * hkv * grp * 2 * dh
        # int8 codes meet f32 queries: f32 arithmetic, f32 rate
        bnd, by = bound(nbytes, flops, torch.float32 if quant else kind)
        case = (f"B={b} Hkv={hkv} grp={grp} Dh={dh} lens={lengths} "
                f"{_pool_label(kind)} ({tag})")
        splits = PA.gqa_decode_splits(b, hkv, grp, table.shape[1],
                                      _build.sm_count(DEV))
        rows[(tag, kind)] = record(name, case, max_err(out, ref), tol, ms,
                                   plain, lib, bnd, by, wrapper,
                                   extra=dict(splits=splits))
    return rows


# K3 cases: the table's (B=4, T=64/256, no prefix / prefixes 256/130/64/0,
# the four instances) and the paths' chunk shapes (path 1: two fresh
# prompts of T=256; path 2: a T=128 chunk after a 128-token int8 prefix;
# path 3: granite, Hkv=8, grp=2, Dh=64)
K3_KINDS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.int8, torch.float32), (torch.int8, torch.bfloat16))
K3_CASES = [("table", 4, t, 32, 1, 128, prefix, [t, t - 7, t // 2, 1], kind,
             sdt)
            for t in (64, 256) for prefix in ([0, 0, 0, 0], [256, 130, 64, 0])
            for kind, sdt in K3_KINDS] + [
    ("path 1", 2, 256, 32, 1, 128, [0, 0], [256, 200], torch.float32,
     torch.float32),
    ("path 2", 1, 128, 32, 1, 128, [128], [128], torch.int8, torch.float32),
    ("path 3", 2, 256, 8, 2, 64, [0, 0], [256, 200], torch.float32,
     torch.float32)] + [
    # a long prefix with peaked scores (q scaled by 4): P V sums past 2048
    # keys, where one accumulator drifted past the tolerance
    ("peaked", 1, 128, 32, 1, 128, [1920], [128], kind, torch.float32)
    for kind in (torch.float32, torch.int8)]


def check_k3():
    print("K3 gqa_paged_prefill (replaces repro/kernels/paged_attention.py:"
          "_gqa_prefill_kernel; fp pools and the int8 branch): tensor-core "
          "tiles; kernel time = CUDA graph of the wrapper's calls, eager "
          "wrapper beside it; bound at the bf16 tensor-core rate (the f32 "
          "CUDA-core rate's beside it as bound_f32_ms)")
    rows = {}
    for tag, b, t, hkv, grp, dh, prefix, chunk, kind, sdt in K3_CASES:
        clean, bad, table, gen = _paged_inputs(
            b, [p + c for p, c in zip(prefix, chunk)], kind,
            ((hkv, dh),) * 2, seed=t + prefix[0] + dh)
        quant = kind == torch.int8
        name = "gqa_paged_prefill_int8" if quant else "gqa_paged_prefill"
        kern = (PA.gqa_paged_prefill_int8_cuda if quant
                else PA.gqa_paged_prefill_cuda)
        pl = torch.tensor(prefix, dtype=torch.int32, device=DEV)
        cl = torch.tensor(chunk, dtype=torch.int32, device=DEV)
        q = torch.randn(b, t, hkv, grp, dh, generator=gen, device=DEV)
        if tag == "peaked":
            q *= 4
        ks = torch.randn(b, t, hkv, dh, generator=gen, device=DEV).to(sdt)
        vs = torch.randn(b, t, hkv, dh, generator=gen, device=DEV).to(sdt)
        sc = dh ** -0.5
        pargs = (q, ks, vs, clean[0], clean[1], table, pl, cl, *clean[2:])
        ref = PA.gqa_paged_prefill_plain(*pargs, sm_scale=sc)
        out = kern(q, ks, vs, bad[0], bad[1], table, pl, cl,
                   *(bad[2:] if quant else ()), sm_scale=sc)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(out).all()),
                f"{name} read the trash page")
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        s = max(prefix)
        kd = _dense(clean[0], clean[2], table, s)
        vd = _dense(clean[1], clean[3], table, s)
        kd = torch.cat([kd, ks.to(kd.dtype).permute(0, 2, 1, 3)],
                       dim=2).repeat_interleave(grp, dim=1).contiguous()
        vd = torch.cat([vd, vs.to(vd.dtype).permute(0, 2, 1, 3)],
                       dim=2).repeat_interleave(grp, dim=1).contiguous()
        kv = torch.arange(s, device=DEV)
        j = torch.arange(t, device=DEV)
        pre = (kv[None, None, :] < pl.long()[:, None, None]).expand(b, t, s)
        suf = (j[None, None, :] <= j[None, :, None]) \
            & (j[None, None, :] < cl.long()[:, None, None])
        mask = torch.cat([pre, suf], dim=-1)[:, None]
        qd = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * grp, t, dh).to(
            kd.dtype).contiguous()
        ms, wrapper, plain, lib = _attn_times(
            lambda c: kern(q, ks, vs, c[0], c[1], table, pl, cl,
                           *(c[2:] if quant else ()), sm_scale=sc),
            lambda: PA.gqa_paged_prefill_plain(*pargs, sm_scale=sc),
            lambda k, v: torch.nn.functional.scaled_dot_product_attention(
                qd, k, v, attn_mask=mask), bad, (kd, vd))
        keys = sum(p * t + sum(min(i + 1, c) for i in range(t))
                   for p, c in zip(prefix, chunk))
        nbytes = (q.numel() * 4 + (ks.numel() + vs.numel())
                  * ks.element_size()
                  + sum(prefix) * hkv * _row_bytes(clean)
                  + table.numel() * 4 + 2 * b * 4 + out.numel() * 4)
        macs = float(keys) * hkv * grp * 2 * dh
        bnd, by = tc_bound(nbytes, macs)
        bnd_f32, _ = bound(nbytes, 2.0 * macs, torch.float32)
        case = (f"B={b} T={t} Hkv={hkv} grp={grp} Dh={dh} prefix={prefix} "
                f"chunk={chunk} {_pool_label(kind)}, {str(sdt)[6:]} suffix "
                f"({tag})")
        key = (t, sum(prefix) > 0, kind, sdt) if tag == "table" \
            else (tag, kind)
        rows[key] = record(name, case, max_err(out, ref), tol, ms, plain,
                           lib, bnd, by, wrapper,
                           extra=dict(bound_f32_ms=bnd_f32))
    return rows


def _grouped_case(q_, x, filled, a8, tag, rows=None):
    """One B6 (``a8=False``) or B7 case: the kernel on ``x`` [E, C, Ci]
    whose rows ``filled[e]:`` are zero (their outputs must be exactly zero)
    against its plain version, then timed over copies of the weights that
    together exceed L2, beside the plain version and bf16 ``torch.bmm`` on
    the dequantized weights (the library), as :func:`_gemm_case` times K1
    and B5.  ``rows`` is handed to both: the kernel reads only the live
    experts' weights and rows."""
    e, c, ci = x.shape
    co, dt = q_.shape[-1], x.dtype
    kern = W4G.w4a8_grouped_cuda if a8 else W4G.w4a16_grouped_cuda
    plain = W4G.w4a8_grouped_plain if a8 else W4G.w4a16_grouped_plain
    extra = () if rows is None else (rows,)
    ref = plain(x, q_, *extra)
    y = kern(x, q_, *extra)
    torch.cuda.synchronize()
    require(all(not y[i, n:].any() for i, n in enumerate(filled.tolist())),
            f"{kern.__name__}: zero capacity rows not zero")
    tol = (1e-5 if dt == torch.float32 else 1e-2) \
        * max(1.0, float(ref.float().abs().max()))
    n_copy = max(1, math.ceil(2 * L2_BYTES / q_.nbytes_quant()))
    qts = [q_] + [q_.map(torch.clone) for _ in range(n_copy - 1)]
    w_lib = dequantize(q_, torch.bfloat16)
    libs = [w_lib] + [w_lib.clone() for _ in range(n_copy - 1)]
    kern_fns = [lambda q=q: kern(x, q, *extra) for q in qts]
    ms = graph_ms(kern_fns)
    wrapper = time_ms(kern_fns)
    quant = graph_ms([lambda: quantize_acts_per_token(x)]) if a8 else None
    plain_ms = time_ms([lambda q=q: plain(x, q, *extra) for q in qts])
    xb = x.to(torch.bfloat16)
    lib = graph_ms([lambda m=m: torch.bmm(xb, m) for m in libs])
    el = x.element_size()
    live = int(filled.sum())
    name = "w4a8_grouped" if a8 else "w4a16_grouped"
    # with rows, only the live experts' weights and rows are read
    n_exp = e if rows is None else int((rows > 0).sum())
    x_rows = e * c if rows is None else live
    w_bytes = q_.nbytes_quant() * n_exp // e + 4 * len(extra) * e
    if a8:   # int8 codes and a scale per row, at the int8 rate
        bnd, by = bound(x_rows * (ci + 4) + w_bytes + e * c * co * el,
                        2.0 * live * ci * co, torch.int8)
    else:
        bnd, by = tc_bound(x_rows * ci * el + w_bytes + e * c * co * el,
                           live * ci * co)
    case = (f"E={e} C={c} ({live} live rows) {ci}x{co} G={q_.group_size}"
            f"{' clip-group' if a8 else ''} {str(dt)[6:]}{tag}")
    return record(name, case, max_err(y, ref), tol, ms, plain_ms, lib, bnd,
                  by, wrapper, quant)


def check_grouped():
    """B6 and B7 at granite's expert shapes (E=32, d_model 1024, d_expert
    512: gate/up 1024x512, down 512x1024, G=128), f32 and bf16, at decode's
    capacity (C=8, B6 only: A8 needs 16 rows) and a 512-row prefill chunk's
    capacity, with ragged zero capacity rows (exactly zero outputs); B7 with
    a group whose zero fold needs the clip.  Then B6 at path 4's shapes,
    f32, every row live: deepseek-v2-236b's routed experts at decode's
    capacity (E=160, C=6 of 4 tokens, 5120x1536 and 1536x5120) and the
    absorbed MLA pair with the heads as experts (E=128: wk_t 128x512, one
    quantization group along nope; wv 512x128) at decode (4 rows) and on a
    128-token chunk."""
    print("B6/B7 w4a16_grouped / w4a8_grouped (replace repro/kernels/"
          "w4a16_grouped.py:_kernel / _kernel_a8)")
    from repro_torch.configs import get_config

    moe = get_config("granite-moe-1b-a400m").moe
    c_pre = MLP.moe_capacity(512, moe)
    e = moe.num_experts
    rows = {}
    for ci, co in ((1024, 512), (512, 1024)):
        gen = torch.Generator(device=DEV).manual_seed(ci + 7)
        w = torch.randn(e, ci, co, generator=gen, device=DEV) * ci ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            qt = quantize(w, group_size=128, dtype=dt)
            zeros = qt.zeros.clone()
            zeros[1, 0, :4] = torch.tensor([140.0, 130.0, -150.0, -114.0])
            qt8 = dataclasses.replace(qt, zeros=zeros)
            for c, a8 in ((8, False), (c_pre, False), (c_pre, True)):
                x = torch.randn(e, c, ci, generator=gen, device=DEV)
                filled = torch.randint(c // 2, c + 1, (e,), generator=gen,
                                       device=DEV)
                filled[0] = 0
                x = torch.where(torch.arange(c, device=DEV)[None, :, None]
                                < filled[:, None, None], x, 0.0).to(dt)
                # B7 takes the filled counts as rows, as on path 3
                live = filled.to(torch.int32) if a8 else None
                rows[(a8, c, ci, dt)] = _grouped_case(
                    qt8 if a8 else qt, x, filled, a8,
                    ", rows" if a8 else "", rows=live)
    print("B6 w4a16_grouped at deepseek-v2-236b's shapes (path 4)")
    moe = get_config("deepseek-v2-236b").moe
    for e, c, ci, co in ((160, 6, 5120, 1536), (160, 6, 1536, 5120),
                         (128, 4, 128, 512), (128, 4, 512, 128),
                         (128, 128, 128, 512), (128, 128, 512, 128)):
        gen = torch.Generator(device=DEV).manual_seed(e + c + ci)
        w = torch.randn(e, ci, co, generator=gen, device=DEV) * ci ** -0.5
        qt = quantize(w, group_size=128, dtype=torch.float32)
        del w
        x = torch.randn(e, c, ci, generator=gen, device=DEV)
        filled = torch.full((e,), c, device=DEV)
        _grouped_case(qt, x, filled, False, " (deepseek)")
        if e == moe.num_experts:
            # decode with real routing: 4 tokens x top-6 from a seeded
            # router, the capacity rows past each expert's count zero, the
            # idle experts' scales NaN (never read)
            probs = torch.softmax(torch.randn(4, e, generator=gen,
                                              device=DEV), dim=-1)
            top = torch.topk(probs, moe.top_k, dim=-1).indices
            counts = torch.zeros(e, dtype=torch.long, device=DEV).index_add_(
                0, top.reshape(-1), torch.ones_like(top.reshape(-1)))
            rows_e = torch.clamp(counts, max=c).to(torch.int32)
            xr = torch.where(torch.arange(c, device=DEV)[None, :, None]
                             < rows_e[:, None, None], x, 0.0)
            scales = qt.scales.clone()
            scales[rows_e == 0] = float("nan")
            _grouped_case(dataclasses.replace(qt, scales=scales), xr,
                          rows_e, False,
                          f" routed, {int((rows_e > 0).sum())} live experts"
                          " (deepseek)", rows=rows_e)
        del qt, x
    return rows


# B4 cases (B, T, H, Hkv, D, causal, type): path 3's own calibration shape
# (granite, T=24), granite at T=64 and 2048 (f32 and bf16), codellama's
# heads (H=Hkv=32, D=128) at T=2048, and one non-causal case with S a
# multiple of the reference's 512-key block
B4_CASES = ((1, 24, 16, 8, 64, True, torch.float32),
            (1, 64, 16, 8, 64, True, torch.float32),
            (1, 2048, 16, 8, 64, True, torch.float32),
            (1, 2048, 16, 8, 64, True, torch.bfloat16),
            (1, 2048, 32, 32, 128, True, torch.float32),
            (1, 1024, 16, 8, 64, False, torch.float32))


def check_flash():
    """B4 at the cases of ``B4_CASES`` against its plain version (error and
    its share of the tolerance printed), then timed: kernel and library
    (``scaled_dot_product_attention`` with ``enable_gqa``, in the case's
    type) as CUDA graphs over copies of q, k, v that exceed L2, the eager
    wrapper beside them; the bound counts the function's multiply-adds at
    the bf16 tensor-core rate (the f32 CUDA-core rate's beside it as
    bound_f32_ms), as K3's."""
    print("B4 flash_attention (replaces repro/kernels/flash_attention.py:"
          "_kernel): K3's tensor-core tile (csrc/attn_tile.cuh); kernel time "
          "= CUDA graph of the wrapper's calls, eager wrapper beside it")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for b, t, h, hkv, d, causal, dt in B4_CASES:
        gen = torch.Generator(device=DEV).manual_seed(t + h + d)
        q = torch.randn(b, t, h, d, generator=gen, device=DEV).to(dt)
        k = torch.randn(b, t, hkv, d, generator=gen, device=DEV).to(dt)
        v = torch.randn(b, t, hkv, d, generator=gen, device=DEV).to(dt)
        ref = FA.flash_attention_plain(q, k, v, causal=causal)
        out = FA.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = (1e-5 if dt == torch.float32 else 1e-2) \
            * max(1.0, float(ref.float().abs().max()))
        err = max_err(out, ref)
        route = FA.flash_route(dt, d)
        require(route == "tile", f"B4 D={d} left the tile")
        qd, kd, vd = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        ms, wrapper, plain_ms, lib = _attn_times(
            lambda c: FA.flash_attention_cuda(*c, causal=causal),
            lambda: FA.flash_attention_plain(q, k, v, causal=causal),
            lambda qa, ka, va: sdpa(qa, ka, va, is_causal=causal,
                                    enable_gqa=True),
            (q, k, v), (qd, kd, vd))
        pairs = t * (t + 1) // 2 if causal else t * t
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        macs = 2.0 * b * pairs * h * d
        bnd, by = tc_bound(nbytes, macs)
        bnd_f32, _ = bound(nbytes, 2.0 * macs, torch.float32)
        case = (f"B={b} T={t} H={h} Hkv={hkv} D={d} "
                f"{'causal' if causal else 'non-causal'} {str(dt)[6:]}")
        rows[(t, h, d, causal, dt)] = record(
            "flash_attention", case, err, tol, ms, plain_ms, lib, bnd, by,
            wrapper, extra=dict(bound_f32_ms=bnd_f32, route=route,
                                err_share=err / tol))
    return rows


def _mla_dense(clean, table, rows):
    """Gathered (dequantized) [B, 1, rows, r + dr] keys and [B, 1, rows, r]
    values of the latent pools, for the library yardstick."""
    ckv = PA._gather(clean[0], table)[:, :rows].float()
    kpe = PA._gather(clean[1], table)[:, :rows].float()
    if clean[2] is not None:
        ckv = ckv * PA._gather(clean[2], table)[:, :rows, None]
        kpe = kpe * PA._gather(clean[3], table)[:, :rows, None]
    return (torch.cat([ckv, kpe], dim=-1)[:, None].contiguous(),
            ckv[:, None].contiguous())


def check_mla():
    """B8 and B9 at path 4's full width (H=128 heads, r=512, dr=64, PS=16)
    in f32, bf16 and int8 latent pools, the trash page poisoned: B8 at
    decode lengths like path 4's, B9 on one 128-token chunk after a 128-token
    prefix (the chunk budget of path 4) and on a ragged batch of 32-token
    chunks.  Library: ``scaled_dot_product_attention`` over the gathered
    dense rows, key ``[ckv || kpe]`` (576), value ``ckv`` (512), 128 query
    heads on one KV head, in the case's fp type (int8 dequantized to f32).
    Kernel and library times are CUDA graphs over copies of their operands
    that exceed L2, the eager wrapper beside them; the bound counts the
    function's multiply-adds at the bf16 tensor-core rate (the f32
    CUDA-core rate's beside it as bound_f32_ms), as K3's."""
    print("B8/B9 mla_paged_decode / mla_paged_prefill (replace repro/kernels/"
          "paged_attention.py:_mla_kernel / _mla_prefill_kernel; fp pools and "
          "the int8 branch): the tensor-core tile of csrc/mla_tile.cuh, B8 "
          "split-KV; kernel time = CUDA graph of the wrapper's calls, eager "
          "wrapper beside it")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, r, dr = 128, 512, 64
    sc = (128 + 64) ** -0.5
    rows = {}
    lengths = [216, 150, 90, 33]
    b = len(lengths)
    for kind in (torch.float32, torch.bfloat16, torch.int8):
        clean, bad, table, gen = _paged_inputs(b, lengths, kind,
                                               ((r,), (dr,)), seed=11)
        quant = kind == torch.int8
        name = "mla_paged_decode_int8" if quant else "mla_paged_decode"
        kern = (PA.mla_paged_attention_int8_cuda if quant
                else PA.mla_paged_attention_cuda)
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
        q_lat = torch.randn(b, h, r, generator=gen, device=DEV)
        q_pe = torch.randn(b, h, dr, generator=gen, device=DEV)
        kargs = (q_lat, q_pe, bad[0], bad[1], table, lens) + (
            bad[2:] if quant else ())
        pargs = (q_lat, q_pe, clean[0], clean[1], table, lens, *clean[2:])
        ref = PA.mla_paged_attention_plain(*pargs, sm_scale=sc)
        out = kern(*kargs, sm_scale=sc)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(out).all()), f"{name} read the trash page")
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        s = max(lengths)
        kd, vd = _mla_dense(clean, table, s)
        ldt = torch.float32 if quant else kind
        kd, vd = kd.to(ldt), vd.to(ldt)
        qd = torch.cat([q_lat, q_pe], dim=-1)[:, :, None].to(ldt)
        mask = (torch.arange(s, device=DEV)[None, :]
                < lens[:, None].long())[:, None, None, :]
        ms, wrapper, plain, lib = _attn_times(
            lambda c: kern(q_lat, q_pe, c[0], c[1], table, lens,
                           *(c[2:] if quant else ()), sm_scale=sc),
            lambda: PA.mla_paged_attention_plain(*pargs, sm_scale=sc),
            lambda k, v: sdpa(qd, k, v, attn_mask=mask, scale=sc,
                              enable_gqa=True), bad, (kd, vd))
        live = sum(lengths)
        nbytes = ((q_lat.numel() + q_pe.numel()) * 4
                  + live * _row_bytes(clean) + table.numel() * 4 + b * 4
                  + out.numel() * 4)
        macs = float(live) * h * (2 * r + dr)
        bnd, by = tc_bound(nbytes, macs)
        bnd_f32, _ = bound(nbytes, 2.0 * macs, torch.float32)
        route = PA.mla_decode_route(kind, r, dr)
        splits = PA.mla_decode_splits(b, h, table.shape[1], 16,
                                      _build.sm_count(DEV))
        print(f"  {name}: path 4's shape takes the {route} route, "
              f"(splits, pages per split) = {splits}")
        require(route == "tile", f"{name}: path 4's shape left the tile")
        case = f"B=4 H=128 r=512 dr=64 lens={lengths} {_pool_label(kind)}"
        rows[("decode", kind)] = record(
            name, case, max_err(out, ref), tol, ms, plain, lib, bnd, by,
            wrapper, extra=dict(bound_f32_ms=bnd_f32, route=route,
                                splits=splits))
    kinds = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.int8, torch.float32))
    for t, prefix, chunk in ((128, [128], [128]),
                             (32, [96, 50, 0, 0], [32, 29, 16, 1])):
        b = len(prefix)
        for kind, sdt in kinds:
            clean, bad, table, gen = _paged_inputs(
                b, [p + c for p, c in zip(prefix, chunk)], kind,
                ((r,), (dr,)), seed=t + b)
            quant = kind == torch.int8
            name = "mla_paged_prefill_int8" if quant else "mla_paged_prefill"
            kern = (PA.mla_paged_prefill_int8_cuda if quant
                    else PA.mla_paged_prefill_cuda)
            pl = torch.tensor(prefix, dtype=torch.int32, device=DEV)
            cl = torch.tensor(chunk, dtype=torch.int32, device=DEV)
            q_lat = torch.randn(b, t, h, r, generator=gen, device=DEV)
            q_pe = torch.randn(b, t, h, dr, generator=gen, device=DEV)
            c_suf = torch.randn(b, t, r, generator=gen, device=DEV).to(sdt)
            k_suf = torch.randn(b, t, dr, generator=gen, device=DEV).to(sdt)
            kargs = (q_lat, q_pe, c_suf, k_suf, bad[0], bad[1], table, pl,
                     cl) + (bad[2:] if quant else ())
            pargs = (q_lat, q_pe, c_suf, k_suf, clean[0], clean[1], table, pl,
                     cl, *clean[2:])
            ref = PA.mla_paged_prefill_plain(*pargs, sm_scale=sc)
            out = kern(*kargs, sm_scale=sc)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(out).all()),
                    f"{name} read the trash page")
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            s = max(prefix)
            ldt = torch.float32 if quant else kind
            kd, vd = _mla_dense(clean, table, s)
            kd = torch.cat([kd, torch.cat([c_suf, k_suf], dim=-1).float()[
                :, None]], dim=2).to(ldt)
            vd = torch.cat([vd, c_suf.float()[:, None]], dim=2).to(ldt)
            qd = torch.cat([q_lat, q_pe], dim=-1).permute(0, 2, 1, 3).to(ldt)
            kv = torch.arange(s, device=DEV)
            j = torch.arange(t, device=DEV)
            pre = (kv[None, None, :] < pl.long()[:, None, None]).expand(
                b, t, s)
            suf = (j[None, None, :] <= j[None, :, None]) \
                & (j[None, None, :] < cl.long()[:, None, None])
            mask = torch.cat([pre, suf], dim=-1)[:, None]
            ms, wrapper, plain, lib = _attn_times(
                lambda c: kern(q_lat, q_pe, c_suf, k_suf, c[0], c[1], table,
                               pl, cl, *(c[2:] if quant else ()),
                               sm_scale=sc),
                lambda: PA.mla_paged_prefill_plain(*pargs, sm_scale=sc),
                lambda k, v: sdpa(qd, k, v, attn_mask=mask, scale=sc,
                                  enable_gqa=True), bad, (kd, vd))
            keys = sum(p * t + sum(min(i + 1, c) for i in range(t))
                       for p, c in zip(prefix, chunk))
            nbytes = ((q_lat.numel() + q_pe.numel()) * 4
                      + (c_suf.numel() + k_suf.numel()) * c_suf.element_size()
                      + sum(prefix) * _row_bytes(clean)
                      + table.numel() * 4 + 2 * b * 4 + out.numel() * 4)
            macs = float(keys) * h * (2 * r + dr)
            bnd, by = tc_bound(nbytes, macs)
            bnd_f32, _ = bound(nbytes, 2.0 * macs, torch.float32)
            route = PA.mla_prefill_route(sdt, kind, r, dr)
            if t == 128:
                print(f"  {name} ({str(sdt)[6:]} suffix): path 4's shape "
                      f"takes the {route} route")
            require(route == "tile", f"{name}: path 4's shape left the tile")
            case = (f"B={b} T={t} H=128 r=512 prefix={prefix} chunk={chunk} "
                    f"{_pool_label(kind)}, {str(sdt)[6:]} suffix")
            rows[("prefill", t, kind)] = record(
                name, case, max_err(out, ref), tol, ms, plain, lib, bnd, by,
                wrapper, extra=dict(bound_f32_ms=bnd_f32, route=route))
    return rows


# ------------------------------------------- kernels at the paths' shapes ---
PLAIN = {
    "w4a16_matmul": W4.w4a16_matmul_plain,
    "gqa_paged_decode": PA.gqa_paged_attention_plain,
    "gqa_paged_prefill": PA.gqa_paged_prefill_plain,
    "w4a8_matmul": W4.w4a8_matmul_plain,
    "gqa_paged_decode_int8": PA.gqa_paged_attention_plain,
    "gqa_paged_prefill_int8": PA.gqa_paged_prefill_plain,
    "w4a16_grouped": W4G.w4a16_grouped_plain,
    "w4a8_grouped": W4G.w4a8_grouped_plain,
    "flash_attention": FA.flash_attention_plain,
    "mla_paged_decode": PA.mla_paged_attention_plain,
    "mla_paged_decode_int8": PA.mla_paged_attention_plain,
    "mla_paged_prefill": PA.mla_paged_prefill_plain,
    "mla_paged_prefill_int8": PA.mla_paged_prefill_plain,
}

MLA_KERNELS = ("mla_paged_decode", "mla_paged_decode_int8",
               "mla_paged_prefill", "mla_paged_prefill_int8")


def _sig(a):
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.dtype
    if isinstance(a, QuantizedTensor):
        return "int4", tuple(a.packed.shape), tuple(a.scales.shape), a.a8
    return a


class _Capture:
    """Stands in for a wrapper at its module attribute while a path runs.
    A wrapper bumps its counter through its module-level name, so
    ``launches`` reads and writes the wrapper's own."""

    def __init__(self, fn, seen, keep):
        self.fn, self.seen, self.keep = fn, seen, keep
        self.__name__ = fn.__name__

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kw):
        key = (tuple(map(_sig, args)),
               tuple(sorted((k, _sig(v)) for k, v in kw.items())))
        if self.keep[0] and key not in self.seen:
            self.seen[key] = (tuple(a.clone() if isinstance(a, torch.Tensor)
                                    else a for a in args), kw)
        return self.fn(*args, **kw)


def _eager_step(graph):
    """The decode graph's step once more, eagerly, on the inputs of the
    replay just issued (still in the graph's static tensors): it writes the
    pools the rows the replay wrote, bit for bit (:func:`graph_vs_eager`),
    and its launches are taken back from the counters."""
    before = K.launch_counts()
    with torch.no_grad():
        graph.step(graph.token, graph.position, graph.table)
    after = K.launch_counts()
    K.add_launch_counts({n: before[n] - after[n] for n in after})


@contextlib.contextmanager
def path_operands():
    """While a path runs, keep the operands of each kernel's first launch at
    each distinct operand shape: tensors cloned before the launch (pools and
    activation buffers change afterwards), int4 weights as they are (fixed
    once quantized).  The wrappers are replaced at their module attribute,
    which ``kernels.ops`` reads at every call; the launch counts stay the
    wrappers' own.  A decode graph's warm-up and capture run on trash-page
    rows (position 0, token 0) and its replays run no Python, so their
    launches are passed over; after the graph's first replay its step runs
    once more eagerly (:func:`_eager_step`), and the decode kernels keep
    the operands of the path's first decode step."""
    seen = {name: {} for name in K.WRAPPERS}
    keep = [True]
    orig = []
    for name, fn in K.WRAPPERS.items():
        mod = sys.modules[fn.__module__]
        setattr(mod, fn.__name__, _Capture(fn, seen[name], keep))
        orig.append((mod, fn))
    replay = DecodeGraph.__call__

    def first_replay(graph, *inputs):
        if graph.graph is not None:
            return replay(graph, *inputs)
        keep[0] = False
        try:
            logits = replay(graph, *inputs)
        finally:
            keep[0] = True
        _eager_step(graph)
        return logits

    DecodeGraph.__call__ = first_replay
    try:
        yield seen
    finally:
        DecodeGraph.__call__ = replay
        for mod, fn in orig:
            setattr(mod, fn.__name__, fn)


def check_path_operands(seen, label):
    """Every kernel the path launched, on the operands it was given at each
    distinct shape (the path's own activations, weights, pools and tables),
    against its plain version on the same operands: f32 within 1e-5 of
    max(1, max |plain|), bf16 within 1e-2 of it."""
    rows = []
    for name, cases in seen.items():
        worst, shapes = 0.0, []
        for args, kw in cases.values():
            ref = PLAIN[name](*args, **kw)
            y = K.WRAPPERS[name](*args, **kw)
            torch.cuda.synchronize()
            tol = (1e-2 if args[0].dtype == torch.bfloat16 else 1e-5) \
                * max(1.0, float(ref.float().abs().max()))
            err = max_err(y, ref)
            shape = "x".join(map(str, args[0].shape))
            if isinstance(args[1], QuantizedTensor):
                shape += " @ " + "x".join(map(str, args[1].shape))
            rows.append(dict(kernel=name, shape=shape, max_abs_err=err,
                             tol=tol))
            require(err <= tol, f"{label}: {name} at the path's operands "
                    f"{shape}: max |kernel - plain| = {err} > {tol}")
            worst = max(worst, err / tol)
            shapes.append(shape)
        if shapes:
            print(f"  {name} at the path's operands, {len(shapes)} shapes "
                  f"(worst err/tol {worst:.3g}): {'; '.join(shapes)}")
    return rows


# ------------------------------------------------------------- main path ---
def dequantized_params(params):
    """Every int4 weight dequantized to f32.  An MLA layer's absorbed pair is
    grouped along other axes than ``wkv_b``, so ``wkv_b`` is rebuilt from the
    dequantized pair (``w_k[r, H, nope]`` = ``wk_t`` moved back, ``w_v[r, H,
    v]`` = ``wv`` swapped back, concatenated per head) and the pair dropped:
    the fp branch of ``_mla_absorb_weights`` then contracts the values the
    kernels saw."""
    def conv(node):
        if isinstance(node, dict) and "wkv_b_absorbed" in node:
            ab = node["wkv_b_absorbed"]
            w_k = dequantize(ab["wk_t"], torch.float32).permute(2, 0, 1)
            w_v = dequantize(ab["wv"], torch.float32).transpose(0, 1)
            rest = {k: v for k, v in node.items() if k != "wkv_b_absorbed"}
            rest["wkv_b"] = {"w": torch.cat([w_k, w_v], dim=-1).reshape(
                w_k.shape[0], -1).contiguous()}
            return conv(rest)
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if isinstance(node, QuantizedTensor):
            return dequantize(node, torch.float32)
        return node
    return conv(params)


def _fresh_pool(cfg, ps, n_tokens):
    pages = -(-(n_tokens + 1) // ps)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=DEV)[None]
    return LM.init_paged_cache(cfg, pages + 1, ps, DEV), table


@torch.no_grad()
def _prefill_step(params, cfg, ps, prompt):
    """One prefill chunk of the whole prompt into fresh pages."""
    pool, table = _fresh_pool(cfg, ps, len(prompt))
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=DEV)[None]
    start = torch.zeros(1, dtype=torch.int32, device=DEV)
    clen = torch.tensor([len(prompt)], dtype=torch.int32, device=DEV)
    logits, pool = LM.lm_prefill_chunk(params, toks, pool, start, clen,
                                       table, cfg)
    return logits, pool, table


@torch.no_grad()
def _decode_step(params, cfg, pool, table, prompt):
    """One decode step after the prompt (the pool is updated in place)."""
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=DEV)
    nxt = torch.tensor([[int(prompt[-1])]], dtype=torch.int32, device=DEV)
    return LM.lm_decode_paged(params, nxt, pool, pos, table, cfg)[0]


def check_step_against_plain(params, cfg, ps, prompt):
    """One prefill chunk and one decode step through the kernels, against the
    same steps on the dequantized weights with the dense-gather oracle (each
    over its own pools of ``cfg``'s kind: fp, or int8 under kv_quant).

    With int8 pools the two prefills write their rows independently, so a
    latent element near a rounding boundary can take neighbouring codes in
    the two pools.  The codes that differ are counted, and the oracle's
    decode step is run once more on a copy of the kernel side's own pool:
    with the rows shared, the decode gap must fall to what the fp pools
    show."""
    plain_params = dequantized_params(params)
    plain_cfg = cfg.with_(paged_attn_impl="gather", attn_impl="chunked")
    logits, pools = {}, {}
    for name, prm, c in (("kernel", params, cfg), ("plain", plain_params,
                                                   plain_cfg)):
        pre, pool, table = _prefill_step(prm, c, ps, prompt)
        pools[name] = [{k: v.clone() for k, v in lp.items()}
                       for lp in pool["layers"]]
        logits[name] = (pre, _decode_step(prm, c, pool, table, prompt))
    errs = {}
    for i, step in enumerate(("prefill", "decode")):
        a, b = logits["kernel"][i], logits["plain"][i]
        require(bool(torch.isfinite(a).all()), f"{step} logits not finite")
        err = max_err(a, b)
        tol = 2e-3 * max(1.0, float(b.abs().max()))
        print(f"  {step} step logits vs plain: max |diff| = {err:.3g} "
              f"(tol {tol:.3g}), argmax {int(a.argmax())} vs "
              f"{int(b.argmax())}")
        require(err <= tol, f"{step} logits differ from the plain path")
        errs[f"{step}_logit_err"] = err
    if cfg.kv_quant:
        n = len(prompt)
        diff = tot = 0
        for lk, lp in zip(pools["kernel"], pools["plain"]):
            for k in (k for k, v in lk.items() if v.dtype == torch.int8):
                a = lk[k].flatten(0, 1)[ps:ps + n]      # page 1 onwards
                b = lp[k].flatten(0, 1)[ps:ps + n]
                diff += int((a != b).sum())
                tot += a.numel()
                require(int((a.int() - b.int()).abs().max()) <= 1,
                        f"int8 {k} codes differ by more than one step")
        shared = _decode_step(plain_params, plain_cfg,
                              {"layers": pools["kernel"]}, table, prompt)
        err = max_err(logits["kernel"][1], shared)
        tol = 2e-3 * max(1.0, float(shared.abs().max()))
        print(f"  int8 codes differing between the two pools: {diff} of "
              f"{tot}; decode step vs the oracle on the kernel side's own "
              f"pool: max |diff| = {err:.3g} (tol {tol:.3g})")
        require(err <= tol, "decode logits differ from the plain path on "
                "the shared pool")
        errs.update(decode_logit_err_shared_pool=err,
                    int8_codes_differing=diff, int8_codes=tot)
    del plain_params, pools
    return errs


def check_decode_graph(eng, label):
    """After a counted run: the engine's decode steps replayed one CUDA
    graph, once a step."""
    g = eng.decode_graph
    require(g is not None and g.graph is not None,
            f"{label}: the decode step did not run as a CUDA graph")
    require(g.replays == eng.stats.steps,
            f"{label}: {g.replays} graph replays for {eng.stats.steps} "
            "decode steps")
    per = {k: v for k, v in g.per_replay.items() if v}
    print(f"  {label}: {eng.stats.steps} decode steps replayed one CUDA "
          f"graph; launches per replay {per}")
    return dict(graph_replays=g.replays, graph_launches_per_replay=per)


def graph_vs_eager(eng, label):
    """At one decode step: the graph's logits against an eager
    ``api.decode_paged_fn`` of the same inputs on a copy of the pools taken
    before the replay, bit for bit, and the pools the replay wrote against
    the copy's."""
    from repro_torch.models import api

    dec = [i for i in eng._active_slots()
           if eng.pos[i] >= eng.pref_target[i]]
    require(dec, f"{label}: no decoding slot for the graph check")
    tok, pos, tbl = eng._decode_inputs(dec)
    pools = {"layers": [{k: t.clone() for k, t in lp.items()}
                        for lp in eng.pools["layers"]]}
    with torch.no_grad():
        eager = api.decode_paged_fn(
            eng.params, {"token": eng._tensor(tok),
                         "position": eng._tensor(pos)},
            pools, eng._tensor(tbl), eng.cfg)[0]
    graph = eng.decode_graph(tok, pos, tbl)
    torch.cuda.synchronize()
    same = torch.equal(graph, eager)
    pools_same = all(torch.equal(lp[k], lc[k]) for lp, lc in
                     zip(eng.pools["layers"], pools["layers"]) for k in lp)
    print(f"  {label}: graph replay vs an eager step on a copy of the pools "
          f"({len(dec)} decoding rows): logits bitwise equal {same} (max "
          f"|diff| {max_err(graph, eager):.3g}), pools bitwise equal "
          f"{pools_same}")
    require(same and pools_same, f"{label}: the decode graph differs from "
            "the eager step")
    del pools
    return dict(graph_logits_bitwise_equal=same,
                graph_pools_bitwise_equal=pools_same)


def profile_decode(eng, reqs, key, steps=8):
    """Where a decode step's time goes, after the counted run: the path's
    first four prompts again; engine steps run until all four have finished
    prefill, the decode graph is held against an eager step
    (:func:`graph_vs_eager`), then ``steps`` pure decode steps (batch 4,
    graph replays) run on the host clock alone, and ``steps`` more under
    torch.profiler (device time, and the host's busiest ops)."""
    from repro_torch.serving.engine import Request

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for r in reqs[:4]:
        eng.submit(Request(uid=100 + r.uid, prompt=r.prompt,
                           max_tokens=2 * steps + 8))
    eng.step()
    while any(r is not None and eng.pos[i] < eng.pref_target[i]
              for i, r in enumerate(eng.slots)):
        eng.step()
    require(not eng.queue and all(r is not None for r in eng.slots),
            "profile window did not start decoding all four slots")
    checked = graph_vs_eager(eng, key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_until_drained()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    rows = [dict(name=e.key[:90], calls=e.count,
                 device_s=e.self_device_time_total / 1e6) for e in top]
    host = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    host_rows = [dict(name=e.key[:60], calls=e.count,
                      self_host_s=e.self_cpu_time_total / 1e6) for e in host]
    print(f"  {steps} decode steps: {wall_plain * 1e3 / steps:.2f} ms wall "
          f"per step unprofiled; profile of {steps} more: "
          f"{wall * 1e3 / steps:.2f} ms wall per step, "
          f"{busy * 1e3 / steps:.2f} ms of device kernel time per step (busy "
          f"share {busy / wall:.3f}, {busy / wall_plain:.3f} of the "
          "unprofiled wall)")
    for r in rows:
        print(f"    {r['device_s']:.4f}s {r['calls']:6d}x  {r['name']}")
    print("    host, self time: " + "; ".join(
        f"{r['name']} {r['self_host_s'] * 1e3:.2f}ms/{r['calls']}x"
        for r in host_rows))
    RESULTS[key] = dict(decode_steps=steps, wall_s=wall,
                        wall_unprofiled_s=wall_plain, device_busy_s=busy,
                        top=rows, host_top=host_rows, **checked)


def main_path():
    from repro_torch.launch import serve

    print("main path: codellama-7b full width, SmoothQuant+ W4A16 f32, "
          "8 requests", flush=True)
    torch.cuda.reset_peak_memory_stats()
    with path_operands() as seen:
        K.reset_launch_counts()
        res = serve.main(["--arch", "codellama-7b", "--requests", "8",
                          "--batch-size", "4", "--max-seq", "256",
                          "--max-tokens", "16", "--min-prompt", "32",
                          "--max-prompt", "200", "--seed", "0"])
        torch.cuda.synchronize()
        counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    eng, reqs, cfg = res["engine"], res["requests"], res["cfg"]
    st = eng.stats
    print(f"  launches {counts}; decode steps {st.steps}, prefill batches "
          f"{st.prefill_batches}")
    require(all(r.finish_reason in ("completed", "length") for r in reqs),
            "a request did not finish")
    require(all(len(r.output) == 16 or r.finish_reason == "completed"
                for r in reqs), "a request stopped early without EOS")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            "token out of range")
    require(counts["w4a16_matmul"] == 7 * cfg.num_layers * (
        st.steps + st.prefill_batches),
        "K1 not launched for all 7 linears of every layer, every step")
    require(counts["gqa_paged_decode"] == cfg.num_layers * st.steps,
            "K2 not launched once per layer per decode step")
    require(counts["gqa_paged_prefill"] == cfg.num_layers
            * st.prefill_batches, "K3 not launched once per layer per chunk")
    require(not any(counts[n] for n in ("w4a8_matmul", "w4a16_grouped",
                                        "w4a8_grouped", "flash_attention",
                                        *MLA_KERNELS)),
            "path 1 launched a kernel of another path")
    tok_s = st.decoded_tokens / res["serve_s"]
    ttft = sorted(res["ttft_s"])
    print(f"  PTQ alpha={res['report'].alpha:.2f} in {res['ptq_s']:.1f}s; "
          f"served {st.completed} requests in {res['serve_s']:.2f}s: "
          f"{tok_s:.1f} decode tok/s, TTFT p50 {statistics.median(ttft):.3f}s "
          f"max {ttft[-1]:.3f}s, peak memory {peak / 2 ** 30:.2f} GiB")
    operands = check_path_operands(seen, "path 1")
    del seen
    errs = check_step_against_plain(eng.params, eng.cfg, eng.PS,
                                    reqs[0].prompt)
    RESULTS["main_path"] = dict(
        launches=counts, decode_steps=st.steps,
        prefill_batches=st.prefill_batches, decoded_tokens=st.decoded_tokens,
        prefilled_tokens=st.prefilled_tokens, serve_s=res["serve_s"],
        decode_tok_s=tok_s, ttft_s=ttft, ptq_s=res["ptq_s"],
        boot_s=res["boot_s"], alpha=res["report"].alpha,
        peak_mem_bytes=peak, path_operands=operands, **errs,
        **check_decode_graph(eng, "path 1"))
    outputs = [list(r.output) for r in reqs]
    profile_decode(eng, reqs, "profile")
    path1b(eng.params, cfg, reqs, outputs)
    return counts


def path1b(params, cfg, reqs, outputs):
    """Path 1's quantized params (no second PTQ) served again with the same
    8 requests from a pool that forces preemption: page size 4 and 72 pages
    (path 1 holds 65 of 16 tokens).  With 16-token pages a slot grows at
    most once in 16 new tokens and the admission watermark keeps a page for
    it, so nothing would preempt; with 4-token pages growth outruns the
    watermark.  Preempted slots swap out through pinned host buffers and
    resume by swap-in into the pools the decode graph holds.  The outputs
    equal path 1's token for token, every preemption resumes, the bytes
    swapped out come back in, and the launch counts hold path 1's
    prediction."""
    from repro_torch.serving.engine import Request, ServingEngine

    print("path 1b: path 1's params, the same 8 requests, page size 4, 72 "
          "pages: preemption and swap", flush=True)
    reqs = [Request(uid=r.uid, prompt=r.prompt, max_tokens=r.max_tokens)
            for r in reqs]
    eng = ServingEngine(params, cfg, batch_size=4, max_seq=256, page_size=4,
                        num_pages=72, seed=0, device=DEV)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = K.launch_counts()
    st = eng.stats
    nl = cfg.num_layers
    pred = {n: 0 for n in K.WRAPPERS}
    pred.update({"w4a16_matmul": 7 * nl * (st.steps + st.prefill_batches),
                 "gqa_paged_decode": nl * st.steps,
                 "gqa_paged_prefill": nl * st.prefill_batches})
    same = sum(r.output == o for r, o in zip(reqs, outputs))
    print(f"  launches {counts}; predicted {pred}; decode steps {st.steps}, "
          f"prefill batches {st.prefill_batches}; {st.preemptions} "
          f"preemptions, {st.resumes} resumes, "
          f"{st.swapped_out_bytes / 1e6:.1f} MB swapped out, "
          f"{st.swapped_in_bytes / 1e6:.1f} MB back in, {st.grown_pages} "
          f"pages grown; served in {serve_s:.2f}s; outputs equal to path 1's "
          f"for {same}/{len(reqs)} requests", flush=True)
    require(counts == pred, "path 1b: launch counts differ from the "
            "prediction")
    require(st.preemptions >= 2, "path 1b: fewer than two preemptions")
    require(st.resumes == st.preemptions, "path 1b: a preemption did not "
            "resume")
    require(st.swapped_out_bytes == st.swapped_in_bytes > 0,
            "path 1b: swapped bytes out and in differ")
    require(same == len(reqs), "path 1b: outputs differ from path 1's")
    eng.pager.check_invariants()
    require(eng.pager.free_pages == eng.pager.num_pages - 1,
            "path 1b: pages left allocated")
    RESULTS["path1b"] = dict(
        launches=counts, predicted=pred, decode_steps=st.steps,
        prefill_batches=st.prefill_batches, preemptions=st.preemptions,
        resumes=st.resumes, swapped_out_bytes=st.swapped_out_bytes,
        swapped_in_bytes=st.swapped_in_bytes, grown_pages=st.grown_pages,
        serve_s=serve_s, same_outputs_as_path1=same,
        **check_decode_graph(eng, "path 1b"))


def inject_hot_channels(params, cfg, seed=0, hot_scale=100.0):
    """The hot channels of ``benchmarks/common.py:outlier_model``, without
    JAX: d_model/32 seeded embedding channels scaled by ``hot_scale``, so
    that some layers' post-smoothing inputs fail the A8 threshold."""
    rng = np.random.default_rng(seed)
    hot = np.ones(cfg.d_model, np.float32)
    hot[rng.choice(cfg.d_model, size=max(2, cfg.d_model // 32),
                   replace=False)] = hot_scale
    params["embed"]["table"].mul_(torch.from_numpy(hot).to(DEV)[None, :])


# (c)'s limit on the relative L2 difference of A8 prefill logits from A16:
# about five times the readings (0.0185 on path 2, 0.0210 on path 3; H100
# 80GB HBM3, 700 W) and far under those of an A8 kernel broken on purpose
# (PERF.md, "A8 step check")
A8_REL_L2_LIMIT = 0.1


def path2_step_checks(params, cfg, ps, prompt):
    """(a) steps on ``cfg``'s pools vs the gather oracle on dequantized
    weights; (b) on one pool, a decode step under a8_prefill is bitwise
    equal to the one under a16 (the token gate keeps decode on A16); (c) a
    prefill chunk under a8_prefill vs a16: finite, the same next token, and
    0 < relative L2 difference <= ``A8_REL_L2_LIMIT``."""
    a16 = cfg.with_(act_quant="a16")
    print(f"  (a) {'int8' if cfg.kv_quant else 'fp'} pools, a16: one prefill "
          "+ one decode step vs the gather oracle")
    errs = check_step_against_plain(params, a16, ps, prompt)
    l16, pool, table = _prefill_step(params, a16, ps, prompt)
    pool8 = {"layers": [{k: v.clone() for k, v in lp.items()}
                        for lp in pool["layers"]]}
    d16 = _decode_step(params, a16, pool, table, prompt)
    d8 = _decode_step(params, cfg, pool8, table, prompt)
    require(torch.equal(d16, d8),
            "(b) decode logits under a8_prefill differ from a16")
    print("  (b) decode step under a8_prefill bitwise equal to a16: True")
    l8, _, _ = _prefill_step(params, cfg, ps, prompt)
    require(bool(torch.isfinite(l8).all()), "(c) A8 prefill logits not finite")
    rel = float((l8 - l16).norm() / l16.norm())
    lim = A8_REL_L2_LIMIT
    print(f"  (c) prefill chunk ({len(prompt)} tokens) a8_prefill vs a16: "
          f"relative L2 difference {rel:.4g} (limit {lim}), next token "
          f"{int(l8.argmax())} vs {int(l16.argmax())}")
    require(0.0 < rel <= lim, "(c) A8 prefill logits outside the limit")
    require(int(l8.argmax()) == int(l16.argmax()),
            "(c) A8 prefill picks another next token than A16")
    return dict(errs, a8_vs_a16_prefill_rel_l2=rel, a8_rel_bound=lim)


def path2():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.calibration import synthetic_calibration_set
    from repro_torch.models import api
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            load_or_quantize)

    print("path 2: codellama-7b full width, hot channels, SmoothQuant+ with "
          "the W4A8 eligibility pass, int8 KV pools, act_quant=a8_prefill, "
          "8 requests", flush=True)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("codellama-7b").with_(dtype="float32")
    qcfg = QuantConfig(group_size=128)
    params = api.init_model(cfg, seed=0, device=DEV)
    inject_hot_channels(params, cfg)
    calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, rep = load_or_quantize(params, cfg, calib, qcfg)
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    flags = rep.a8_eligibility
    n_elig = sum(flags.values())
    print(f"  PTQ alpha={rep.alpha:.2f} in {ptq_s:.1f}s (both calibration "
          f"passes); A8 flags {flags}; worst errors "
          f"{ {k: round(v, 5) for k, v in rep.a8_errors.items()} }")
    require(n_elig >= 1, "no A8-eligible linear")
    cfg2 = cfg.with_(kv_quant=True, act_quant="a8_prefill")
    eng = ServingEngine(params, cfg2, batch_size=4, max_seq=256,
                        page_size=16, max_prefill_tokens=128, seed=0,
                        device=DEV)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 201, 8)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, int(n)
                                               ).astype(np.int32),
                    max_tokens=16) for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    with path_operands() as seen:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    nl = cfg.num_layers
    a8_pred = sum(n_elig * nl for rows, _ in st.chunk_rows
                  if rows >= ops.A8_MIN_TOKENS)
    pred = {"w4a8_matmul": a8_pred,
            "w4a16_matmul": 7 * nl * (st.steps + st.prefill_batches)
            - a8_pred,
            "gqa_paged_decode_int8": nl * st.steps,
            "gqa_paged_prefill_int8": nl * st.prefill_batches,
            "gqa_paged_decode": 0, "gqa_paged_prefill": 0,
            "w4a16_grouped": 0, "w4a8_grouped": 0, "flash_attention": 0,
            **{n: 0 for n in MLA_KERNELS}}
    print(f"  launches {counts}; predicted {pred}; decode steps {st.steps}, "
          f"prefill batches {st.prefill_batches} (rows, max prefix_len) "
          f"{st.chunk_rows}")
    require(all(r.finish_reason in ("completed", "length") for r in reqs),
            "path 2: a request did not finish")
    require(all(len(r.output) == 16 or r.finish_reason == "completed"
                for r in reqs), "path 2: a request stopped early without EOS")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            "path 2: token out of range")
    require(counts == pred, "path 2: launch counts differ from the "
            "prediction")
    require(counts["w4a8_matmul"] > 0, "path 2: no A8 launch")
    require(any(start > 0 for _, start in st.chunk_rows),
            "path 2: no chunk read int8 prefix pages")
    tok_s = st.decoded_tokens / serve_s
    ttft = sorted(r.first_token_t - r.arrival_t for r in reqs)
    print(f"  served {st.completed} requests in {serve_s:.2f}s: "
          f"{tok_s:.1f} decode tok/s, TTFT p50 {statistics.median(ttft):.3f}s "
          f"max {ttft[-1]:.3f}s, peak memory {peak / 2 ** 30:.2f} GiB",
          flush=True)
    RESULTS["path2"] = dict(
        launches=counts, predicted=pred, decode_steps=st.steps,
        prefill_batches=st.prefill_batches, chunk_rows=list(st.chunk_rows),
        decoded_tokens=st.decoded_tokens,
        prefilled_tokens=st.prefilled_tokens, serve_s=serve_s,
        decode_tok_s=tok_s, ttft_s=ttft, ptq_s=ptq_s, alpha=rep.alpha,
        a8_eligibility=flags, a8_errors=rep.a8_errors, peak_mem_bytes=peak,
        **check_decode_graph(eng, "path 2"))
    RESULTS["path2"].update(path2_step_checks(eng.params, cfg2, eng.PS,
                                              reqs[0].prompt))
    RESULTS["path2"]["path_operands"] = check_path_operands(seen, "path 2")
    del seen
    profile_decode(eng, reqs, "path2_profile")
    return counts


def forward_flash_check(params, cfg, t=2048, seed=0):
    """(d) ``api.forward_fn`` on one t-token sequence with attn_impl="flash"
    (B4, its block skip live at t=2048) against "chunked", both A16: under
    a8_prefill the per-token int8 rounding of every GEMM input turns the two
    attentions' 1e-7 differences into code flips, which measures A8's
    sensitivity rather than B4.  Both are f32: every logit finite, every
    position's max |diff| within 1e-5 of the logit scale (about ten times
    the 1.2e-6 read on an H100) and the same argmax at every position.  A
    top-8 router choice that two experts' probabilities tie within the f32
    noise would flip that token's output (and, through capacity, its
    expert-mates'); the positions over the limit are printed."""
    from repro_torch.models import api

    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (1, t)).astype(np.int32)).to(DEV)
    before = K.launch_counts()["flash_attention"]
    with torch.no_grad():
        lf = api.forward_fn(params, {"tokens": toks},
                            cfg.with_(attn_impl="flash", act_quant="a16"))[0]
        n_flash = K.launch_counts()["flash_attention"] - before
        lc = api.forward_fn(params, {"tokens": toks},
                            cfg.with_(attn_impl="chunked", act_quant="a16"))[0]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(lf).all()), "(d) flash logits not finite")
    require(n_flash == cfg.num_layers, "(d) B4 not launched once per layer")
    scale = max(1.0, float(lc.abs().max()))
    per_pos = (lf - lc).abs().amax(dim=-1) / scale
    same = (lf.argmax(-1) == lc.argmax(-1)).float().mean().item()
    over = torch.nonzero(per_pos.flatten() > 1e-5).flatten().tolist()
    med = float(per_pos.median())
    print(f"  (d) forward_fn T={t} a16, flash vs chunked: per-position max "
          f"|diff| / scale {scale:.3g}: median {med:.3g}, max "
          f"{float(per_pos.max()):.3g} (limit 1e-5); positions over it "
          f"{over[:20]}; argmax agreement {same:.4f}")
    require(not over and same == 1.0, "(d) flash forward differs from "
            "chunked")
    del lf, lc
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=act) as prof:
        api.forward_fn(params, {"tokens": toks},
                       cfg.with_(attn_impl="flash", act_quant="a16"))
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    b4 = [e for e in kern if "flash_" in e.key]
    b4_ms = sum(e.self_device_time_total for e in b4) / 1e3
    print(f"  (d) device time of the T={t} flash forward_fn (torch.profiler): "
          f"{dev_ms:.3f} ms of kernels, of which B4 {b4_ms:.3f} ms in "
          f"{sum(e.count for e in b4)} launches")
    return dict(forward_t=t, forward_median_rel=med,
                forward_max_rel=float(per_pos.max()),
                forward_positions_over=len(over), forward_argmax_agree=same,
                forward_device_ms=dev_ms, forward_b4_device_ms=b4_ms)


def path3():
    from repro_torch.launch import serve

    print("path 3: granite-moe-1b-a400m full width, SmoothQuant+ with the W4A8 "
          "eligibility pass, attn_impl=flash, act_quant=a8_prefill, fp pools, "
          "8 requests", flush=True)
    torch.cuda.reset_peak_memory_stats()
    with path_operands() as seen:
        K.reset_launch_counts()
        res = serve.main(["--arch", "granite-moe-1b-a400m", "--requests", "8",
                          "--batch-size", "4", "--max-seq", "256",
                          "--max-tokens", "16", "--min-prompt", "32",
                          "--max-prompt", "200", "--seed", "0",
                          "--act-quant", "a8_prefill"], attn_impl="flash")
        torch.cuda.synchronize()
        counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    eng, reqs, cfg, rep = res["engine"], res["requests"], res["cfg"], \
        res["report"]
    st = eng.stats
    nl = cfg.num_layers
    flags = rep.a8_eligibility
    attn_elig = sum(v for k, v in flags.items() if "/mixer/" in k)
    exp_elig = sum(v for k, v in flags.items() if "/experts/" in k)
    # every prefill chunk is one [n, blen] call: its attention linears see
    # n·blen rows, its experts the capacity of n·blen tokens; decode calls
    # see batch_size rows and a capacity of top_k (< 16: A16)
    a8_chunks = sum(rows >= ops.A8_MIN_TOKENS for rows, _ in st.chunk_rows)
    b7_chunks = sum(MLP.moe_capacity(rows, cfg.moe) >= ops.A8_MIN_TOKENS
                    for rows, _ in st.chunk_rows)
    calls = st.steps + st.prefill_batches
    pred = {"w4a16_matmul": 4 * nl * calls - nl * attn_elig * a8_chunks,
            "w4a8_matmul": nl * attn_elig * a8_chunks,
            "gqa_paged_decode": nl * st.steps,
            "gqa_paged_prefill": nl * st.prefill_batches,
            "gqa_paged_decode_int8": 0, "gqa_paged_prefill_int8": 0,
            "w4a16_grouped": 3 * nl * calls - nl * exp_elig * b7_chunks,
            "w4a8_grouped": nl * exp_elig * b7_chunks,
            "flash_attention": 2 * res["calib_batches"] * nl,
            **{n: 0 for n in MLA_KERNELS}}
    print(f"  A8 flags {flags}; worst errors "
          f"{ {k: round(v, 5) for k, v in rep.a8_errors.items()} }")
    print(f"  launches {counts}; predicted {pred}; decode steps {st.steps}, "
          f"prefill batches {st.prefill_batches} (rows, max prefix_len) "
          f"{st.chunk_rows}; expert capacities "
          f"{[MLP.moe_capacity(r, cfg.moe) for r, _ in st.chunk_rows]}")
    require(all(r.finish_reason in ("completed", "length") for r in reqs),
            "path 3: a request did not finish")
    require(all(len(r.output) == 16 or r.finish_reason == "completed"
                for r in reqs), "path 3: a request stopped early without EOS")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            "path 3: token out of range")
    require(exp_elig >= 1, "path 3: no A8-eligible expert weight (errors "
            f"{rep.a8_errors})")
    require(counts == pred, "path 3: launch counts differ from the "
            "prediction")
    for name in ("flash_attention", "w4a16_grouped", "w4a8_grouped"):
        require(counts[name] > 0, f"path 3: {name} not launched")
    tok_s = st.decoded_tokens / res["serve_s"]
    ttft = sorted(res["ttft_s"])
    print(f"  PTQ alpha={rep.alpha:.2f} in {res['ptq_s']:.1f}s (both "
          f"calibration passes); served {st.completed} requests in "
          f"{res['serve_s']:.2f}s: {tok_s:.1f} decode tok/s, TTFT p50 "
          f"{statistics.median(ttft):.3f}s max {ttft[-1]:.3f}s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    RESULTS["path3"] = dict(
        launches=counts, predicted=pred, decode_steps=st.steps,
        prefill_batches=st.prefill_batches, chunk_rows=list(st.chunk_rows),
        decoded_tokens=st.decoded_tokens,
        prefilled_tokens=st.prefilled_tokens, serve_s=res["serve_s"],
        decode_tok_s=tok_s, ttft_s=ttft, ptq_s=res["ptq_s"],
        boot_s=res["boot_s"], alpha=rep.alpha, a8_eligibility=flags,
        a8_errors=rep.a8_errors, peak_mem_bytes=peak,
        **check_decode_graph(eng, "path 3"))
    RESULTS["path3"].update(path2_step_checks(eng.params, cfg, eng.PS,
                                              reqs[0].prompt))
    RESULTS["path3"]["path_operands"] = check_path_operands(seen, "path 3")
    del seen
    RESULTS["path3"].update(forward_flash_check(eng.params, cfg))
    profile_decode(eng, reqs, "path3_profile")
    return counts


def path3_group256():
    """Path 3's model served with G=256 through the serve entry (4
    requests, A16 decode, ``a8_prefill``): K1/B6 and B5/B7 walk each group
    in two ring stages.  Every request finishes, K1 and B6 (and B7 where a
    stack is A8-eligible) launch, and every kernel is held against its
    plain version on the path's operands."""
    from repro_torch.launch import serve

    print("path 3 at G=256: granite-moe-1b-a400m, --group-size 256, "
          "act_quant=a8_prefill, 4 requests", flush=True)
    with path_operands() as seen:
        K.reset_launch_counts()
        res = serve.main(["--arch", "granite-moe-1b-a400m", "--requests", "4",
                          "--batch-size", "4", "--max-seq", "256",
                          "--max-tokens", "8", "--min-prompt", "32",
                          "--max-prompt", "200", "--seed", "1",
                          "--group-size", "256", "--act-quant",
                          "a8_prefill"])
        torch.cuda.synchronize()
        counts = K.launch_counts()
    reqs, cfg, rep = res["requests"], res["cfg"], res["report"]
    print(f"  launches {counts}; A8 flags {rep.a8_eligibility}")
    require(all(r.finish_reason in ("completed", "length") for r in reqs),
            "path 3 at G=256: a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            "path 3 at G=256: token out of range")
    need = ["w4a16_matmul", "w4a16_grouped"]
    if any(v for k, v in rep.a8_eligibility.items() if "/experts/" in k):
        need.append("w4a8_grouped")
    for name in need:
        require(counts[name] > 0, f"path 3 at G=256: {name} not launched")
    RESULTS["path3_g256"] = dict(
        launches=counts, ptq_s=res["ptq_s"], serve_s=res["serve_s"],
        ttft_s=sorted(res["ttft_s"]),
        path_operands=check_path_operands(seen, "path 3 at G=256"),
        **check_decode_graph(res["engine"], "path 3 at G=256"))
    del seen, res
    return counts


def _path4_engine(params, cfg, reqs, label):
    """One engine over ``params`` serving ``reqs`` (fresh copies of them):
    the launch counts held to the prediction from the engine's steps and
    prefill batches, the outputs checked, the operands of every kernel's
    launches at each distinct shape kept for the operand check."""
    from repro_torch.serving.engine import Request, ServingEngine

    quant = cfg.kv_quant
    reqs = [Request(uid=r.uid, prompt=r.prompt, max_tokens=r.max_tokens)
            for r in reqs]
    eng = ServingEngine(params, cfg, batch_size=4, max_seq=256, page_size=16,
                        max_prefill_tokens=128, seed=0, device=DEV)
    torch.cuda.synchronize()
    with path_operands() as seen:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = K.launch_counts()
    st = eng.stats
    nl = cfg.num_layers
    calls = st.steps + st.prefill_batches
    sfx = "_int8" if quant else ""
    # per layer and call: K1 for wq_a, wq_b, wkv_a, wo and the shared
    # expert's gate/up/down (wkv_b itself is never read to serve); B6 for
    # the routed experts' gate/up/down and the absorbed wk_t / wv
    pred = {n: 0 for n in K.WRAPPERS}
    pred.update({"w4a16_matmul": 7 * nl * calls,
                 "w4a16_grouped": 5 * nl * calls,
                 "mla_paged_decode" + sfx: nl * st.steps,
                 "mla_paged_prefill" + sfx: nl * st.prefill_batches})
    print(f"  {label}: launches {counts}; predicted {pred}; decode steps "
          f"{st.steps}, prefill batches {st.prefill_batches} (rows, max "
          f"prefix_len) {st.chunk_rows}")
    require(all(r.finish_reason in ("completed", "length") for r in reqs),
            f"{label}: a request did not finish")
    require(all(len(r.output) == r.max_tokens or r.finish_reason ==
                "completed" for r in reqs),
            f"{label}: a request stopped early without EOS")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            f"{label}: token out of range")
    require(counts == pred, f"{label}: launch counts differ from the "
            "prediction")
    require(any(start > 0 for _, start in st.chunk_rows),
            f"{label}: no chunk read prefix pages")
    tok_s = st.decoded_tokens / serve_s
    ttft = sorted(r.first_token_t - r.arrival_t for r in reqs)
    print(f"  {label}: served {st.completed} requests in {serve_s:.2f}s: "
          f"{tok_s:.1f} decode tok/s, TTFT p50 {statistics.median(ttft):.3f}s "
          f"max {ttft[-1]:.3f}s", flush=True)
    res = dict(launches=counts, predicted=pred, decode_steps=st.steps,
               prefill_batches=st.prefill_batches,
               chunk_rows=list(st.chunk_rows),
               decoded_tokens=st.decoded_tokens,
               prefilled_tokens=st.prefilled_tokens, serve_s=serve_s,
               decode_tok_s=tok_s, ttft_s=ttft,
               outputs=[r.output for r in reqs],
               **check_decode_graph(eng, label))
    res["path_operands"] = check_path_operands(seen, label)
    del seen
    print(f"  {label} (a) {'int8' if quant else 'fp'} latent pools: one "
          "prefill + one decode step vs the gather oracle on the dequantized "
          "weights")
    res.update(check_step_against_plain(params, cfg, eng.PS, reqs[0].prompt))
    return eng, reqs, counts, res


def path4():
    """deepseek-v2-236b at full width, 2 layers: fp latent pools (path 4),
    then int8 latent pools over the same quantized params (path 4b)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.calibration import synthetic_calibration_set
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, load_or_quantize

    print("path 4: deepseek-v2-236b full width, 2 of 60 layers, SmoothQuant+ "
          "W4A16 f32, A16, max_prefill_tokens=128, fp then int8 latent "
          "pools", flush=True)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("deepseek-v2-236b").with_(num_layers=2, dtype="float32")
    params = api.init_model(cfg, seed=0, device=DEV)
    calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, rep = load_or_quantize(params, cfg, calib,
                                   QuantConfig(group_size=128))
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    ptq_peak = torch.cuda.max_memory_allocated()
    require(all(isinstance(lp["mixer"]["wkv_b_absorbed"][k], QuantizedTensor)
                for lp in params["layers"] for k in ("wk_t", "wv")),
            "path 4: no absorbed int4 pair")
    print(f"  PTQ alpha={rep.alpha:.2f} in {ptq_s:.1f}s (both calibration "
          f"passes), {rep.fp_bytes / 1e9:.2f} GB -> {rep.quant_bytes / 1e9:.2f}"
          f" GB, peak memory {ptq_peak / 2 ** 30:.2f} GiB", flush=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 201, 8)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, int(n)
                                               ).astype(np.int32),
                    max_tokens=16) for i, n in enumerate(lens)]
    torch.cuda.reset_peak_memory_stats()
    eng, reqs4, counts4, res4 = _path4_engine(params, cfg, reqs, "path 4")
    res4["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    profile_decode(eng, reqs4, "path4_profile")
    del eng
    gc.collect()
    eng, reqs4b, counts4b, res4b = _path4_engine(
        params, cfg.with_(kv_quant=True), reqs, "path 4b")
    profile_decode(eng, reqs4b, "path4b_profile")
    del eng
    same = sum(a == b for a, b in zip(res4["outputs"], res4b["outputs"]))
    print(f"  path 4b greedy outputs equal to path 4's for {same}/"
          f"{len(reqs)} requests (int8 latent rows may move a near tie)")
    print(f"  path 4: peak memory {ptq_peak / 2 ** 30:.2f} GiB (PTQ), "
          f"{res4['peak_mem_bytes'] / 2 ** 30:.2f} GiB (serving and step "
          "check)", flush=True)
    RESULTS["path4"] = dict(res4, ptq_s=ptq_s, alpha=rep.alpha,
                            ptq_peak_mem_bytes=ptq_peak, fp_bytes=rep.fp_bytes,
                            quant_bytes=rep.quant_bytes,
                            a8_eligibility=rep.a8_eligibility)
    RESULTS["path4b"] = dict(res4b, same_outputs_as_path4=same)
    return counts4, counts4b


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    args = ap.parse_args()
    strict_fp32_matmul()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.1f}s (nvcc, sm_90a, "
          f"{len(_build.SOURCES)} sources in parallel)", flush=True)
    RESULTS.update(card=card, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s)

    torch.cuda.reset_peak_memory_stats()
    k1, b5, k2, k3 = check_k1(), check_b5(), check_k2(), check_k3()
    b67, b4, b89 = check_grouped(), check_flash(), check_mla()
    check_offset_only()
    check_large_groups()
    RESULTS["kernel_phase_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    print(f"kernel phase peak memory "
          f"{RESULTS['kernel_phase_peak_mem_bytes'] / 2 ** 30:.2f} GiB "
          f"(of {torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}"
          " GiB)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["kernel_phase_left_bytes"] = torch.cuda.memory_allocated()
    print(f"kernel phase leaves "
          f"{RESULTS['kernel_phase_left_bytes'] / 2 ** 30:.3f} GiB allocated",
          flush=True)
    counts1 = main_path()
    gc.collect()
    torch.cuda.empty_cache()        # path 1's engine and params are gone
    counts2 = path2()
    gc.collect()
    torch.cuda.empty_cache()
    counts3 = path3()
    gc.collect()
    torch.cuda.empty_cache()
    path3_group256()
    gc.collect()
    torch.cuda.empty_cache()
    counts4, counts4b = path4()

    # one row per kernel: its path's shape in the paths' f32, and its
    # launches on the path that runs it
    picks = {
        "w4a16_matmul": (k1[(4, 4096, 11008, torch.float32)], counts1,
                         "csrc/w4a16_matmul.cu",
                         "src/repro/kernels/w4a16_matmul.py:72"),
        "gqa_paged_decode": (k2[("grp=1", torch.float32)], counts1,
                             "csrc/gqa_paged_decode.cu",
                             "src/repro/kernels/paged_attention.py:65"),
        "gqa_paged_prefill": (k3[(256, False, torch.float32, torch.float32)],
                              counts1,
                              "csrc/gqa_paged_prefill.cu",
                              "src/repro/kernels/paged_attention.py:315"),
        "w4a8_matmul": (b5[(512, 4096, 11008, torch.float32)], counts2,
                        "csrc/w4a8_matmul.cu",
                        "src/repro/kernels/w4a16_matmul.py:94"),
        "gqa_paged_decode_int8": (k2[("grp=1", torch.int8)], counts2,
                                  "csrc/gqa_paged_decode.cu",
                                  "src/repro/kernels/paged_attention.py:65"),
        "gqa_paged_prefill_int8": (k3[(256, True, torch.int8, torch.float32)],
                                   counts2,
                                   "csrc/gqa_paged_prefill.cu",
                                   "src/repro/kernels/paged_attention.py:315"),
        "w4a16_grouped": (b67[(False, 8, 1024, torch.float32)], counts3,
                          "csrc/w4a16_grouped.cu",
                          "src/repro/kernels/w4a16_grouped.py:42"),
        "w4a8_grouped": (b67[(True, max(c for _, c, _, _ in b67), 1024,
                              torch.float32)], counts3,
                         "csrc/w4a8_grouped.cu",
                         "src/repro/kernels/w4a16_grouped.py:64"),
        "flash_attention": (b4[(2048, 16, 64, True, torch.float32)], counts3,
                            "csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:31"),
        "mla_paged_decode": (b89[("decode", torch.float32)], counts4,
                             "csrc/mla_paged_decode.cu",
                             "src/repro/kernels/paged_attention.py:189"),
        "mla_paged_decode_int8": (b89[("decode", torch.int8)], counts4b,
                                  "csrc/mla_paged_decode.cu",
                                  "src/repro/kernels/paged_attention.py:189"),
        "mla_paged_prefill": (b89[("prefill", 128, torch.float32)], counts4,
                              "csrc/mla_paged_prefill.cu",
                              "src/repro/kernels/paged_attention.py:484"),
        "mla_paged_prefill_int8": (b89[("prefill", 128, torch.int8)],
                                   counts4b, "csrc/mla_paged_prefill.cu",
                                   "src/repro/kernels/paged_attention.py:484"),
    }
    for name, (_, counts, _, _) in picks.items():
        require(counts[name] > 0, f"{name} was not launched on its path")
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/{src}", "replaces": rep,
         "launches": counts[name], "max_abs_err": row["max_abs_err"],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"], "case": row["case"]}
        for name, (row, counts, src, rep) in picks.items()]}
    RESULTS["kernels"] = line["kernels"]
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(RESULTS, indent=1))
    print(card_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
