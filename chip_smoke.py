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
   with peaked scores (fp and int8 pools: P V sums past 2048 keys); B9
   behind 2048- and 8192-token prefixes and B8 at 65,536 positions (32
   splits of 2048 keys) with peaked scores, f32, bf16 and int8 latent pools
   (``launch/mla_shares.py``'s cases), each held to a float64 evaluation
   and its share of the tolerance printed beside the plain version's; then
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
   path 1c — path 1's quantized params saved with ``save_ptq`` (the config
   serve built) into a temporary directory, then path 1's serve call again
   with ``--ptq-artifact``: the boot must take ``artifact-load`` with zero
   calibration batches, the loaded params and report must equal path 1's,
   the outputs path 1's token for token, the launch counts path 1's
   prediction for this run's steps and chunks; prints the artifact's bytes,
   the save and load seconds beside path 1's PTQ seconds and the peak
   memory, and deletes the artifact (paths 1-4 pass serve ``--prefix-cache
   off --rate inf``: no cache, every request arriving at submit, as before
   the cache was ported);
   path 1d — path 1's params with the prefix cache: 8 requests in two waves
   of 4 (each drained before the next), every prompt a 96-token system
   prompt + a 16-100-token suffix, wave 2 opening with wave 1's 112-token
   page-aligned prompt (a COW copy and a one-token K3 chunk behind 111
   cached tokens); served cold (cache off) and warm: the tokens equal,
   wave 2 hits on all 4 admissions with >= 384 cached tokens and a COW,
   the warm run prefills fewer tokens; each wave's TTFT p50 / max from the
   engine's histogram, cold and warm;
   path 1e — path 1's params under serve's ``--chaos`` plan (seed 0),
   ``strict=False``, prefix cache on, path 1d's 8 requests at once from 90
   four-token pages, ``max_queue=7`` (the eighth is rejected), one
   ``ttft_deadline_s=0`` and one cancel mid-decode: every request ends
   terminal, ``faults_fired_total`` reconciles with the plan, the pager
   ends with nothing referenced or held, at least two preemptions, the
   decode graph replays after the ``decode_launch`` fault, untouched
   requests have path 1d's cold tokens; the Chrome trace is written to a
   temporary file and its event count printed;
   metrics overhead — the decode wall per step with the engine's metrics
   on and off (two engines, batch 4, windows in turns on, off, off, on);
   path 2 — codellama-7b, seeded hot channels injected into the embedding,
   quantize-on-load with the W4A8 eligibility pass, then the engine with
   int8 KV pools and ``act_quant="a8_prefill"`` (``max_prefill_tokens=128``);
   its launch counts must equal the counts predicted from the A8 flags and
   the engine's chunk log; step checks (a) int8-pool steps vs the gather
   oracle, (b) decode under a8_prefill bitwise equal to a16, (c) an A8
   prefill chunk within a stated limit of A16, with the same next token;
   path 2c — path 2's outlier codellama-7b at G=128 quantized by RTN, AWQ
   (α per group) and SmoothQuant+, each from fresh fp params: relative
   logit error and argmax agreement against the fp model on two held-out
   32-token sequences, seconds, AWQ's α per group (finite logits required;
   the ordering is a finding, not a check);
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
   steps and prefill batches, operand checks, step check (a); path 4c —
   path 4's params with the prefix cache, two waves of 4 behind a 128-token
   system prompt (B9 reads cached latent pages, B8 decodes over shared
   ones), cold and warm as path 1d;
   path 5 — the registry's other dense decoders at full width, random
   seeded weights with every bias and LayerNorm shift filled from a seeded
   N(0, 0.02²), SmoothQuant+ in f32 (G=128), A16, fp pools, path 1's 8
   requests: llama3.2-3b (tied 128256-row head, grp 3), chatglm3-6b
   (RoPE-2d, grp 16; through the serve entry), qwen2-vl-7b (M-RoPE,
   q/k/v/o biases, grp 7) and starcoder2-15b (LayerNorm, GELU MLP, biases,
   grp 12) at full depth, mistral-large-123b (12288 ↔ 28672 GEMMs, grp
   12) with its depth cut to 6 of 88 layers (reduced: a layer is 5.5 GB in
   f32, the whole model 490 GB).  Each: launch counts equal to the
   prediction (K1 for 7 linears a layer, 6 with the GELU MLP, per decode
   step and prefill batch; K2 once a layer a step; K3 once a layer a
   batch), graph replays equal to the decode steps with one replay bitwise
   against an eager step, one prefill and one decode step against the
   dequantized gather oracle, every kernel against its plain version on the
   path's operands; tok/s, TTFT p50 / max, PTQ s and peak memory per model,
   and the path's seconds.  The kernel phase holds K2/K3 at path 5's (Hkv,
   grp) (8, 3), (4, 7), (4, 12), (2, 16), (8, 12) at path 1's lengths and
   chunk shape, f32 and bf16, and K1 at its MLP widths (4096 ↔ 13696,
   6144 ↔ 24576, 12288 ↔ 28672; T=4 and 512);
   path 6 — zamba2-7b at full width and depth (81 Mamba2 layers, 13
   applications of the weight-shared attention + MLP block) through the
   serve entry, SmoothQuant+ in f32 (G=128), fp pools, path 1's requests:
   launch counts equal the prediction (K1 for 5 linears a Mamba2 layer and
   7 a shared application, every decode step and prefill batch; K2 / K3
   once an application), the decode graph (its fixed-rows Mamba2 state
   updated in place) replays once a step, and in the decode profile one
   replay with a parked slot (``active`` False) is held bitwise against an
   eager step (logits, pools, fixed rows; the parked slot's rows
   unchanged); after the path's first replay its step reruns from the
   state before it and must land on the replay's rows bit for bit; one
   prefill chunk and one decode step against the dequantized gather
   oracle; path 6b — path 6's params under path 1b's tight pool: at least
   two preemptions, each swapping one slot's fixed rows with its private
   KV rows under one CRC, checked at swap-in, the fixed-rows bytes whole
   slots', the tokens path 6's; path 7 — rwkv6-7b at full width and depth
   (32 layers) through ``api.prefill_fn`` / ``api.decode_fn`` (RWKV6 has
   no paged path), SmoothQuant+ in f32 (G=128), 8 greedy requests in two
   batches of 4 equal-length prompts, 16 tokens: K1 (8 linears a layer, a
   prefill and a decode step each) held to the prediction and to its
   plain version on the path's operands, a prefill and a decode step
   against the dequantized weights, the decode step's wall and device ms
   and the prefill's wall per prompt token (the Python scan).  The kernel
   phase holds K1 at the SSM paths' widths (Co 112 / 128, narrower than a
   tile; 3584 ↔ 7168; 4096 ↔ 14336) and K2 / K3 at Dh 112;
   path 8 — whisper-medium at full width and depth (24 encoder and 24
   decoder layers, 16 heads of 64, d_ff 4096, vocab 51865, tied head,
   LayerNorm, GELU, a bias on every projection filled from a seeded N(0,
   0.02²)), SmoothQuant+ in f32 (G=128, α searched; calibration sequences
   of 24 tokens and 24 frames) through the library entry points, page size
   16, batch 4, max_seq 1536, path 1's 8 prompts, 16 new tokens, every
   request with 1500 encoder frames (Whisper's 30 s window after the
   conv stub's stride 2), requests 0, 3 and 6 with the same audio: the
   encodes and exact-match hits held to the prediction (6 and 2), K1 to
   192 a decode step, a prefill batch and an encode, K2 / K3 to 24 a step
   / a batch; an encode, a prefill chunk and a decode step against the
   dequantized weights; the graph replay (one row idle on the trash page
   with 0 encoder rows) bitwise against an eager step, the encoder pool
   unchanged; tok/s, TTFT (the encode included), one encode's wall and
   device ms, the decode profile, and the decode step's cross-attention
   gather alone (24 layers of a 1536-row page gather and two einsums at
   batch 4); path 8b — the same params and requests on a fresh engine, one
   mid-decode preemption forced white-box: the victim's 94 encoder pages
   detached under swap holds, its image its private KV rows only, the
   tokens path 8's; then whisper-medium through the serve entry (its own
   PTQ, serve's 6-10-row synthetic frames). The kernel phase holds K1 at
   path 8's widths (1024 → 1024, 1024 ↔ 4096; T=4 and 1500) and K2 / K3
   at Hkv 16, grp 1, Dh 64;
   path 4d — path 4's quantized params through MLA's contiguous latent
   cache (``api.prefill_fn`` on 4 prompts of one length, 16 greedy
   ``api.decode_fn`` steps): K1 and B6 held to the prediction and to
   their plain versions on the path's operands, the prefill against the
   dequantized ``wkv_b`` codes, the decode steps against the paged path
   (B8) from the same latent rows (logits within 1e-4 of the scale,
   greedy tokens equal), the gap between the two prefill routes printed,
   a decode step's wall and device ms;
   path 9 — llama3.2-3b at full width and depth in bf16 trained through
   ``launch.train.main`` (the JAX CLI's defaults: batch 8, 128 tokens,
   remat block, lr 3e-4, 20 steps): finite losses and gradient norms,
   the loss falling, no kernel launched; peak memory printed against the
   predicted bytes (params, grads, f32 moments), a step's wall and
   tokens/s; then a step's, its loss + gradients' and its AdamW's wall and
   busy time on the card (torch.profiler), a step with remat none and
   one with ``int8_ef`` (their peaks); path 9b — codellama-7b smoke f32
   train steps (microbatch 2, int8 error feedback) on the card against the
   CPU, each from the CPU's state (``TRAIN_STEP_TOL``), then 3 steps run
   free on each (``FREE_RUN_TOL``), and a checkpoint saved at step 2 and restored on the card
   taking step 3 (bitwise or not, printed);
   path 10a — right after path 1's decode profile, ``launch/op_cost.py``
   over meta copies of path 1's params and pools (nothing allocated, no
   kernel launched): the FLOPs and bytes of the decode step its graph
   replays (batch 4) and of a B=2, T=256 prefill chunk, their compute and
   memory terms at the H100 SXM's constants (``launch/roofline.py``), and
   the decode step's share, bound / the device ms path 1's profile read;
   path 10b — after path 9b, a (1, 1) ``DeviceMesh`` on the card (one
   NCCL rank from a ``FileStore``): 9b's checkpoint restored with the
   rules' placements, every leaf bitwise equal to the plain restore, then
   one train step with params, optimizer state and batch placed as
   ``DTensor`` s held to the unplaced step (``TEN_B_TOL``); the group is
   destroyed;
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
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# the serve flags that keep paths 1-4 as they ran before the prefix cache:
# no cache, and every request arriving when it is submitted
SERVE_COLD = ["--prefix-cache", "off", "--rate", "inf"]


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


# path 5's widest GEMMs: chatglm3-6b's MLP, starcoder2-15b's, mistral-large's
DENSE_WIDTHS = ((4096, 13696), (13696, 4096), (6144, 24576), (24576, 6144),
                (12288, 28672), (28672, 12288))


def check_k1_widths():
    """K1 at path 5's MLP widths, T=4 (decode) and 512 (a prefill chunk),
    G=128, f32 X."""
    print("K1 at path 5's MLP widths")
    rows = {}
    for ci, co in DENSE_WIDTHS:
        gen = torch.Generator(device=DEV).manual_seed(ci + co)
        w = torch.randn(ci, co, generator=gen, device=DEV) * ci ** -0.5
        qt = quantize(w, group_size=128)
        del w
        for t in (4, 512):
            x = torch.randn(t, ci, generator=gen, device=DEV)
            rows[(t, ci, co)] = _gemm_case(
                "w4a16_matmul", W4.w4a16_matmul_cuda, W4.w4a16_matmul_plain,
                qt, x, False, "")
        del qt
    return rows


# path 6's and path 7's GEMMs: zamba2-7b's Mamba2 projections (in_dt
# 3584 -> 112 and in_bc 3584 -> 128, the narrowest outputs K1 takes on a
# path; in_z / in_x 3584 -> 7168; out_proj 7168 -> 3584), the narrow outputs
# at Ci 7168 too, and rwkv6-7b's channel mix (4096 <-> 14336)
SSM_WIDTHS = ((3584, 112), (3584, 128), (3584, 7168), (7168, 3584),
              (7168, 112), (7168, 128), (4096, 14336), (14336, 4096))


def check_k1_ssm():
    """K1 at paths 6 and 7's widths, T=4 (decode) and 256 (a prefill
    chunk), G=128, f32 X (bf16 X too at the narrow outputs)."""
    print("K1 at the SSM paths' widths (Co 112 / 128: narrower than one "
          "tile)")
    rows = {}
    for ci, co in SSM_WIDTHS:
        gen = torch.Generator(device=DEV).manual_seed(ci + co + 7)
        w = torch.randn(ci, co, generator=gen, device=DEV) * ci ** -0.5
        for dt in ((torch.float32, torch.bfloat16) if co <= 128
                   else (torch.float32,)):
            qt = quantize(w, group_size=128, dtype=dt)
            for t in (4, 256):
                x = torch.randn(t, ci, generator=gen, device=DEV).to(dt)
                rows[(t, ci, co, dt)] = _gemm_case(
                    "w4a16_matmul", W4.w4a16_matmul_cuda,
                    W4.w4a16_matmul_plain, qt, x, False, "")
        del w
    return rows


# path 8's GEMMs: whisper-medium's attention projections (1024 -> 1024) and
# its GELU MLP (1024 -> 4096 -> 1024), at decode (T=4) and over one encode's
# 1500 frames, the most rows K1 takes on a path
WHISPER_WIDTHS = ((1024, 1024), (1024, 4096), (4096, 1024))


def check_k1_whisper():
    """K1 at path 8's widths, T=4 (a decode step) and 1500 (an encode),
    G=128, f32 X."""
    print("K1 at path 8's widths (whisper-medium; T=1500: one encode)")
    rows = {}
    for ci, co in WHISPER_WIDTHS:
        gen = torch.Generator(device=DEV).manual_seed(ci + co + 8)
        w = torch.randn(ci, co, generator=gen, device=DEV) * ci ** -0.5
        qt = quantize(w, group_size=128)
        del w
        for t in (4, ENC_FRAMES):
            x = torch.randn(t, ci, generator=gen, device=DEV)
            rows[(t, ci, co)] = _gemm_case(
                "w4a16_matmul", W4.w4a16_matmul_cuda, W4.w4a16_matmul_plain,
                qt, x, False, "")
    return rows


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
    ("path 3", 4, 8, 2, 64, [216, 150, 90, 33], torch.float32)] + [
    # path 5's (Hkv, grp): llama3.2-3b, qwen2-vl-7b, starcoder2-15b,
    # chatglm3-6b, mistral-large-123b; path 1's lengths
    (f"path 5, Hkv={hkv} grp={grp}", 4, hkv, grp, 128, [216, 150, 90, 33],
     kind) for hkv, grp in ((8, 3), (4, 7), (4, 12), (2, 16), (8, 12))
    for kind in (torch.float32, torch.bfloat16)] + [
    # path 6: zamba2-7b's shared attention, 32 heads of 112, grp 1
    ("path 6, Dh=112", 4, 32, 1, 112, [216, 150, 90, 33], kind)
    for kind in (torch.float32, torch.bfloat16, torch.int8)] + [
    # path 8: whisper-medium's decoder self-attention, 16 heads of 64, grp 1
    ("path 8, Hkv=16 Dh=64", 4, 16, 1, 64, [216, 150, 90, 33], kind)
    for kind in (torch.float32, torch.bfloat16)]


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
    for kind in (torch.float32, torch.int8)] + [
    # path 5's (Hkv, grp) at path 1's chunk shape
    (f"path 5, Hkv={hkv} grp={grp}", 2, 256, hkv, grp, 128, [0, 0],
     [256, 200], kind, kind)
    for hkv, grp in ((8, 3), (4, 7), (4, 12), (2, 16), (8, 12))
    for kind in (torch.float32, torch.bfloat16)] + [
    # path 6: zamba2-7b's shared attention (Dh=112), a fresh chunk and one
    # behind a prefix
    (f"path 6, Dh=112", 2, 256, 32, 1, 112, prefix, [256, 200], kind, sdt)
    for prefix in ([0, 0], [128, 64])
    for kind, sdt in ((torch.float32, torch.float32),
                      (torch.bfloat16, torch.bfloat16),
                      (torch.int8, torch.float32))] + [
    # path 8: whisper-medium's decoder, 16 heads of 64, grp 1, a fresh chunk
    ("path 8, Hkv=16 Dh=64", 2, 256, 16, 1, 64, [0, 0], [256, 200], kind,
     kind) for kind in (torch.float32, torch.bfloat16)]


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
            else (tag, kind, sum(prefix) > 0)
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


def check_mla_long():
    """C.3: B9 behind a 2048- and an 8192-token prefix and B8 at 65,536
    positions (32 splits of 2048 keys), 128 heads, q scaled by 4, f32, bf16
    and int8 latent pools (uniform codes, and rows written as the engine
    writes them): ``launch/mla_shares.py``'s cases.  Peaked scores put the
    plain version's own f32 rounding near the tolerance (its share against
    float64 is printed beside), so each kernel is held to a float64
    evaluation of the same attention: error <= 1e-5 * max(1, max |ref|)."""
    from repro_torch.launch import mla_shares as MS

    kinds = [(k, s, r) for k, s, r in MS.KINDS
             if s == torch.float32 or k == torch.bfloat16]
    cases = [("B9", pfx, seed, kind, sdt, rows)
             for pfx, seed in ((2048, 5), (8192, 11))
             for kind, sdt, rows in kinds]
    cases += [("B8", 65536, 3, kind, None, rows)
              for kind, _, rows in kinds]
    out = []
    for name, n, seed, kind, sdt, rows in cases:
        if name == "B9":
            sh = MS.b9_share(n, seed, kind, sdt, rows, DEV)
            label = (f"B9 prefix {n} + chunk {MS.T}, "
                     f"{MS.pools_label(kind, rows)} pools, {str(sdt)[6:]} "
                     "suffix")
        else:
            sh = MS.b8_share(n, seed, kind, rows, DEV)
            label = f"B8 one slot at {n}, {MS.pools_label(kind, rows)} pools"
        print(f"  {label}, q x4: {MS.shares_text(sh)}", flush=True)
        require(sh[1] <= 1.0, f"{label}: error past the tolerance")
        out.append(dict(case=label, kernel_vs_plain=sh[0],
                        kernel_vs_float64=sh[1], plain_vs_float64=sh[2]))
    RESULTS["mla_long"] = out
    gc.collect()
    torch.cuda.empty_cache()


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


def _graph_fixed(graph):
    """The fixed-rows state a hybrid decode graph's step holds (None for an
    attention stack's)."""
    return graph.step.keywords["fixed"]


def _eager_step(graph, fixed_before=None):
    """The decode graph's step once more, eagerly, on the inputs of the
    replay just issued (still in the graph's static tensors): it writes the
    pools the rows the replay wrote, bit for bit (:func:`graph_vs_eager`),
    and its launches are taken back from the counters.  A hybrid step's
    recurrence is not idempotent: it reruns from ``fixed_before`` (the state
    before the replay) and must land on the replay's state bit for bit."""
    fixed = _graph_fixed(graph)
    if fixed is not None:
        after_replay = {k: v.clone() for k, v in fixed.items()}
        for k, v in fixed.items():
            v.copy_(fixed_before[k])
    before = K.launch_counts()
    with torch.no_grad():
        graph.step(*graph.inputs)
    after = K.launch_counts()
    K.add_launch_counts({n: before[n] - after[n] for n in after})
    if fixed is not None:
        require(all(torch.equal(fixed[k], after_replay[k]) for k in fixed),
                "the eager decode step's fixed rows differ from the graph "
                "replay's")


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
        # warm-up and capture run every row inactive: the state they leave
        # is the state before the replay
        fixed = _graph_fixed(graph)
        before = (None if fixed is None
                  else {k: v.clone() for k, v in fixed.items()})
        keep[0] = False
        try:
            logits = replay(graph, *inputs)
        finally:
            keep[0] = True
        _eager_step(graph, before)
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
    the copy's.  A hybrid engine's step parks its first decoding slot
    (``active`` False): the fixed rows the replay wrote must equal the
    eager step's bit for bit, the parked slot's must be unchanged, and the
    state before the replay is restored afterwards (the engine has not
    advanced, and a recurrence, unlike a KV write, is not idempotent).  An
    encoder-decoder's step reads the same encoder pool in both (it is
    read-only) with the rows' encoder tables and valid rows; the pool must
    come out of the replay bitwise unchanged."""
    from repro_torch.models import api

    dec = [i for i in eng._active_slots()
           if eng.pos[i] >= eng.pref_target[i]]
    require(dec, f"{label}: no decoding slot for the graph check")
    fixed, enc_before = None, None
    if eng.has_fixed:
        require(len(dec) >= 2, f"{label}: the hybrid graph check needs two "
                "decoding slots")
        parked, dec = dec[0], dec[1:]
        fixed = {k: t.clone() for k, t in eng.fixed.items()}
    if eng.has_enc and len(dec) >= 2:
        # an idle row reads the trash page with 0 encoder rows (clamped to
        # one masked zero row): its logits must stay finite
        dec = dec[1:]
    inputs = eng._decode_inputs(dec)
    tok, pos, tbl = inputs[:3]
    extra = {n: eng._tensor(a, torch.bool if a.dtype == bool else torch.int32)
             for n, a in zip(eng.step_extra, inputs[3:], strict=True)}
    if fixed is not None:
        extra["fixed"] = fixed
    if eng.has_enc:
        enc_before = {k: t.clone() for k, t in eng.pools["enc"].items()}
    pools = {"layers": [{k: t.clone() for k, t in lp.items()}
                        for lp in eng.pools["layers"]]}
    if eng.has_enc:
        pools["enc"] = eng.pools["enc"]
    with torch.no_grad():
        eager = api.decode_paged_fn(
            eng.params, {"token": eng._tensor(tok),
                         "position": eng._tensor(pos)},
            pools, eng._tensor(tbl), eng.cfg, **extra)[0]
    before = None if fixed is None else {k: t.clone()
                                         for k, t in eng.fixed.items()}
    graph = eng.decode_graph(*inputs)
    torch.cuda.synchronize()
    same = torch.equal(graph, eager)
    pools_same = all(torch.equal(lp[k], lc[k]) for lp, lc in
                     zip(eng.pools["layers"], pools["layers"]) for k in lp)
    out = dict(graph_logits_bitwise_equal=same,
               graph_pools_bitwise_equal=pools_same)
    msg = ""
    if enc_before is not None:
        out["graph_logits_finite"] = bool(torch.isfinite(graph).all())
        out["graph_enc_pool_unchanged"] = all(
            torch.equal(eng.pools["enc"][k], t)
            for k, t in enc_before.items())
        msg = (f", encoder pool unchanged {out['graph_enc_pool_unchanged']}"
               f" ({len(eng._active_slots()) - len(dec)} rows idle)")
    if fixed is not None:
        out["graph_fixed_bitwise_equal"] = all(
            torch.equal(eng.fixed[k], fixed[k]) for k in fixed)
        out["parked_rows_unchanged"] = all(
            torch.equal(eng.fixed[k][:, parked], before[k][:, parked])
            for k in fixed)
        out["active_rows_changed"] = all(
            not torch.equal(eng.fixed[k][:, dec], before[k][:, dec])
            for k in fixed)
        for k, t in eng.fixed.items():
            t.copy_(before[k])
        msg = (f", fixed rows bitwise equal {out['graph_fixed_bitwise_equal']}"
               f", parked slot {parked}'s rows unchanged "
               f"{out['parked_rows_unchanged']}, the decoding rows' changed "
               f"{out['active_rows_changed']}")
    print(f"  {label}: graph replay vs an eager step on a copy of the pools "
          f"({len(dec)} decoding rows): logits bitwise equal {same} (max "
          f"|diff| {max_err(graph, eager):.3g}), pools bitwise equal "
          f"{pools_same}{msg}")
    require(all(out.values()), f"{label}: the decode graph differs from "
            "the eager step")
    del pools, fixed, before, enc_before
    return out


class _EncWindow:
    """An encoder-decoder engine's encoder pool over a window of engine
    steps: a copy of the pool at the start, and the pages each admission
    that encodes writes (``ServingEngine._admit_enc`` wrapped on the
    instance).  At :meth:`close` every page no such admission wrote must be
    bitwise unchanged: decode steps, graph replays and prefill chunks only
    read the pool.  ``frames`` are the window's requests' audio: how many of
    them are fully cached at the start is printed beside the window's
    encodes (an admission's fresh encoder pages are charged before its
    lookup, so a batch of admissions can evict audio that was cached)."""

    def __init__(self, eng, frames):
        self.eng = eng
        npg = eng.pager.pages_needed(len(frames[0]))
        self.cached = sum(
            all(h in eng.enc_cache._index
                for h in eng.enc_cache.data_hashes(f, npg)) for f in frames)
        self.free = eng.pager.free_pages
        self.pool = {k: t.clone() for k, t in eng.pools["enc"].items()}
        self.encodes, self.hits = eng.stats.enc_encodes, eng.stats.enc_hits
        self.written = set()
        admit = eng._admit_enc

        def recording(slot, req):
            n = eng.stats.enc_encodes
            admit(slot, req)
            if eng.stats.enc_encodes > n:
                self.written.update(eng.pager.slot_pages(slot, "enc"))
        eng._admit_enc = recording

    def close(self, label):
        eng = self.eng
        del eng._admit_enc
        changed = None
        for k, t in eng.pools["enc"].items():
            for layer, before in zip(t, self.pool[k]):
                c = (layer != before).flatten(1).any(1)
                changed = c if changed is None else changed | c
        changed = set(changed.nonzero().flatten().tolist())
        out = dict(window_audio_cached=self.cached,
                   window_free_pages=self.free,
                   window_enc_encodes=eng.stats.enc_encodes - self.encodes,
                   window_enc_hits=eng.stats.enc_hits - self.hits,
                   window_enc_pages_written=len(self.written),
                   window_enc_pages_changed=len(changed))
        print(f"  {label}: {self.cached} of the window's audios fully cached "
              f"and {self.free} pages free at its start; over the window "
              f"{out['window_enc_encodes']} encodes and "
              f"{out['window_enc_hits']} exact-match hits; "
              f"{len(changed)} encoder pages changed, all among the "
              f"{len(self.written)} its encoding admissions wrote: "
              f"{changed <= self.written}", flush=True)
        require(changed <= self.written, f"{label}: an encoder page no "
                "admission wrote changed over the profile window")
        del self.pool
        return out


def profile_decode(eng, reqs, key, steps=8):
    """Where a decode step's time goes, after the counted run: the path's
    first four prompts again; engine steps run until all four have finished
    prefill, the decode graph is held against an eager step
    (:func:`graph_vs_eager`), then ``steps`` pure decode steps (batch 4,
    graph replays) run on the host clock alone, and ``steps`` more under
    torch.profiler (device time, and the host's busiest ops).  An
    encoder-decoder's encoder pool is held over the whole window
    (:class:`_EncWindow`)."""
    from repro_torch.serving.engine import Request

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    enc_window = (_EncWindow(eng, [r.frames for r in reqs[:4]])
                  if eng.has_enc else None)
    for r in reqs[:4]:
        eng.submit(Request(uid=100 + r.uid, prompt=r.prompt,
                           max_tokens=2 * steps + 8, frames=r.frames))
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
    if enc_window is not None:
        checked.update(enc_window.close(key))
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
                          "--max-prompt", "200", "--seed", "0",
                          *SERVE_COLD])
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
    print("path 10a: path 1's whole-step roofline (op_cost on meta copies of "
          "its decode step and a B=2, T=256 prefill chunk; H100 SXM "
          "constants)", flush=True)
    path10a(eng)
    path1b(eng.params, cfg, reqs, outputs)
    path1c(eng.params, res["report"], cfg, outputs, res["ptq_s"])
    waves, cold_outputs = path1d(eng.params, cfg)
    path1e(eng.params, cfg, waves, cold_outputs)
    metrics_overhead(eng.params, cfg, waves[0])
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
    pred = path1_prediction(st, nl)
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


def path1c(params, report, cfg, outputs, ptq_s):
    """Path 1's quantized codellama-7b (still on the card) saved as a PTQ
    artifact with the config serve built, then path 1 served again through
    the serve entry with ``--ptq-artifact``: the boot must load it (no
    calibration batch, no α search), the loaded params must equal path 1's
    bitwise, the outputs path 1's token for token, and the launch counts
    path 1's prediction for this run's steps and chunks.  The artifact is
    deleted afterwards."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import apply as AP
    from repro_torch.launch import serve

    print("path 1c: path 1's quantized params saved as a PTQ artifact, path "
          "1 served again booting from it", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="ptq_artifact_"))
    try:
        d = tmp / "codellama-7b"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        AP.save_ptq(d, params, report, cfg, QuantConfig(group_size=128))
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in d.iterdir())
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        res = serve.main(["--arch", "codellama-7b", "--requests", "8",
                          "--batch-size", "4", "--max-seq", "256",
                          "--max-tokens", "16", "--min-prompt", "32",
                          "--max-prompt", "200", "--seed", "0",
                          "--ptq-artifact", str(d), *SERVE_COLD])
        torch.cuda.synchronize()
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    eng, reqs = res["engine"], res["requests"]
    st = eng.stats
    nl = cfg.num_layers
    pred = path1_prediction(st, nl)
    same = sum(list(r.output) == o for r, o in zip(reqs, outputs))
    print(f"  artifact {nbytes / 1e9:.3f} GB on disk, saved in {save_s:.1f}s; "
          f"boot [{res['ptq_mode']}] in {res['ptq_s']:.1f}s (path 1's PTQ "
          f"{ptq_s:.1f}s), {res['calib_batches']} calibration batches; "
          f"launches {counts}; predicted {pred}; outputs equal to path 1's "
          f"for {same}/{len(reqs)} requests; peak memory "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    require(res["ptq_mode"] == "artifact-load",
            "path 1c: the boot did not load the artifact")
    require(res["calib_batches"] == 0, "path 1c: the boot calibrated")
    require(res["ptq_artifact_bytes"] == nbytes,
            "path 1c: serve reports another artifact size")
    rep = res["report"]
    require((rep.alpha, rep.quantized_paths, rep.a8_eligibility)
            == (report.alpha, report.quantized_paths, report.a8_eligibility),
            "path 1c: the loaded report differs from path 1's")
    require(_same_params(eng.params, params),
            "path 1c: the loaded params differ from path 1's")
    require(counts == pred, "path 1c: launch counts differ from the "
            "prediction")
    require(same == len(reqs), "path 1c: outputs differ from path 1's")
    RESULTS["path1c"] = dict(
        artifact_bytes=nbytes, save_s=save_s, load_s=res["ptq_s"],
        path1_ptq_s=ptq_s, calib_batches=res["calib_batches"],
        launches=counts, predicted=pred, decode_steps=st.steps,
        prefill_batches=st.prefill_batches, peak_mem_bytes=peak,
        same_outputs_as_path1=same)


def path1_prediction(st, nl):
    """Path 1's launches for an engine's stats: K1 for 7 linears of every
    layer on every decode step and prefill batch, K2 once a layer a step,
    K3 once a layer a batch, nothing else."""
    pred = {n: 0 for n in K.WRAPPERS}
    pred.update({"w4a16_matmul": 7 * nl * (st.steps + st.prefill_batches),
                 "gqa_paged_decode": nl * st.steps,
                 "gqa_paged_prefill": nl * st.prefill_batches})
    return pred


def path4_prediction(st, nl, sfx=""):
    """Path 4's launches, per layer and call: K1 for wq_a, wq_b, wkv_a, wo
    and the shared expert's gate/up/down (wkv_b itself is never read to
    serve); B6 for the routed experts' gate/up/down and the absorbed wk_t /
    wv; B8 once a decode step, B9 once a prefill batch (``sfx`` "_int8"
    for int8 latent pools)."""
    calls = st.steps + st.prefill_batches
    pred = {n: 0 for n in K.WRAPPERS}
    pred.update({"w4a16_matmul": 7 * nl * calls,
                 "w4a16_grouped": 5 * nl * calls,
                 "mla_paged_decode" + sfx: nl * st.steps,
                 "mla_paged_prefill" + sfx: nl * st.prefill_batches})
    return pred


# ------------------------------------------------- prefix cache, lifecycle ---
# EngineStats fields a wave of requests adds to (path 1d, path 4c)
WAVE_STATS = ("prefix_hits", "prefix_matched_tokens", "pages_shared",
              "pages_inserted", "pages_evicted", "cow_copies",
              "prefilled_tokens", "steps", "prefill_batches",
              "decoded_tokens")


def prefix_waves(vocab, sys_len, page, seed, n=4):
    """Two waves of ``n`` prompts behind one ``sys_len``-token system prompt,
    each with a suffix of 16-100 tokens; the first prompt of wave 1 has a
    suffix of exactly one page (a page-aligned prompt), and wave 2 opens
    with that same prompt: a full match, which takes a copy-on-write and
    prefills one token behind the cached rest."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(2, vocab, sys_len).astype(np.int32)

    def prompt(k):
        return np.concatenate([sys_p, rng.integers(2, vocab, k).astype(
            np.int32)])

    suf1 = [page] + [int(k) for k in rng.integers(16, 101, n - 1)]
    w1 = [prompt(k) for k in suf1]
    suf2 = [int(k) for k in rng.integers(16, 101, n - 1)]
    w2 = [w1[0].copy()] + [prompt(k) for k in suf2]
    return w1, w2


def run_waves(eng, waves, max_tokens=16):
    """Serve ``waves`` one after another, each drained before the next.
    Per wave: its requests, the engine stats it added, its host seconds,
    and its TTFT from the engine's ``ttft_s`` histogram: wave 1 from
    ``metrics_snapshot()`` (p50 and max), later waves from the histogram's
    delta over the wave (p50 and p100 as bucket upper bounds, at most 21%
    above the observation), with the exact TTFTs of the request stamps
    beside."""
    from repro_torch.serving.engine import Request

    hist = eng.metrics.histogram("ttft_s")
    out, uid = [], 0
    for w, prompts in enumerate(waves):
        before = {k: getattr(eng.stats, k) for k in WAVE_STATS}
        h0 = hist.counts()
        reqs = [Request(uid=uid + i, prompt=p, max_tokens=max_tokens)
                for i, p in enumerate(prompts)]
        uid += len(reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        if w == 0:
            lat = eng.metrics_snapshot()["latency"]["ttft_s"]
            p50, top = lat["p50"], lat["max"]
        else:
            d = hist.counts() - h0
            p50, top = d.percentile(0.5), d.percentile(1.0)
        out.append(dict(
            reqs=reqs, serve_s=serve_s, ttft_p50_s=p50, ttft_max_s=top,
            ttft_s=sorted(r.first_token_t - r.arrival_t for r in reqs),
            **{k: getattr(eng.stats, k) - before[k] for k in WAVE_STATS}))
    return out


def _wave_line(label, waves):
    return "; ".join(
        f"{label} wave {i + 1}: TTFT p50 {w['ttft_p50_s'] * 1e3:.1f} ms max "
        f"{w['ttft_max_s'] * 1e3:.1f} ms (request stamps "
        f"{', '.join(f'{t * 1e3:.1f}' for t in w['ttft_s'])} ms), "
        f"{w['prefilled_tokens']} prefilled, {w['prefix_hits']} hits, "
        f"{w['prefix_matched_tokens']} cached tokens, {w['cow_copies']} COW"
        for i, w in enumerate(waves))


def _cold_warm(params, cfg, waves, sys_len, label, pred_fn, *,
               same_tokens=True, **kw):
    """The same waves on a cache-off engine, then on a cache-on one whose
    kernel operands are kept and held against the plain versions; both held
    to the launch prediction ``pred_fn(stats)`` and to one decode graph.
    Wave 2 of the warm run must hit on every admission, match at least
    ``sys_len`` tokens each and take a COW, and with ``same_tokens`` the
    warm tokens must equal the cold ones (else their agreement is printed).
    Returns (cold waves, warm waves, warm launches, operand rows, warm
    graph check, requests with equal tokens)."""
    from repro_torch.serving.engine import ServingEngine

    runs = []
    for cache in (False, True):
        eng = ServingEngine(params, cfg, batch_size=4, max_seq=256,
                            page_size=16, prefix_cache=cache, seed=0,
                            device=DEV, **kw)
        torch.cuda.synchronize()
        with (path_operands() if cache and same_tokens
              else contextlib.nullcontext({})) as seen:
            K.reset_launch_counts()
            res = run_waves(eng, waves)
            torch.cuda.synchronize()
            counts = K.launch_counts()
        pred = pred_fn(eng.stats)
        tag = f"{label} {'warm' if cache else 'cold'}"
        print(f"  {tag}: launches {counts}; predicted {pred}; decode steps "
              f"{eng.stats.steps}, prefill batches "
              f"{eng.stats.prefill_batches}", flush=True)
        require(counts == pred, f"{tag}: launch counts differ from the "
                "prediction")
        require(all(r.finish_reason in ("completed", "length")
                    for w in res for r in w["reqs"]),
                f"{tag}: a request did not finish")
        eng.pager.check_invariants()
        graph = check_decode_graph(eng, tag)
        if cache:
            runs.append((res, eng, counts, seen, graph))
        else:
            runs.append((res,))
            del eng
            gc.collect()
    (cold,), (warm, eng, counts, seen, graph) = runs
    print("  " + _wave_line("cold", cold))
    print("  " + _wave_line("warm", warm), flush=True)
    operands = check_path_operands(seen, label) if seen else []
    del eng, seen
    gc.collect()
    pairs = [(rw, rc) for ww, wc in zip(warm, cold)
             for rw, rc in zip(ww["reqs"], wc["reqs"])]
    differ = [(rw.uid, next(i for i, (a, b) in enumerate(
        zip(rw.output + [-1], rc.output + [-2])) if a != b))
        for rw, rc in pairs if rw.output != rc.output]
    print(f"  {label}: warm tokens equal to cold for "
          f"{len(pairs) - len(differ)}/{len(pairs)} requests"
          + (f"; (uid, first differing token) {differ}" if differ else ""))
    w2 = warm[1]
    require(not differ or not same_tokens,
            f"{label}: the cache-on tokens differ from the cache-off run's")
    require(w2["prefix_hits"] == len(w2["reqs"]),
            f"{label}: wave 2 did not hit the cache on every admission")
    require(w2["prefix_matched_tokens"] >= len(w2["reqs"]) * sys_len,
            f"{label}: wave 2 matched too few tokens")
    require(w2["cow_copies"] >= 1, f"{label}: no copy-on-write")
    require(sum(w["prefilled_tokens"] for w in warm)
            < sum(w["prefilled_tokens"] for w in cold),
            f"{label}: the cache prefilled no fewer tokens")
    return cold, warm, counts, operands, graph, len(pairs) - len(differ)


def _waves_result(waves):
    return [{k: v for k, v in w.items() if k != "reqs"} for w in waves]


def path1d(params, cfg):
    """Path 1's params with the prefix cache: 8 requests in two waves of 4,
    each prompt a 96-token system prompt (6 pages) + a 16-100-token suffix;
    wave 2 opens with wave 1's 112-token page-aligned prompt (a COW and a
    one-token K3 chunk behind 111 cached tokens).  The tokens equal a
    cache-off run of the same waves; wave 2 hits on all 4 admissions."""
    print("path 1d: path 1's params, prefix cache on: two waves of 4 behind "
          "a 96-token system prompt, cold then warm", flush=True)
    nl = cfg.num_layers

    waves = prefix_waves(cfg.vocab_size, 96, 16, seed=1)
    cold, warm, counts, operands, graph, _ = _cold_warm(
        params, cfg, waves, 96, "path 1d",
        lambda st: path1_prediction(st, nl))
    RESULTS["path1d"] = dict(
        cold=_waves_result(cold), warm=_waves_result(warm), launches=counts,
        path_operands=operands, **graph)
    return waves, [r.output for w in cold for r in w["reqs"]]


def path1e(params, cfg, waves, cold_outputs):
    """Path 1's params under serve's ``--chaos`` plan (seed 0), non-strict,
    prefix cache on, path 1d's 8 requests at once from 90 four-token pages:
    ``max_queue=7`` rejects the eighth, request 6 carries
    ``ttft_deadline_s=0`` and request 1 is cancelled once it has decoded 4
    tokens.  Every request ends terminal, the fault counters reconcile with
    the plan, the pager ends with nothing referenced or held (cached pages
    only), the decode graph replays again after the ``decode_launch``
    fault, and every request no fault, deadline or cancel touched has path
    1d's cache-off tokens.  The Chrome trace goes to a temporary file."""
    from repro_torch.launch.serve import chaos_plan
    from repro_torch.serving.engine import (FINISH_REASONS, Request,
                                            ServingEngine)
    from repro_torch.serving.trace import write_chrome_trace

    print("path 1e: path 1's params, --chaos plan (seed 0), strict=False, "
          "prefix cache on, page size 4, 90 pages, max_queue=7, a cancel "
          "and a TTFT deadline", flush=True)
    plan = chaos_plan(0)
    eng = ServingEngine(params, cfg, batch_size=4, max_seq=256, page_size=4,
                        num_pages=90, prefix_cache=True, strict=False,
                        fault_plan=plan, max_queue=7, seed=0, device=DEV)
    reqs = [Request(uid=i, prompt=p, max_tokens=16,
                    ttft_deadline_s=0.0 if i == 6 else None)
            for i, p in enumerate(waves[0] + waves[1])]
    g = eng.decode_graph
    torch.cuda.synchronize()
    with path_operands() as seen:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        accepted = [eng.submit(r) for r in reqs]
        cancel_step, fault_step, replays_after = None, None, 0
        while eng.queue or any(s is not None for s in eng.slots):
            r0 = g.replays
            eng.step()
            if any(site == "decode_launch" and s == eng._step_idx
                   for s, site, _ in plan.log):
                fault_step = eng._step_idx
            elif fault_step is not None and g.replays > r0:
                replays_after += 1
            if cancel_step is None:
                for i, r in enumerate(eng.slots):
                    if (r is not None and r.uid == 1 and len(r.output) >= 4
                            and eng.pos[i] >= eng.pref_target[i]):
                        require(eng.cancel(1), "path 1e: cancel refused")
                        cancel_step = eng._step_idx
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = K.launch_counts()
    st = eng.stats
    nl = cfg.num_layers
    pred = path1_prediction(st, nl)
    ctr = eng.metrics.counter("faults_fired_total")
    fired = ctr.snapshot()
    untouched = [r for r in reqs if r.finish_reason in ("completed", "length")
                 and not r.retries and not r.reprefills]
    same = sum(r.output == cold_outputs[r.uid] for r in untouched)
    same_all = sum(r.output == cold_outputs[r.uid] for r in reqs
                   if r.finish_reason in ("completed", "length"))
    tmp = Path(tempfile.mkdtemp(prefix="chaos_trace_"))
    try:
        obj = write_chrome_trace(str(tmp / "trace.json"), eng.trace,
                                 n_slots=eng.B)
        trace_bytes = (tmp / "trace.json").stat().st_size
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_events = len(obj["traceEvents"])
    states = [(r.uid, r.finish_reason, len(r.output), r.retries,
               r.reprefills) for r in reqs]
    print(f"  launches {counts}; predicted {pred}; decode steps {st.steps}, "
          f"prefill batches {st.prefill_batches}, engine steps "
          f"{eng._step_idx}; served in {serve_s:.2f}s", flush=True)
    print(f"  terminal states (uid, reason, tokens, retries, re-prefills): "
          f"{states}")
    print(f"  fault counters {fired}; plan injected {plan.total_injected} "
          f"{ {k: v for k, v in plan.injected.items() if v} }, pressure "
          f"polls {plan.pressure_hits}; log {plan.log}")
    print(f"  {st.preemptions} preemptions, {st.resumes} resumes, "
          f"{st.retries} retries, {st.expired} expired, {st.cancelled} "
          f"cancelled (step {cancel_step}), {st.rejected} rejected, "
          f"{st.failed} failed; {st.prefix_hits} cache hits, "
          f"{st.cow_copies} COW, {st.pages_evicted} evicted; decode_launch "
          f"fault at step {fault_step}, {replays_after} replays after it; "
          f"untouched requests with path 1d's cold tokens {same}/"
          f"{len(untouched)} (all finished: {same_all}); Chrome trace "
          f"{n_events} events, {trace_bytes} bytes", flush=True)
    require(accepted == [True] * 7 + [False],
            "path 1e: max_queue did not reject exactly the eighth request")
    require(all(r.finish_reason in FINISH_REASONS for r in reqs),
            "path 1e: a request is not terminal")
    require((reqs[1].finish_reason, reqs[6].finish_reason,
             reqs[7].finish_reason) == ("cancelled", "deadline", "rejected"),
            "path 1e: cancel / deadline / rejection did not land")
    require(ctr.total() == plan.total_injected == st.faults_injected
            and all(ctr.value(site=s) == n for s, n in plan.injected.items()),
            "path 1e: fault counters do not reconcile with the plan")
    eng.pager.check_invariants()
    require(int(eng.pager.refs().sum()) == 0
            and int(eng.pager.held().sum()) == 0
            and eng.pager.free_pages + eng.pager.evictable_pages()
            == eng.pager.num_pages - 1 and not eng._swapped,
            "path 1e: pages left referenced or held after the drain")
    require(st.preemptions >= 2, "path 1e: fewer than two preemptions")
    require(plan.injected["decode_launch"] >= 1 and replays_after > 0,
            "path 1e: no decode replay after a decode_launch fault")
    require(untouched and same == len(untouched),
            "path 1e: an untouched request's tokens differ from path 1d's")
    require(counts == pred, "path 1e: launch counts differ from the "
            "prediction")
    RESULTS["path1e"] = dict(
        launches=counts, predicted=pred, states=states, fault_counters=fired,
        injected=plan.total_injected, fault_log=plan.log,
        preemptions=st.preemptions, resumes=st.resumes, retries=st.retries,
        decode_fault_step=fault_step, replays_after_fault=replays_after,
        untouched=len(untouched), untouched_same=same, serve_s=serve_s,
        trace_events=n_events, trace_bytes=trace_bytes,
        path_operands=check_path_operands(seen, "path 1e"),
        **check_decode_graph(eng, "path 1e"))
    del eng, seen
    gc.collect()


def metrics_overhead(params, cfg, prompts, steps=16):
    """The decode wall per step with the engine's recording on and off: two
    engines over path 1's params (batch 4, the same 4 prompts, 64 new
    tokens), both decoding all 4 slots, timed in windows of ``steps``
    steps in turns on, off, off, on (host clock, synchronised); then both
    drain, and their tokens must be equal."""
    from repro_torch.serving.engine import Request, ServingEngine

    print("metrics overhead: decode wall per step, metrics on vs off, path "
          "1's params, batch 4", flush=True)
    engs, reqs = {}, {}
    for on in (True, False):
        eng = ServingEngine(params, cfg, batch_size=4, max_seq=256,
                            page_size=16, metrics=on, seed=0, device=DEV)
        reqs[on] = [Request(uid=i, prompt=p, max_tokens=4 * steps + 8)
                    for i, p in enumerate(prompts)]
        for r in reqs[on]:
            eng.submit(r)
        while (eng.queue or any(r is None or eng.pos[i] < eng.pref_target[i]
                                for i, r in enumerate(eng.slots))):
            eng.step()
        engs[on] = eng
    walls = {True: [], False: []}
    for on in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engs[on].step()
        torch.cuda.synchronize()
        walls[on].append((time.perf_counter() - t0) / steps)
    for on in (True, False):
        engs[on].run_until_drained()
    same = [r.output for r in reqs[True]] == [r.output for r in reqs[False]]
    on_ms = statistics.mean(walls[True]) * 1e3
    off_ms = statistics.mean(walls[False]) * 1e3
    print(f"  decode wall per step: metrics on {on_ms:.3f} ms "
          f"({', '.join(f'{w * 1e3:.3f}' for w in walls[True])}), off "
          f"{off_ms:.3f} ms ({', '.join(f'{w * 1e3:.3f}' for w in walls[False])}"
          f"); on/off {on_ms / off_ms:.4f}; tokens equal {same}", flush=True)
    require(same, "metrics on and off gave different tokens")
    RESULTS["metrics_overhead"] = dict(
        on_ms_per_step=on_ms, off_ms_per_step=off_ms,
        on_windows_s=walls[True], off_windows_s=walls[False],
        steps_per_window=steps, same_tokens=same)
    del engs
    gc.collect()


# ------------------------------------------------ path 5: dense decoders ---
# (arch, depth or None for the config's own): full depth where the f32
# model, PTQ's peak and the step check's dequantized copy fit in 80 GB
PATH5 = (("llama3.2-3b", None), ("chatglm3-6b", None), ("qwen2-vl-7b", None),
         ("starcoder2-15b", None), ("mistral-large-123b", 6))


def fill_biases(params, seed=0, sd=0.02):
    """Every bias and LayerNorm shift drawn in place from a seeded N(0, sd²)
    (``init_linear`` and ``init_norm`` zero them), so that the bias adds
    are live; returns how many tensors were filled."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    n = 0

    def walk(node):
        nonlocal n
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v)
            elif k in ("b", "bias"):
                v.copy_(torch.randn(v.shape, generator=gen, device=DEV) * sd)
                n += 1
    walk(params)
    return n


def path5_prediction(st, nl, n_linear):
    """A dense decoder's launches: K1 for each of its ``n_linear`` quantized
    linears (7 for SwiGLU, 6 for the GELU MLP) of every layer on every decode
    step and prefill batch, K2 once a layer a step, K3 once a layer a
    batch, nothing else."""
    pred = {n: 0 for n in K.WRAPPERS}
    pred.update({"w4a16_matmul": n_linear * nl * (st.steps
                                                   + st.prefill_batches),
                 "gqa_paged_decode": nl * st.steps,
                 "gqa_paged_prefill": nl * st.prefill_batches})
    return pred


def _path5_serve(arch):
    """One model through the serve entry, as path 1."""
    from repro_torch.launch import serve

    with path_operands() as seen:
        K.reset_launch_counts()
        res = serve.main(["--arch", arch, "--requests", "8",
                          "--batch-size", "4", "--max-seq", "256",
                          "--max-tokens", "16", "--min-prompt", "32",
                          "--max-prompt", "200", "--seed", "0",
                          *SERVE_COLD])
        torch.cuda.synchronize()
        counts = K.launch_counts()
    return (res["engine"], res["requests"], res["report"], counts, seen,
            dict(ptq_s=res["ptq_s"], serve_s=res["serve_s"],
                 ttft_s=sorted(res["ttft_s"]), biases_filled=0))


def _path5_library(arch, depth):
    """One model through the library entry points, as path 4: every bias
    and LayerNorm shift filled before PTQ, then path 1's requests."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.calibration import synthetic_calibration_set
    from repro_torch.models import api
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            load_or_quantize)

    cfg = get_config(arch).with_(dtype="float32")
    if depth is not None:
        cfg = cfg.with_(num_layers=depth)
    params = api.init_model(cfg, seed=0, device=DEV)
    n_bias = fill_biases(params)
    calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, rep = load_or_quantize(params, cfg, calib,
                                   QuantConfig(group_size=128))
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    ptq_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 201, 8)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, int(n)
                                               ).astype(np.int32),
                    max_tokens=16) for i, n in enumerate(lens)]
    eng = ServingEngine(params, cfg, batch_size=4, max_seq=256, page_size=16,
                        seed=0, device=DEV)
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
    return (eng, reqs, rep, counts, seen,
            dict(ptq_s=ptq_s, serve_s=serve_s, ptq_peak_mem_bytes=ptq_peak,
                 ttft_s=sorted(r.first_token_t - r.arrival_t for r in reqs),
                 biases_filled=n_bias))


def _path5_model(arch, depth):
    from repro_torch.configs import get_config

    label = f"path 5 {arch}"
    torch.cuda.reset_peak_memory_stats()
    t_model = time.perf_counter()
    if arch == "chatglm3-6b":
        eng, reqs, rep, counts, seen, res = _path5_serve(arch)
    else:
        eng, reqs, rep, counts, seen, res = _path5_library(arch, depth)
    cfg, st = eng.cfg, eng.stats
    nl = cfg.num_layers
    pred = path5_prediction(st, nl, 6 if cfg.mlp == "gelu" else 7)
    cut = "" if depth is None else (
        f", reduced: num_layers {get_config(arch).num_layers} → {depth}")
    print(f"  {label} (d_model {cfg.d_model}, {cfg.num_heads} heads, "
          f"{cfg.num_kv_heads} KV heads (grp {cfg.num_heads // cfg.num_kv_heads}"
          f"), d_ff {cfg.d_ff}, rope {cfg.rope}, {cfg.norm}, {cfg.mlp}, "
          f"biases {cfg.attn_bias} ({res['biases_filled']} tensors filled), "
          f"{nl} layers{cut}): launches {counts}; predicted {pred}; decode "
          f"steps {st.steps}, prefill batches {st.prefill_batches}",
          flush=True)
    require(all(r.finish_reason in ("completed", "length") for r in reqs),
            f"{label}: a request did not finish")
    require(all(len(r.output) == r.max_tokens or r.finish_reason ==
                "completed" for r in reqs),
            f"{label}: a request stopped early without EOS")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            f"{label}: token out of range")
    require(counts == pred, f"{label}: launch counts differ from the "
            "prediction")
    tok_s = st.decoded_tokens / res["serve_s"]
    ttft = res["ttft_s"]
    completed = st.completed
    res.update(arch=arch, num_layers=nl, full_depth=depth is None,
               alpha=rep.alpha, launches=counts, predicted=pred,
               decode_steps=st.steps, prefill_batches=st.prefill_batches,
               decoded_tokens=st.decoded_tokens,
               prefilled_tokens=st.prefilled_tokens, decode_tok_s=tok_s,
               fp_bytes=rep.fp_bytes, quant_bytes=rep.quant_bytes,
               **check_decode_graph(eng, label))
    res["path_operands"] = check_path_operands(seen, label)
    del seen
    res.update(check_step_against_plain(eng.params, cfg, eng.PS,
                                        reqs[0].prompt))
    profile_decode(eng, reqs, f"path5_{arch}_profile")
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    res["model_s"] = time.perf_counter() - t_model
    print(f"  {label}: PTQ alpha={rep.alpha:.2f} in {res['ptq_s']:.1f}s "
          f"({rep.fp_bytes / 1e9:.2f} GB -> {rep.quant_bytes / 1e9:.2f} GB); "
          f"served {completed} requests in {res['serve_s']:.2f}s: "
          f"{tok_s:.1f} decode tok/s, TTFT p50 {statistics.median(ttft):.3f}s "
          f"max {ttft[-1]:.3f}s; peak memory "
          + (f"{res['ptq_peak_mem_bytes'] / 2 ** 30:.2f} GiB (PTQ), "
             if "ptq_peak_mem_bytes" in res else "")
          + f"{res['peak_mem_bytes'] / 2 ** 30:.2f} GiB (whole model); "
          f"{res['model_s']:.1f}s in all", flush=True)
    del eng
    return res


def path5():
    """The registry's other dense decoders at full width, served in f32 at
    G=128, A16, fp pools: llama3.2-3b, chatglm3-6b (through the serve
    entry), qwen2-vl-7b and starcoder2-15b at full depth,
    mistral-large-123b with its depth cut."""
    print("path 5: llama3.2-3b, chatglm3-6b, qwen2-vl-7b, starcoder2-15b, "
          "mistral-large-123b (6 of 88 layers) at full width, SmoothQuant+ "
          "W4A16 f32, fp pools, path 1's requests", flush=True)
    t0 = time.perf_counter()
    models = {}
    for arch, depth in PATH5:
        models[arch] = _path5_model(arch, depth)
        gc.collect()
        torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    print(f"path 5 took {took:.1f}s", flush=True)
    RESULTS["path5"] = dict(models=models, seconds=took)
    return {arch: m["launches"] for arch, m in models.items()}


# ----------------------------------------------------- paths 6, 6b and 7 ---
def path6_prediction(st, cfg):
    """zamba2-7b's launches: K1 for the 5 linears of each of its 81 Mamba2
    layers and the 7 of each of the 13 shared-block applications (496),
    on every decode step and prefill batch; K2 once an application a step,
    K3 once an application a batch; nothing else."""
    g = cfg.num_layers // cfg.hybrid.attn_every
    per = 5 * cfg.num_layers + 7 * g
    pred = {n: 0 for n in K.WRAPPERS}
    pred.update({"w4a16_matmul": per * (st.steps + st.prefill_batches),
                 "gqa_paged_decode": g * st.steps,
                 "gqa_paged_prefill": g * st.prefill_batches})
    return pred


def _state_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree.values())


@torch.no_grad()
def check_hybrid_step_against_plain(params, cfg, ps, prompt):
    """One hybrid prefill chunk of the whole prompt and one decode step,
    through the kernels, against the same steps on the dequantized weights
    with the dense-gather oracle (each over its own pools and fixed
    rows)."""
    plain_params = dequantized_params(params)
    plain_cfg = cfg.with_(paged_attn_impl="gather")
    logits = {}
    for name, prm, c in (("kernel", params, cfg),
                         ("plain", plain_params, plain_cfg)):
        pool, table = _fresh_pool(c, ps, len(prompt))
        fixed = LM.init_fixed_state(c, 1, DEV)
        toks = torch.as_tensor(prompt, dtype=torch.int32, device=DEV)[None]
        zero = torch.zeros(1, dtype=torch.int32, device=DEV)
        clen = torch.tensor([len(prompt)], dtype=torch.int32, device=DEV)
        pre, _, _ = LM.hybrid_prefill_chunk(
            prm, toks, pool, fixed, zero.long(), zero, clen, table, c)
        nxt = torch.tensor([[int(prompt[-1])]], dtype=torch.int32,
                           device=DEV)
        dec = LM.hybrid_decode_paged(
            prm, nxt, pool, fixed, clen, table,
            torch.ones(1, dtype=torch.bool, device=DEV), c)[0]
        logits[name] = (pre, dec)
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
    del plain_params
    return errs


def path6():
    """zamba2-7b at full width and depth through the serve entry: 81 Mamba2
    layers and 13 applications of the weight-shared attention + MLP block,
    random weights from seed 0, SmoothQuant+ in f32 (G=128, α searched),
    fp pools, path 1's 8 requests, batch 4; then path 6b."""
    from repro_torch.launch import serve
    from repro_torch.models import api

    print("path 6: zamba2-7b full width and depth (81 Mamba2 layers, 13 "
          "shared-attention applications), SmoothQuant+ W4A16 f32, fp "
          "pools, path 1's 8 requests", flush=True)
    t_path = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with path_operands() as seen:
        K.reset_launch_counts()
        res = serve.main(["--arch", "zamba2-7b", "--requests", "8",
                          "--batch-size", "4", "--max-seq", "256",
                          "--max-tokens", "16", "--min-prompt", "32",
                          "--max-prompt", "200", "--seed", "0",
                          *SERVE_COLD])
        torch.cuda.synchronize()
        counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    eng, reqs, cfg = res["engine"], res["requests"], res["cfg"]
    st = eng.stats
    pred = path6_prediction(st, cfg)
    fixed_slot = _state_bytes(api.init_fixed_state(cfg, 1, "meta"))
    print(f"  launches {counts}; predicted {pred}; decode steps {st.steps}, "
          f"prefill batches {st.prefill_batches}; fixed-rows state "
          f"{fixed_slot / 1e6:.1f} MB a slot", flush=True)
    require(all(r.finish_reason in ("completed", "length") for r in reqs),
            "path 6: a request did not finish")
    require(all(len(r.output) == 16 or r.finish_reason == "completed"
                for r in reqs), "path 6: a request stopped early without EOS")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            "path 6: token out of range")
    require(counts == pred, "path 6: launch counts differ from the "
            "prediction")
    tok_s = st.decoded_tokens / res["serve_s"]
    ttft = sorted(res["ttft_s"])
    rep = res["report"]
    print(f"  PTQ alpha={rep.alpha:.2f} in {res['ptq_s']:.1f}s "
          f"({rep.fp_bytes / 1e9:.2f} GB -> {rep.quant_bytes / 1e9:.2f} GB); "
          f"served {st.completed} requests in {res['serve_s']:.2f}s: "
          f"{tok_s:.1f} decode tok/s, TTFT p50 {statistics.median(ttft):.3f}s "
          f"max {ttft[-1]:.3f}s, peak memory {peak / 2 ** 30:.2f} GiB",
          flush=True)
    out = dict(launches=counts, predicted=pred, decode_steps=st.steps,
               prefill_batches=st.prefill_batches,
               decoded_tokens=st.decoded_tokens,
               prefilled_tokens=st.prefilled_tokens, serve_s=res["serve_s"],
               decode_tok_s=tok_s, ttft_s=ttft, ptq_s=res["ptq_s"],
               boot_s=res["boot_s"], alpha=rep.alpha,
               fp_bytes=rep.fp_bytes, quant_bytes=rep.quant_bytes,
               peak_mem_bytes=peak, fixed_bytes_per_slot=fixed_slot,
               **check_decode_graph(eng, "path 6"))
    out["path_operands"] = check_path_operands(seen, "path 6")
    del seen
    out.update(check_hybrid_step_against_plain(eng.params, cfg, eng.PS,
                                               reqs[0].prompt))
    outputs = [list(r.output) for r in reqs]
    profile_decode(eng, reqs, "path6_profile")
    out["path6b"] = path6b(eng.params, cfg, reqs, outputs, fixed_slot)
    out["seconds"] = time.perf_counter() - t_path
    print(f"path 6 took {out['seconds']:.1f}s", flush=True)
    RESULTS["path6"] = out
    return counts


def path6b(params, cfg, reqs, outputs, fixed_slot):
    """Path 6's quantized params, the same 8 requests, from 72 four-token
    pages: preemptions swap each victim's private KV rows and its fixed
    rows (its Mamba2 state, ``fixed_slot`` bytes) out through pinned host
    buffers, one CRC-32 over both, checked at swap-in; the outputs equal
    path 6's token for token."""
    from repro_torch.models import api
    from repro_torch.serving import engine as E

    print("path 6b: path 6's params, the same 8 requests, page size 4, 72 "
          "pages: preemption with the fixed-rows state in the swap image",
          flush=True)
    reqs = [E.Request(uid=r.uid, prompt=r.prompt, max_tokens=r.max_tokens)
            for r in reqs]
    eng = E.ServingEngine(params, cfg, batch_size=4, max_seq=256,
                          page_size=4, num_pages=72, seed=0, device=DEV)
    crc_calls = [0]
    crc = api.swap_image_checksum

    def counted(*a, **kw):
        crc_calls[0] += 1
        return crc(*a, **kw)

    api.swap_image_checksum = counted
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    finally:
        api.swap_image_checksum = crc
    counts = K.launch_counts()
    st = eng.stats
    pred = path6_prediction(st, cfg)
    same = sum(r.output == o for r, o in zip(reqs, outputs))
    print(f"  launches {counts}; predicted {pred}; decode steps {st.steps}, "
          f"prefill batches {st.prefill_batches}; {st.preemptions} "
          f"preemptions, {st.resumes} resumes, "
          f"{st.swapped_out_bytes / 1e6:.1f} MB swapped out (of which "
          f"{st.swapped_fixed_bytes / 1e6:.1f} MB fixed rows = "
          f"{st.swapped_fixed_bytes / max(fixed_slot, 1):.1f} slots' state), "
          f"{st.swapped_in_bytes / 1e6:.1f} MB back in; {crc_calls[0]} CRC "
          f"computations (drain and swap-in); served in {serve_s:.2f}s; "
          f"outputs equal to path 6's for {same}/{len(reqs)} requests",
          flush=True)
    require(counts == pred, "path 6b: launch counts differ from the "
            "prediction")
    require(st.preemptions >= 2, "path 6b: fewer than two preemptions")
    require(st.resumes == st.preemptions and st.retries == 0,
            "path 6b: a preemption did not resume by swap-in")
    require(st.swapped_fixed_bytes == st.preemptions * fixed_slot,
            "path 6b: the fixed-rows bytes are not whole slots' state")
    require(st.swapped_out_bytes == st.swapped_in_bytes > 0
            and st.swapped_fixed_in_bytes == st.swapped_fixed_bytes,
            "path 6b: swapped bytes out and in differ")
    require(crc_calls[0] >= 2 * st.preemptions,
            "path 6b: an image was not checked at swap-in")
    require(same == len(reqs), "path 6b: outputs differ from path 6's")
    eng.pager.check_invariants()
    require(eng.pager.free_pages == eng.pager.num_pages - 1,
            "path 6b: pages left allocated")
    return dict(launches=counts, predicted=pred, decode_steps=st.steps,
                prefill_batches=st.prefill_batches,
                preemptions=st.preemptions, resumes=st.resumes,
                swapped_out_bytes=st.swapped_out_bytes,
                swapped_fixed_bytes=st.swapped_fixed_bytes,
                swapped_in_bytes=st.swapped_in_bytes, crc_calls=crc_calls[0],
                serve_s=serve_s, same_outputs_as_path6=same,
                **check_decode_graph(eng, "path 6b"))


def _profile_steps(step, steps):
    """Host wall per call of ``step`` over ``steps`` calls, unprofiled and
    under torch.profiler (with the device's kernel time per call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) / steps
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA) / 1e6 / steps
    return wall_plain, wall, busy


def path7():
    """rwkv6-7b at full width and depth (32 layers) through the contiguous
    cache's entry points, ``api.prefill_fn`` / ``api.decode_fn``:
    SmoothQuant+ in f32 (G=128, α searched) through the library, then 8
    greedy requests in two batches of 4 prompts of one length each, 16 new
    tokens; K1 runs the 8 quantized linears of every layer.  RWKV6 has no
    paged serving path (its state is O(1) a slot)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.calibration import synthetic_calibration_set
    from repro_torch.models import api
    from repro_torch.models import ssm as SSM
    from repro_torch.serving.engine import load_or_quantize

    print("path 7: rwkv6-7b full width and depth through prefill_fn / "
          "decode_fn, SmoothQuant+ W4A16 f32, 8 requests in two batches of "
          "4", flush=True)
    t_path = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("rwkv6-7b").with_(dtype="float32")
    params = api.init_model(cfg, seed=0, device=DEV)
    calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, rep = load_or_quantize(params, cfg, calib,
                                   QuantConfig(group_size=128))
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    ptq_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(32, 201, 2)]
    batches = [rng.integers(2, cfg.vocab_size, (4, n)).astype(np.int32)
               for n in lens]
    max_tokens = 16
    nh, hk = SSM.rwkv_dims(cfg)
    state_slot = cfg.num_layers * nh * hk * hk * 4
    outputs, ttft, prefill_s, decode_s = [], [], [], 0.0
    steps = 0
    with path_operands() as seen:
        K.reset_launch_counts()
        for toks in batches:
            n = toks.shape[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = api.prefill_fn(
                params, {"tokens": torch.from_numpy(toks).to(DEV)}, cfg,
                n + max_tokens)
            tok = logits.argmax(-1).to(torch.int32)
            out = [tok.cpu()]
            dt = time.perf_counter() - t0
            prefill_s.append(dt)
            ttft += [dt] * len(toks)
            t0 = time.perf_counter()
            for s in range(max_tokens - 1):
                pos = torch.full((len(toks),), n + s, dtype=torch.int32,
                                 device=DEV)
                logits, cache = api.decode_fn(
                    params, {"token": tok[:, None], "position": pos}, cache,
                    cfg)
                tok = logits.argmax(-1).to(torch.int32)
                out.append(tok.cpu())
                steps += 1
            decode_s += time.perf_counter() - t0
            outputs += torch.stack(out, 1).tolist()
        torch.cuda.synchronize()
        counts = K.launch_counts()
    pred = {n: 0 for n in K.WRAPPERS}
    pred["w4a16_matmul"] = 8 * cfg.num_layers * (len(batches) + steps)
    decoded = len(outputs) * (max_tokens - 1)
    tok_s = decoded / decode_s
    print(f"  launches {counts}; predicted {pred}; {len(batches)} prefills "
          f"(prompt lengths {lens}), {steps} decode steps; wkv state "
          f"{state_slot / 1e6:.1f} MB a request", flush=True)
    require(counts == pred, "path 7: launch counts differ from the "
            "prediction")
    require(all(0 <= t < cfg.vocab_size for o in outputs for t in o),
            "path 7: token out of range")
    operands = check_path_operands(seen, "path 7")
    del seen
    # one prefill and one decode step on the first prompt against the
    # dequantized weights (plain PyTorch linears)
    plain = dequantized_params(params)
    prompt = torch.from_numpy(batches[0][:1]).to(DEV)
    errs = {}
    with torch.no_grad():
        res = {}
        for name, prm in (("kernel", params), ("plain", plain)):
            lg, c = api.prefill_fn(prm, {"tokens": prompt}, cfg,
                                   prompt.shape[1] + 1)
            nxt = lg.argmax(-1).to(torch.int32)[:, None]
            pos = torch.full((1,), prompt.shape[1], dtype=torch.int32,
                             device=DEV)
            res[name] = (lg, api.decode_fn(prm, {"token": nxt,
                                                 "position": pos}, c, cfg)[0])
        for i, step in enumerate(("prefill", "decode")):
            a, b = res["kernel"][i], res["plain"][i]
            require(bool(torch.isfinite(a).all()), f"path 7 {step} logits "
                    "not finite")
            err = max_err(a, b)
            tol = 2e-3 * max(1.0, float(b.abs().max()))
            print(f"  {step} step logits vs plain: max |diff| = {err:.3g} "
                  f"(tol {tol:.3g})")
            require(err <= tol, f"path 7 {step} logits differ from the plain "
                    "path")
            errs[f"{step}_logit_err"] = err
    del plain, res
    gc.collect()
    torch.cuda.empty_cache()
    # a steady window: 8 contiguous decode steps of batch 4, and the
    # prefill of one 4-row batch, host wall and device kernel time
    toks = torch.from_numpy(batches[0]).to(DEV)
    with torch.no_grad():
        logits, cache = api.prefill_fn(params, {"tokens": toks}, cfg,
                                       toks.shape[1] + 64)
        box = {"tok": logits.argmax(-1).to(torch.int32)[:, None],
               "cache": cache, "n": toks.shape[1]}

        def step():
            pos = torch.full((4,), box["n"], dtype=torch.int32, device=DEV)
            lg, box["cache"] = api.decode_fn(
                params, {"token": box["tok"], "position": pos},
                box["cache"], cfg)
            box["tok"] = lg.argmax(-1).to(torch.int32)[:, None]
            box["n"] += 1

        dec_wall, dec_wall_prof, dec_dev = _profile_steps(step, 8)
        pre_wall, _, pre_dev = _profile_steps(
            lambda: api.prefill_fn(params, {"tokens": toks}, cfg,
                                   toks.shape[1] + 1), 1)
    peak = torch.cuda.max_memory_allocated()
    took = time.perf_counter() - t_path
    print(f"  PTQ alpha={rep.alpha:.2f} in {ptq_s:.1f}s "
          f"({rep.fp_bytes / 1e9:.2f} GB -> {rep.quant_bytes / 1e9:.2f} GB, "
          f"PTQ peak {ptq_peak / 2 ** 30:.2f} GiB); {decoded} decoded tokens "
          f"in {decode_s:.2f}s: {tok_s:.1f} decode tok/s, TTFT p50 "
          f"{statistics.median(ttft):.3f}s max {max(ttft):.3f}s (the batch's "
          f"prefill); decode step (batch 4): {dec_wall * 1e3:.2f} ms wall, "
          f"{dec_dev * 1e3:.2f} ms device; prefill of 4x{toks.shape[1]}: "
          f"{pre_wall * 1e3:.1f} ms wall = {pre_wall * 1e3 / toks.numel():.3f}"
          f" ms a prompt token, {pre_dev * 1e3:.1f} ms device; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; {took:.1f}s in all", flush=True)
    RESULTS["path7"] = dict(
        launches=counts, predicted=pred, prompt_lens=lens,
        decode_steps=steps, decoded_tokens=decoded, decode_s=decode_s,
        decode_tok_s=tok_s, ttft_s=sorted(ttft), prefill_s=prefill_s,
        ptq_s=ptq_s, ptq_peak_mem_bytes=ptq_peak, alpha=rep.alpha,
        fp_bytes=rep.fp_bytes, quant_bytes=rep.quant_bytes,
        decode_wall_ms=dec_wall * 1e3, decode_wall_profiled_ms=(
            dec_wall_prof * 1e3), decode_device_ms=dec_dev * 1e3,
        prefill_wall_ms=pre_wall * 1e3, prefill_device_ms=pre_dev * 1e3,
        prefill_ms_per_prompt_token=pre_wall * 1e3 / toks.numel(),
        wkv_bytes_per_request=state_slot, peak_mem_bytes=peak,
        path_operands=operands, seconds=took, **errs)
    del params, cache, box
    return counts


# ----------------------------------------------------- paths 8 and 8b ---
# whisper-medium's cross K/V rows per request: Whisper pads every input to
# its 30 s window (3000 mel frames), which the stride-2 conv stub turns into
# 1500 encoder positions
ENC_FRAMES = 1500


def audio(i, t=ENC_FRAMES, d=1024):
    """Request ``i``'s encoder frames, N(0, 0.1²) from seed 1000 + i; every
    third request repeats request 0's audio (serve's rule)."""
    r = np.random.default_rng(1000 + (0 if i % 3 == 0 else i))
    return (r.standard_normal((t, d)) * 0.1).astype(np.float32)


def path8_prediction(st, cfg):
    """whisper-medium's launches: K1 for the decoder's 8 quantized linears a
    layer (self q/k/v/o, cross q/o, the MLP's two) on every decode step and
    prefill batch, and for every encode the encoder's 6 a layer plus the
    cross k/v of every decoder layer (both 192 at 24 + 24 layers); K2 once
    a decoder layer a step, K3 once a decoder layer a batch; nothing
    else."""
    per = 8 * cfg.num_layers
    per_enc = 6 * cfg.enc_layers + 2 * cfg.num_layers
    pred = {n: 0 for n in K.WRAPPERS}
    pred.update({"w4a16_matmul": per * (st.steps + st.prefill_batches)
                 + per_enc * st.enc_encodes,
                 "gqa_paged_decode": cfg.num_layers * st.steps,
                 "gqa_paged_prefill": cfg.num_layers * st.prefill_batches})
    return pred


def _enc_rows(kv, pages, ps):
    """An encode's ``{"xk"/"xv": [L, 1, T, Hkv, Dh]}`` padded to whole pages:
    ``[L, pages, ps, Hkv, Dh]``."""
    t = kv["xk"].shape[2]
    return {k: torch.nn.functional.pad(v[:, 0], (0, 0, 0, 0, 0,
                                                 pages * ps - t)).reshape(
        v.shape[0], pages, ps, *v.shape[3:]) for k, v in kv.items()}


@torch.no_grad()
def check_encdec_step_against_plain(params, cfg, ps, prompt, frames):
    """One encode, one prefill chunk of the whole prompt and one decode
    step, through the kernels, against the same on the dequantized weights
    with the dense-gather oracle (each over its own pools)."""
    from repro_torch.models import api
    from repro_torch.models import whisper as W

    plain_params = dequantized_params(params)
    plain_cfg = cfg.with_(paged_attn_impl="gather")
    n, te = len(prompt), frames.shape[0]
    kp, ep = -(-(n + 1) // ps), -(-te // ps)
    table = torch.arange(1, kp + 1, dtype=torch.int32, device=DEV)[None]
    etable = torch.arange(kp + 1, kp + ep + 1, dtype=torch.int32,
                          device=DEV)[None]
    elen = torch.tensor([te], dtype=torch.int32, device=DEV)
    fr = torch.from_numpy(frames).to(DEV)[None]
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=DEV)[None]
    zero = torch.zeros(1, dtype=torch.int32, device=DEV)
    clen = torch.tensor([n], dtype=torch.int32, device=DEV)
    nxt = torch.tensor([[int(prompt[-1])]], dtype=torch.int32, device=DEV)
    out = {}
    for name, prm, c in (("kernel", params, cfg), ("plain", plain_params,
                                                   plain_cfg)):
        kv = api.encode_kv_fn(prm, fr, c)
        pools = api.init_paged_cache(c, 1 + kp + ep, ps, DEV)
        for k, rows in _enc_rows(kv, ep, ps).items():
            pools["enc"][k].index_copy_(1, etable[0].long(), rows)
        pre = W.whisper_prefill_chunk(prm, toks, pools, zero, clen, table,
                                      etable, elen, c)[0]
        dec = W.whisper_decode_paged(prm, nxt, pools, clen, table, etable,
                                     elen, c)[0]
        out[name] = (kv["xk"], kv["xv"], pre, dec)
        del kv, pools
    errs = {}
    for i, step in enumerate(("encode xk", "encode xv", "prefill",
                              "decode")):
        a, b = out["kernel"][i], out["plain"][i]
        require(bool(torch.isfinite(a).all()), f"{step} not finite")
        err = max_err(a, b)
        tol = 2e-3 * max(1.0, float(b.abs().max()))
        print(f"  {step} vs plain: max |diff| = {err:.3g} (tol {tol:.3g})"
              + (f", argmax {int(a.argmax())} vs {int(b.argmax())}"
                 if i >= 2 else ""))
        require(err <= tol, f"{step} differs from the plain path")
        errs[step.replace(" ", "_") + "_err"] = err
    del plain_params, out
    return errs


@torch.no_grad()
def cross_gather_ms(eng):
    """The decode step's cross attention alone, at path 8's shapes: every
    decoder layer gathers each of the 4 rows' 96 encoder pages (1536 rows of
    16 heads x 64, f32, K and V) out of the encoder pool and attends over
    its 1500 valid rows (``whisper.gather_enc`` + ``attention.attend_rows``,
    plain PyTorch ops).  The device time of one step's 24 layers (a CUDA
    graph of two steps) beside the eager CUDA-event time, and the bytes:
    the gather reads and writes the pages, the einsums read them again."""
    from repro_torch.models import attention as A
    from repro_torch.models import whisper as W

    cfg, enc = eng.cfg, eng.pools["enc"]
    b, p, ps = 4, eng.P, eng.PS
    used = -(-ENC_FRAMES // ps)
    etbl = torch.zeros(b, p, dtype=torch.int32, device=DEV)
    etbl[:, :used] = torch.arange(1, 1 + b * used, dtype=torch.int32,
                                  device=DEV).reshape(b, used)
    elen = torch.full((b,), ENC_FRAMES, dtype=torch.int32, device=DEV)
    q = torch.randn(b, cfg.num_kv_heads, 1, cfg.hdim, device=DEV)

    def step():
        for i in range(cfg.num_layers):
            xk, xv, valid = W.gather_enc(enc["xk"][i], enc["xv"][i], etbl,
                                         elen)
            A.attend_rows(q, xk, xv, valid, cfg.hdim ** -0.5)
    ms = graph_ms([step], calls=2)
    eager_ms = time_ms([step])
    row = b * p * ps * cfg.num_kv_heads * cfg.hdim * 4      # K or V, bytes
    moved = cfg.num_layers * 2 * row * 3
    live = cfg.num_layers * 2 * b * ENC_FRAMES * cfg.num_kv_heads \
        * cfg.hdim * 4
    out = dict(ms=ms, eager_ms=eager_ms, bytes_moved=moved, gathered_bytes=cfg.num_layers * 2
               * row, live_bytes=live, bound_ms=live / HBM_BYTES_S * 1e3,
               achieved_gb_s=moved / ms / 1e6)
    print(f"  cross-attention gather + einsums alone (batch 4, 96 pages a "
          f"row, 24 layers): {ms:.3f} ms a step on the device (eager "
          f"{eager_ms:.3f}); {moved / 1e9:.3f} GB moved "
          f"({out['achieved_gb_s']:.0f} GB/s), {live / 1e9:.3f} GB of live "
          f"encoder rows, whose read alone bounds it at "
          f"{out['bound_ms']:.3f} ms")
    return out


def pool_use(eng):
    """The bytes of the decoder's KV pools and of the encoder pool, and the
    share of each that its page group can ever hold: both are sized at
    ``num_pages``, a page id belongs to one group at a time, and each group
    holds at most B·P pages (the default doubles ``num_pages`` for the two
    groups)."""
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    kv = nbytes(t for lp in eng.pools["layers"] for t in lp.values())
    enc = nbytes(eng.pools["enc"].values())
    pages = eng.pools["enc"]["xk"].shape[1]
    cap = eng.B * eng.P
    out = dict(kv_pool_bytes=kv, enc_pool_bytes=enc, pages=pages,
               group_cap_pages=cap, usable_share=cap / (pages - 1))
    print(f"  page pools: decoder KV {kv / 1e9:.3f} GB, encoder "
          f"{enc / 1e9:.3f} GB, {pages} pages each; each group holds at "
          f"most {eng.B} x {eng.P} = {cap} pages, {out['usable_share']:.3f} "
          "of each pool", flush=True)
    return out


def path8():
    """whisper-medium at full width and depth (24 encoder + 24 decoder
    layers, d_model 1024, 16 heads of 64, vocab 51865), biases from a seeded
    N(0, 0.02²), SmoothQuant+ in f32 (G=128, α searched) on 2 calibration
    sequences of 24 tokens and 24 frames, through the library entry
    points; f32 serving, page size 16, batch 4, max_seq 1536, path 1's 8
    prompts with 16 new tokens, every request with 1500 encoder frames
    (requests 0, 3 and 6 the same audio); then path 8b and the serve
    entry."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.calibration import synthetic_calibration_set
    from repro_torch.models import api
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            load_or_quantize)

    print("path 8: whisper-medium full width and depth (24 + 24 layers), "
          "SmoothQuant+ W4A16 f32, fp pools, path 1's 8 prompts, 1500 "
          "encoder frames a request (requests 0, 3, 6 share audio)",
          flush=True)
    t_path = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("whisper-medium").with_(dtype="float32")
    params = api.init_model(cfg, seed=0, device=DEV)
    n_bias = fill_biases(params)
    calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, rep = load_or_quantize(params, cfg, calib,
                                   QuantConfig(group_size=128))
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    ptq_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 201, 8)
    prompts = [rng.integers(2, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]

    def requests():
        return [Request(uid=i, prompt=p, max_tokens=16, frames=audio(i))
                for i, p in enumerate(prompts)]

    def engine():
        return ServingEngine(params, cfg, batch_size=4, max_seq=1536,
                             page_size=16, seed=0, device=DEV)

    reqs = requests()
    eng = engine()
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
    pred = path8_prediction(st, cfg)
    print(f"  launches {counts}; predicted {pred}; decode steps {st.steps}, "
          f"prefill batches {st.prefill_batches}, encodes {st.enc_encodes}, "
          f"exact-match hits {st.enc_hits} (predicted 6 and 2); "
          f"{n_bias} bias tensors filled", flush=True)
    require(all(r.finish_reason in ("completed", "length") for r in reqs),
            "path 8: a request did not finish")
    require(all(len(r.output) == 16 or r.finish_reason == "completed"
                for r in reqs), "path 8: a request stopped early without EOS")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
            "path 8: token out of range")
    require(counts == pred, "path 8: launch counts differ from the "
            "prediction")
    require((st.enc_encodes, st.enc_hits) == (6, 2),
            "path 8: encoder encodes / hits differ from the prediction 6 / 2")
    tok_s = st.decoded_tokens / serve_s
    ttft = sorted(r.first_token_t - r.arrival_t for r in reqs)
    print(f"  PTQ alpha={rep.alpha:.2f} in {ptq_s:.1f}s ({rep.fp_bytes / 1e9:.2f}"
          f" GB -> {rep.quant_bytes / 1e9:.2f} GB, PTQ peak "
          f"{ptq_peak / 2 ** 30:.2f} GiB); served {st.completed} requests in "
          f"{serve_s:.2f}s: {tok_s:.1f} decode tok/s, TTFT (encode included) "
          f"p50 {statistics.median(ttft):.3f}s max {ttft[-1]:.3f}s",
          flush=True)
    out = dict(launches=counts, predicted=pred, decode_steps=st.steps,
               prefill_batches=st.prefill_batches, enc_encodes=st.enc_encodes,
               enc_hits=st.enc_hits, decoded_tokens=st.decoded_tokens,
               prefilled_tokens=st.prefilled_tokens, serve_s=serve_s,
               decode_tok_s=tok_s, ttft_s=ttft, ptq_s=ptq_s,
               ptq_peak_mem_bytes=ptq_peak, alpha=rep.alpha,
               fp_bytes=rep.fp_bytes, quant_bytes=rep.quant_bytes,
               biases_filled=n_bias, **check_decode_graph(eng, "path 8"))
    out["path_operands"] = check_path_operands(seen, "path 8")
    del seen
    out["pool"] = pool_use(eng)
    out.update(check_encdec_step_against_plain(eng.params, cfg, eng.PS,
                                               prompts[0], audio(0)))
    frames = torch.from_numpy(audio(0)).to(DEV)[None]
    wall_plain, wall, busy = _profile_steps(
        lambda: api.encode_kv_fn(eng.params, frames, cfg), 2)
    print(f"  one encode (1500 frames, 24 encoder layers + 48 cross "
          f"projections): {wall_plain * 1e3:.2f} ms wall, {busy * 1e3:.2f} "
          "ms device", flush=True)
    out.update(encode_wall_ms=wall_plain * 1e3, encode_device_ms=busy * 1e3)
    outputs = [list(r.output) for r in reqs]
    profile_decode(eng, reqs, "path8_profile")
    out["cross_gather"] = cross_gather_ms(eng)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["path8b"] = path8b(engine, requests, outputs, cfg)
    out["serve"] = path8_serve()
    out["seconds"] = time.perf_counter() - t_path
    print(f"path 8: peak memory {out['peak_mem_bytes'] / 2 ** 30:.2f} GiB; "
          f"took {out['seconds']:.1f}s", flush=True)
    RESULTS["path8"] = out
    return counts


def path8b(engine, requests, outputs, cfg):
    """Path 8's params and requests on a fresh engine, one mid-decode
    preemption forced white-box (the admission watermark keeps the default
    pool from preempting): the victim's encoder pages are detached under
    swap holds and reattached at resume, its image holds its private KV
    rows only, and the tokens equal path 8's."""
    print("path 8b: path 8's params and requests, one mid-decode "
          "preemption (encoder pages detached, KV rows swapped)", flush=True)
    eng, reqs = engine(), requests()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    for _ in range(64):
        eng.step()
        dec = [i for i in eng._active_slots()
               if eng.pos[i] >= eng.pref_target[i]]
        if len(dec) >= 2:
            break
    require(len(dec) >= 2, "path 8b: fewer than two slots decoding")
    victim = dec[0]
    enc_pages = eng.pager.slot_pages(victim, "enc")
    kv_private = len(eng.pager.split_for_swap(victim)[1])
    eng._preempt(victim)
    img = next(iter(eng._swapped.values()))
    held = eng.pager.held()
    detached = (img.enc_pages == enc_pages
                and len(enc_pages) == -(-ENC_FRAMES // eng.PS)
                and all(held[p] >= 1 for p in enc_pages))
    eng.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = K.launch_counts()
    st = eng.stats
    pred = path8_prediction(st, cfg)
    page_bytes = api_kv_page_bytes(eng)
    same = sum(r.output == o for r, o in zip(reqs, outputs))
    print(f"  launches {counts}; predicted {pred}; decode steps {st.steps}, "
          f"prefill batches {st.prefill_batches}, encodes {st.enc_encodes}, "
          f"hits {st.enc_hits}; {st.preemptions} preemption, {st.resumes} "
          f"resume; the victim's {len(enc_pages)} encoder pages detached "
          f"under holds {detached}; {st.swapped_out_bytes / 1e6:.1f} MB swapped out = "
          f"{kv_private} private KV pages x {page_bytes / 1e6:.2f} MB, "
          f"fixed rows {st.swapped_fixed_bytes} B; served in {serve_s:.2f}s;"
          f" outputs equal to path 8's for {same}/{len(reqs)} requests",
          flush=True)
    require(counts == pred, "path 8b: launch counts differ from the "
            "prediction")
    require(detached, "path 8b: the encoder pages were not detached under "
            "holds")
    require(st.preemptions == st.resumes == 1 and st.retries == 0,
            "path 8b: the preemption did not resume by swap-in")
    require(st.swapped_fixed_bytes == 0, "path 8b: fixed rows swapped")
    require(st.swapped_out_bytes == kv_private * page_bytes
            == st.swapped_in_bytes > 0,
            "path 8b: the image is not the victim's private KV rows")
    require((st.enc_encodes, st.enc_hits) == (6, 2),
            "path 8b: the resume encoded again")
    require(same == len(reqs), "path 8b: outputs differ from path 8's")
    eng.pager.check_invariants()
    require(int(eng.pager.held().sum()) == 0, "path 8b: holds left")
    return dict(launches=counts, predicted=pred, decode_steps=st.steps,
                prefill_batches=st.prefill_batches,
                preemptions=st.preemptions,
                swapped_out_bytes=st.swapped_out_bytes,
                swapped_in_bytes=st.swapped_in_bytes,
                private_kv_pages=kv_private, kv_page_bytes=page_bytes,
                enc_pages_detached=detached, serve_s=serve_s,
                same_outputs_as_path8=same,
                **check_decode_graph(eng, "path 8b"))


def api_kv_page_bytes(eng):
    """Bytes of one KV page across every decoder layer's pools."""
    return sum(t[0].numel() * t.element_size()
               for lp in eng.pools["layers"] for t in lp.values())


def path8_serve():
    """whisper-medium through the serve entry at full width (its own
    PTQ), serve's synthetic frames (6-10 rows, every third request request
    0's audio): the launch counts held to path 8's prediction, and the
    encoder-pages line."""
    from repro_torch.launch import serve

    print("path 8 serve entry: --arch whisper-medium, serve's synthetic "
          "frames", flush=True)
    K.reset_launch_counts()
    res = serve.main(["--arch", "whisper-medium", "--requests", "8",
                      "--batch-size", "4", "--max-seq", "256",
                      "--max-tokens", "16", "--min-prompt", "32",
                      "--max-prompt", "200", "--seed", "0", *SERVE_COLD])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    eng = res["engine"]
    st = eng.stats
    pred = path8_prediction(st, eng.cfg)
    print(f"  launches {counts}; predicted {pred}; encoder pages: "
          f"{st.enc_encodes} encodes, {st.enc_hits} exact-match hits",
          flush=True)
    require(counts == pred, "path 8 serve: launch counts differ from the "
            "prediction")
    require((st.enc_encodes, st.enc_hits) == (6, 2),
            "path 8 serve: encodes / hits differ from 6 / 2")
    require(all(r.finish_reason in ("completed", "length")
                for r in res["requests"]), "path 8 serve: unfinished")
    return dict(launches=counts, enc_encodes=st.enc_encodes,
                enc_hits=st.enc_hits, serve_s=res["serve_s"],
                ptq_s=res["ptq_s"], decode_steps=st.steps,
                **check_decode_graph(eng, "path 8 serve"))


def path4c(params, cfg):
    """Path 4's params (deepseek-v2-236b, 2 layers, fp latent pools,
    128-token chunks) with the prefix cache: two waves of 4 behind a
    128-token system prompt; wave 2 opens with wave 1's 144-token
    page-aligned prompt.  B9 reads cached latent pages, B8 decodes over
    shared ones.

    At the config's capacity factor (1.25) a prefill call drops the expert
    assignments past each expert's capacity, and which ones drop depends on
    every token in the call, pad rows included: a warm suffix chunk shares
    its call with other tokens than the cold prompt did, so its MoE output,
    and the greedy tokens after it, may move (in both packages; the
    reference's smoke config, factor 4.0, never drops).  That run is
    printed.  The checked run raises the factor to 28 (capacity >= tokens
    per call: no assignment ever drops, so every token's function is its
    own), and there the tokens must equal the cache-off run's."""
    import dataclasses as dc

    print("path 4c: path 4's params, prefix cache on: two waves of 4 behind "
          "a 128-token system prompt, cold then warm", flush=True)
    nl = cfg.num_layers

    def pred(st):
        return path4_prediction(st, nl)

    waves = prefix_waves(cfg.vocab_size, 128, 16, seed=2)
    *_, same_125 = _cold_warm(
        params, cfg, waves, 128, "path 4c at capacity factor 1.25", pred,
        same_tokens=False, max_prefill_tokens=128)
    no_drop = cfg.with_(moe=dc.replace(cfg.moe, capacity_factor=28.0))
    cold, warm, counts, operands, graph, _ = _cold_warm(
        params, no_drop, waves, 128, "path 4c", pred,
        max_prefill_tokens=128)
    RESULTS["path4c"] = dict(
        cold=_waves_result(cold), warm=_waves_result(warm), launches=counts,
        path_operands=operands, same_at_factor_1_25=same_125, **graph)
    return counts


def path4d_prediction(nl, prefills, steps):
    """Path 4d's launches: the contiguous prefill runs MLA expanded, so K1
    takes wq_a, wq_b, wkv_a, wkv_b, wo and the shared expert's gate/up/down
    (8 a layer) and B6 the routed experts' gate/up/down (3); a decode step
    runs it absorbed: K1 7 a layer (wkv_b unread), B6 5 (the experts and
    the absorbed wk_t / wv pair).  No attention kernel: the contiguous
    cache attends with plain ops, as in the reference."""
    pred = {n: 0 for n in K.WRAPPERS}
    pred.update({"w4a16_matmul": nl * (8 * prefills + 7 * steps),
                 "w4a16_grouped": nl * (3 * prefills + 5 * steps)})
    return pred


def _dequantized_expanded(params):
    """Every int4 weight dequantized to f32, ``wkv_b`` from its own codes
    and the absorbed pair dropped: the weights expanded MLA reads."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()
                    if k != "wkv_b_absorbed"}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if isinstance(node, QuantizedTensor):
            return dequantize(node, torch.float32)
        return node
    return conv(params)


def _seed_latent_pool(cfg, cache, n, smax, ps=16):
    """Paged latent pools holding the contiguous cache's first ``n`` rows of
    every batch row (row b on pages 1 + b·P ..), and their page table."""
    b = cache["layers"][0]["ckv"].shape[0]
    pages = -(-smax // ps)
    pool = LM.init_paged_cache(cfg, 1 + b * pages, ps, DEV)
    for lp, lc in zip(pool["layers"], cache["layers"]):
        for k in ("ckv", "kpe"):
            rows = lp[k][1:].view(b, pages * ps, -1)
            rows[:, :n] = lc[k][:, :n]
    table = (1 + torch.arange(b * pages, dtype=torch.int32, device=DEV)
             ).view(b, pages)
    return pool, table


def path4d(params, cfg):
    """deepseek-v2-236b (path 4's quantized params, 2 of 60 layers) through
    MLA's contiguous latent cache: ``api.prefill_fn`` on 4 prompts of one
    length, then 16 greedy ``api.decode_fn`` steps.  K1 and B6 held to
    the prediction; the prefill against the same call on the dequantized
    weights; the 16 decode steps against the paged path (``lm_decode_paged``:
    B8, B6, K1) from a latent pool seeded with the contiguous prefill's
    rows, teacher-forced with the contiguous run's tokens: logits within
    1e-4 of the logit scale (the absorbed weights are the same int4 in both;
    the attention sums in another order), greedy tokens equal.  The
    prefills are not compared with each other: the contiguous one reads
    ``wkv_b``'s own int4 codes (expanded MLA), the paged one the
    separately quantized absorbed pair, as in the reference; their gap is
    printed."""
    from repro_torch.models import api

    print("path 4d: deepseek-v2-236b, 2 of 60 layers (reduced), path 4's "
          "SmoothQuant+ W4A16 f32 params, contiguous latent cache: "
          "prefill_fn on 4 prompts, 16 decode_fn steps", flush=True)
    t_path = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(4)
    n = int(rng.integers(32, 201))
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, n)).astype(
        np.int32)).to(DEV)
    steps, smax = 16, n + 17
    nl = cfg.num_layers
    pred = path4d_prediction(nl, 1, steps)
    out, logits_c = [], []
    with path_operands() as seen, torch.no_grad():
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = api.prefill_fn(params, {"tokens": toks}, cfg, smax)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre_logits = lg.clone()
        tok = lg.argmax(-1).to(torch.int32)
        out.append(tok)
        t0 = time.perf_counter()
        for s in range(steps):
            pos = torch.full((4,), n + s, dtype=torch.int32, device=DEV)
            lg, cache = api.decode_fn(params, {"token": tok[:, None],
                                               "position": pos}, cache, cfg)
            logits_c.append(lg.clone())
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counts = K.launch_counts()
    print(f"  launches {counts}; predicted {pred}; prompt length {n}, "
          f"{steps} decode steps", flush=True)
    require(counts == pred, "path 4d: launch counts differ from the "
            "prediction")
    require(int(cache["layers"][0]["lens"][0]) == n + steps,
            "path 4d: cache lengths")
    operands = check_path_operands(seen, "path 4d")
    del seen
    tokens = torch.stack(out, 1)
    require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            "path 4d: token out of range")
    res = {}
    with torch.no_grad():
        # the prefill against the dequantized weights (plain linears; the
        # expanded prefill reads wkv_b's own codes, never the absorbed pair)
        plain = _dequantized_expanded(params)
        lp = api.prefill_fn(plain, {"tokens": toks}, cfg, smax)[0]
        del plain
        err = max_err(pre_logits, lp)
        tol = 2e-3 * max(1.0, float(lp.abs().max()))
        print(f"  prefill logits vs the dequantized weights: max |diff| = "
              f"{err:.3g} (tol {tol:.3g}); argmax equal "
              f"{int((pre_logits.argmax(-1) == lp.argmax(-1)).sum())}/4")
        require(err <= tol, "path 4d: prefill logits differ from the "
                "plain path")
        res["prefill_vs_plain_err"] = err
        # the paged path's prefill, for the gap between the two int4 forms
        pool, table = _seed_latent_pool(cfg, cache, 0, smax)
        lpp = LM.lm_prefill_chunk(
            params, toks, pool, torch.zeros(4, dtype=torch.int32, device=DEV),
            torch.full((4,), n, dtype=torch.int32, device=DEV), table, cfg)[0]
        gap = max_err(pre_logits, lpp) / float(lpp.abs().max())
        print(f"  contiguous vs paged prefill (wkv_b's int4 vs the absorbed "
              f"pair's): max |diff| {gap:.4f} of the logit scale, argmax "
              f"equal {int((pre_logits.argmax(-1) == lpp.argmax(-1)).sum())}"
              "/4 (not checked: two quantizations of one weight)")
        res["prefill_contiguous_vs_paged_rel"] = gap
        # decode: the paged path from the contiguous prefill's latent rows
        ccache = api.prefill_fn(params, {"tokens": toks}, cfg, smax)[1]
        pool, table = _seed_latent_pool(cfg, ccache, n, smax)
        worst, same = 0.0, 0
        for s in range(steps):
            pos = torch.full((4,), n + s, dtype=torch.int32, device=DEV)
            lgp = LM.lm_decode_paged(params, tokens[:, s:s + 1], pool, pos,
                                     table, cfg)[0]
            scale = float(lgp.abs().max())
            worst = max(worst, max_err(logits_c[s], lgp) / scale)
            same += int((lgp.argmax(-1) == tokens[:, s + 1]).sum())
        print(f"  16 decode steps vs the paged path (B8) from the same "
              f"latent rows: worst max |diff| {worst:.3g} of the logit scale "
              f"(tol 1e-4); greedy tokens equal {same}/{4 * steps}")
        require(worst <= 1e-4, "path 4d: contiguous decode logits differ "
                "from the paged path's")
        require(same == 4 * steps, "path 4d: greedy tokens differ from the "
                "paged path's")
        res.update(decode_vs_paged_rel=worst, greedy_equal=same)
        del ccache, pool
        # a steady window: 8 decode steps of batch 4, wall and device
        box = {"tok": tokens[:, -1:].contiguous(), "n": n + steps,
               "cache": cache}
        api_steps = 8
        ext = api.init_decode_cache(cfg, 4, smax + api_steps, device=DEV)
        for lc, le in zip(cache["layers"], ext["layers"]):
            for k in ("ckv", "kpe"):
                le[k][:, :smax] = lc[k]
            le["lens"].copy_(lc["lens"])
        box["cache"] = ext

        def step():
            pos = torch.full((4,), box["n"], dtype=torch.int32, device=DEV)
            lg_, box["cache"] = api.decode_fn(
                params, {"token": box["tok"], "position": pos},
                box["cache"], cfg)
            box["tok"] = lg_.argmax(-1).to(torch.int32)[:, None]
            box["n"] += 1

        dec_wall, dec_wall_prof, dec_dev = _profile_steps(
            step, api_steps // 2)
    peak = torch.cuda.max_memory_allocated()
    took = time.perf_counter() - t_path
    print(f"  prefill of 4x{n}: {prefill_s * 1e3:.1f} ms wall; 16 decode "
          f"steps {decode_s:.2f}s; decode step (batch 4): "
          f"{dec_wall * 1e3:.2f} ms wall, {dec_dev * 1e3:.2f} ms device; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; {took:.1f}s in all",
          flush=True)
    RESULTS["path4d"] = dict(
        launches=counts, predicted=pred, prompt_len=n, decode_steps=steps,
        prefill_wall_ms=prefill_s * 1e3, decode_s=decode_s,
        decode_wall_ms=dec_wall * 1e3,
        decode_wall_profiled_ms=dec_wall_prof * 1e3,
        decode_device_ms=dec_dev * 1e3, peak_mem_bytes=peak,
        outputs=tokens.tolist(), path_operands=operands, seconds=took, **res)
    return counts


def _same_params(a, b) -> bool:
    """Two port param trees equal bitwise, ``a8`` flags included."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_params(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same_params, a, b))
    if isinstance(a, QuantizedTensor):
        return a.a8 == b.a8 and all(
            _same_params(getattr(a, f), getattr(b, f))
            for f in ("packed", "scales", "zeros"))
    return a.dtype == b.dtype and torch.equal(a, b)


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


def path2c():
    """The paper's comparison at full width: path 2's outlier codellama-7b
    (seeded hot channels), G=128, quantized by RTN, AWQ (α searched per
    group, step 0.05) and SmoothQuant+ (one α, step 0.05), each from freshly
    built fp params since all three work in place.  The fp logits on two
    held-out 32-token sequences are taken first and the fp params freed, so
    the peak stays near one fp model plus one quantized one.  Prints each
    method's relative logit error, argmax agreement with the fp model, its
    seconds and AWQ's α per group; only finite logits are required (the
    ordering is a finding, not a check)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import apply as AP
    from repro_torch.core.awq import awq_quantize
    from repro_torch.core.calibration import synthetic_calibration_set
    from repro_torch.models import api

    print("path 2c: RTN, AWQ and SmoothQuant+ on path 2's outlier "
          "codellama-7b at full width, G=128", flush=True)
    cfg = get_config("codellama-7b").with_(dtype="float32")
    qcfg = QuantConfig(group_size=128)
    calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab_size, (2, 32))).to(DEV)

    def fresh():
        params = api.init_model(cfg, seed=0, device=DEV)
        inject_hot_channels(params, cfg)
        return params

    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = fresh()
        fp = LM.lm_forward(params, toks, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for method in ("rtn", "awq", "smoothquant+"):
        params = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extra = {}
        if method == "rtn":
            q = AP.rtn_baseline(params, cfg, qcfg)
        elif method == "awq":
            q, extra["alphas"] = awq_quantize(params, cfg, calib, qcfg,
                                              step=0.05)
        else:
            q, rep = AP.smoothquant_plus(params, cfg, calib, qcfg)
            extra["alpha"] = rep.alpha
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with torch.no_grad():
            lg = LM.lm_forward(q, toks, cfg)
        require(bool(torch.isfinite(lg).all()),
                f"path 2c: {method} logits not finite")
        rel = float((lg - fp).norm() / fp.norm())
        agree = float((lg.argmax(-1) == fp.argmax(-1)).float().mean())
        print(f"  {method}: relative logit error {rel:.4f}, argmax agreement "
              f"{agree:.4f}, {secs:.1f}s {extra}", flush=True)
        out[method] = dict(rel_logit_err=rel, argmax_agreement=agree,
                           seconds=secs, **extra)
        del params, q, lg
        gc.collect()
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory {peak / 2 ** 30:.2f} GiB", flush=True)
    RESULTS["path2c"] = dict(out, peak_mem_bytes=peak)


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
                          "--act-quant", "a8_prefill", *SERVE_COLD],
                         attn_impl="flash")
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
                          "a8_prefill", *SERVE_COLD])
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
    pred = path4_prediction(st, nl, "_int8" if quant else "")
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
    path4c(params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    path4d(params, cfg)
    RESULTS["path4"] = dict(res4, ptq_s=ptq_s, alpha=rep.alpha,
                            ptq_peak_mem_bytes=ptq_peak, fp_bytes=rep.fp_bytes,
                            quant_bytes=rep.quant_bytes,
                            a8_eligibility=rep.a8_eligibility)
    RESULTS["path4b"] = dict(res4b, same_outputs_as_path4=same)
    return counts4, counts4b


# ----------------------------------------------------- paths 9 and 9b ---
def _llama_param_count(cfg) -> int:
    """llama3.2-3b's parameters from its config: the tied embedding, per
    layer q/k/v/o, the SwiGLU MLP and two RMSNorms, and the final norm."""
    d, hd = cfg.d_model, cfg.hdim
    attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    layer = attn + 3 * d * cfg.d_ff + 2 * d
    return cfg.vocab_size * d + cfg.num_layers * layer + d


def path9():
    """llama3.2-3b at full width and depth (28 layers, d_model 3072, vocab
    128256, tied head) in the config's bf16, trained through
    ``repro_torch.launch.train.main`` with the reference CLI's defaults
    (batch 8, 128 tokens, remat ``block``, lr 3e-4, warmup 2) for 20 steps,
    no checkpoint directory; then one step with remat ``none``.  Training
    runs no kernel (the reference's train step is XLA, with chunked
    attention), so every launch counter stays 0."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import train as TR
    from repro_torch.models import api
    from repro_torch.optim import adamw

    cfg = get_config("llama3.2-3b")
    n = _llama_param_count(cfg)
    gb = 1e9
    pred = {"params": 2 * n, "grads": 2 * n, "moments": 8 * n}
    print(f"path 9: llama3.2-3b full width and depth, {cfg.dtype}, "
          f"{n / 1e9:.3f} B parameters, trained through launch.train.main "
          "(batch 8, 128 tokens, remat block, lr 3e-4, 20 steps); predicted "
          f"memory: params {pred['params'] / gb:.1f} GB, grads "
          f"{pred['grads'] / gb:.1f} GB, f32 moments "
          f"{pred['moments'] / gb:.1f} GB = {sum(pred.values()) / gb:.1f} GB "
          "plus activations under remat", flush=True)
    t_path = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times, gnorms = [], []
    orig = TR.make_train_step

    def timed(cfg_, tc_):
        """The train step, its host wall (the card synchronized on both
        sides) and its pre-clip gradient norm recorded."""
        fn = orig(cfg_, tc_)

        def step(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            gnorms.append(float(res[2]["grad_norm"]))
            return res

        return step

    K.reset_launch_counts()
    TR.make_train_step = timed
    try:
        losses = TR.main(
            ["--arch", "llama3.2-3b", "--steps", "20", "--batch", "8",
             "--seq", "128", "--lr", "3e-4", "--log-every", "5",
             "--device", "cuda"])
    finally:
        TR.make_train_step = orig
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    require(len(losses) == 20, "path 9: not 20 steps")
    require(all(math.isfinite(x) for x in losses), "path 9: a loss is not "
            "finite")
    require(all(math.isfinite(g) for g in gnorms), "path 9: a gradient norm "
            "is not finite")
    require(losses[-1] < losses[0], "path 9: the loss did not fall")
    require(not any(counts.values()), "path 9: a kernel ran in training")
    wall = statistics.median(times[1:])
    tok_s = 8 * 128 / wall
    print(f"  loss step 0 {losses[0]:.4f}, step 19 {losses[-1]:.4f}; grad "
          f"norm step 0 {gnorms[0]:.3f}, step 19 {gnorms[-1]:.3f}; step "
          f"(median of steps 1-19): {wall * 1e3:.1f} ms wall, "
          f"{tok_s:.0f} tokens/s; step 0 {times[0] * 1e3:.1f} ms wall; peak "
          f"memory {peak / gb:.2f} GB (predicted "
          f"{sum(pred.values()) / gb:.1f} GB before activations)", flush=True)
    walls_main, gnorms_main = list(times), list(gnorms)
    gc.collect()
    torch.cuda.empty_cache()
    # one step with remat none, fresh params and state
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tc = TrainConfig(learning_rate=3e-4, total_steps=20, warmup_steps=2,
                     remat="none")
    params = api.init_model(cfg, seed=0, device=DEV)
    opt = adamw.init_opt_state(params, tc)
    batch = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=128, global_batch=8), cfg,
                            device=DEV).batch_at(0)
    step_fn = timed(cfg, tc)
    times.clear()
    params, opt, m = step_fn(params, opt, batch)
    loss0 = float(m["loss"])
    params, opt, m = step_fn(params, opt, batch)
    peak_none, wall_none = torch.cuda.max_memory_allocated() - base, times[1]
    require(math.isfinite(loss0), "path 9: remat none loss not finite")
    # where a remat-block step's time goes, from the profiler: the card's
    # kernel time (busy) of the whole step, of loss + gradients and of
    # AdamW, each beside its host wall
    from repro_torch import tree as T
    from repro_torch.train.trainer import make_loss_fn, value_and_grad

    tcb = dataclasses.replace(tc, remat="block")
    step_b, loss_fn = orig(cfg, tcb), make_loss_fn(cfg, tcb)
    prof = {"step": _profile_steps(lambda: step_b(params, opt, batch), 2),
            "loss_and_grads": _profile_steps(
                lambda: value_and_grad(loss_fn, params, batch), 2)}
    grads = T.unflatten(params, value_and_grad(loss_fn, params, batch)[1])
    prof["adamw"] = _profile_steps(
        lambda: adamw.adamw_update(params, grads, opt, tcb), 2)
    del grads
    print("  remat block step (torch.profiler, 2 calls each): " + "; ".join(
        f"{k} {w * 1e3:.1f} ms wall ({wp * 1e3:.1f} profiled), "
        f"{busy * 1e3:.1f} ms busy on the card"
        for k, (w, wp, busy) in prof.items()), flush=True)
    print(f"  remat none: step 0 loss {loss0:.4f} (the block run's "
          f"{losses[0]:.4f}); a step {wall_none * 1e3:.1f} ms wall; peak "
          f"memory {peak_none / gb:.2f} GB against {peak / gb:.2f} GB with "
          "remat block", flush=True)
    # one more fresh model with int8 error feedback: its f32 residual (4
    # bytes a parameter) beside the moments, and the compression's
    # leaf-by-leaf temporaries
    del params, opt, m, step_b
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tce = dataclasses.replace(tcb, grad_compression="int8_ef")
    pred_ef = sum(pred.values()) + 4 * n
    params = api.init_model(cfg, seed=0, device=DEV)
    opt = adamw.init_opt_state(params, tce)
    step_fn = timed(cfg, tce)
    times.clear()
    gnorms.clear()
    ef_losses = []
    for _ in range(2):
        params, opt, m = step_fn(params, opt, batch)
        ef_losses.append(float(m["loss"]))
    peak_ef = torch.cuda.max_memory_allocated() - base
    require(all(math.isfinite(x) for x in ef_losses + gnorms),
            "path 9: an int8_ef loss or gradient norm is not finite")
    print(f"  int8_ef: losses {ef_losses[0]:.4f}, {ef_losses[1]:.4f}; a step "
          f"{times[1] * 1e3:.1f} ms wall; peak memory {peak_ef / gb:.2f} GB "
          f"(predicted {pred_ef / gb:.1f} GB before activations and "
          f"temporaries); {time.perf_counter() - t_path:.1f}s in all",
          flush=True)
    RESULTS["path9"] = dict(
        params=n, predicted_bytes=pred, losses=losses,
        grad_norms=gnorms_main, step_wall_ms=wall * 1e3,
        step_walls_ms=[w * 1e3 for w in walls_main], tokens_per_s=tok_s,
        peak_mem_bytes=peak, remat_none_peak_mem_bytes=peak_none,
        remat_none_step_wall_ms=wall_none * 1e3,
        remat_none_step0_loss=loss0,
        block_profile_ms={k: {"wall": w * 1e3, "wall_profiled": wp * 1e3,
                              "busy": busy * 1e3}
                          for k, (w, wp, busy) in prof.items()},
        int8_ef=dict(losses=ef_losses, grad_norms=list(gnorms),
                     step_wall_ms=times[1] * 1e3, peak_mem_bytes=peak_ef,
                     predicted_bytes=pred_ef),
        launches=counts)
    del params, opt, m
    return losses


# a train step from one state on the card against the CPU.  Losses and
# pre-clip grad norms rtol 1e-5.  An int8 code flips where a gradient sits
# within rounding of a half-code tie: the element's first moment moves by
# a tenth of a code step (~1/127 of the leaf's largest) and Adam's step
# moves its weight by up to ±lr (~3e-3 of 0.1); f32 noise moves either by
# ~1e-7 of the largest.  So per leaf (parameters and first moments) at most
# 1 % of the elements (or 2) may move by more than 1e-3 of the leaf's
# largest magnitude, and the rest agree within 1e-4 relative L2 (Adam's
# m̂ / (√v̂ + ε) where a gradient is near ε).  Free-running runs compound
# the flips (the first card run read 1.2 % moved after 3 steps).
TRAIN_STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "moved_share": 1e-2,
                  "params": 1e-4}
# 3 free-running steps, card against CPU: the flips compound, so the bound
# is the flip model's, not f32 noise's.  A flipped element moves its
# weight by up to ±lr, and each step's flips (~0.1-1 % of a leaf) seed
# more in the next; the card read 1.31e-3 relative L2 on the parameters
# (worst leaf) and 1.15e-5 on the losses.  Limits about four times that,
# far under a broken step (a sign or scale fault moves every element).
FREE_RUN_TOL = {"loss": 1e-4, "params": 5e-3}


def _moved_and_rest(a, b, moved_at=1e-3):
    """(elements of ``a`` more than ``moved_at`` of ``b``'s largest
    magnitude from ``b``; the relative L2 difference of the others)."""
    d = (a.double() - b.double()).abs()
    keep = d <= moved_at * float(b.abs().max())
    rest = float(d[keep].norm() / b.double()[keep].norm().clamp_min(1e-30))
    return int((~keep).sum()), rest


def path9b(ckpt_dir):
    """The training route held to its CPU version (no kernel is on it):
    codellama-7b smoke, f32 with TF32 off, ``microbatch=2`` and
    ``grad_compression="int8_ef"``, 3 steps.  Each step is checked from one
    state: the CPU's state before it (params, moments, residual) copied to
    the card, one step on each device, the results compared; then 3 steps
    run free on each device and their drift is printed.  Last, a
    checkpoint of the card's state after step 2, restored into a fresh
    trainer on the card, takes step 3, held to the uninterrupted run's."""
    from repro_torch import tree as T
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import make_train_step

    tol = TRAIN_STEP_TOL
    print(f"path 9b: codellama-7b smoke f32, microbatch 2, int8_ef, 3 train "
          f"steps on the card against the CPU, each from the CPU's state; "
          f"tolerances {tol}", flush=True)
    cfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=10,
                     microbatch=2, grad_compression="int8_ef")
    p0 = api.init_model(cfg, seed=0, device="cpu")
    step_fn = make_train_step(cfg, tc)
    data = {d: SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=32, global_batch=4), cfg,
                               device=d) for d in ("cpu", DEV)}

    def to(tree, device):
        return T.map_leaves(lambda t: t.to(device, copy=True), tree)

    def state_to(st, device):
        return adamw.OptState(st.step.to(device, copy=True),
                              to(st.mu, device), to(st.nu, device),
                              to(st.ef, device))

    K.reset_launch_counts()
    params = to(p0, "cpu")
    opt = adamw.init_opt_state(params, tc)
    worst = {"loss": 0.0, "grad_norm": 0.0, "moved_share": 0.0,
             "params": 0.0}
    for i in range(3):
        cparams, copt = to(params, DEV), state_to(opt, DEV)
        params, opt, m = step_fn(params, opt, data["cpu"].batch_at(i))
        cparams, copt, cm = step_fn(cparams, copt, data[DEV].batch_at(i))
        for k in ("loss", "grad_norm"):
            worst[k] = max(worst[k], abs(float(cm[k]) - float(m[k]))
                           / abs(float(m[k])))
        for tree_c, tree_h in ((cparams, params), (copt.mu, opt.mu)):
            for a, b in zip(T.leaves(tree_c), T.leaves(tree_h)):
                moved, rel = _moved_and_rest(a.cpu(), b)
                worst["moved_share"] = max(worst["moved_share"], max(
                    0, moved - 2) / a.numel())
                worst["params"] = max(worst["params"], rel)
    print(f"  worst relative differences a step {worst}", flush=True)
    for k, t in tol.items():
        require(worst[k] <= t, f"path 9b: {k} differs from the CPU's")

    def run(device, steps=3, params=None, opt=None, start=0):
        if params is None:
            params = to(p0, device)
            opt = adamw.init_opt_state(params, tc)
        out = []
        for i in range(start, start + steps):
            params, opt, m = step_fn(params, opt, data[device].batch_at(i))
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        to(params, "cpu")))
        return out, params, opt

    cpu, card = run("cpu")[0], run(DEV)[0]
    drift = max(float((a.double() - b.double()).norm() / b.double().norm())
                for a, b in zip(T.leaves(card[-1][2]), T.leaves(cpu[-1][2])))
    loss_drift = max(abs(c[0] - h[0]) / abs(h[0]) for c, h in zip(card, cpu))
    print(f"  free-running 3 steps: losses card "
          f"{[round(x[0], 6) for x in card]}, cpu "
          f"{[round(x[0], 6) for x in cpu]} (within {loss_drift:.3g} "
          f"relative); parameters after step 3 within {drift:.3g} relative "
          f"L2, worst leaf; limits {FREE_RUN_TOL}", flush=True)
    require(all(math.isfinite(x[0]) for x in card) and
            card[-1][0] < card[0][0], "path 9b: the loss did not fall")
    require(loss_drift <= FREE_RUN_TOL["loss"] and
            drift <= FREE_RUN_TOL["params"],
            "path 9b: the free-running steps drift past the flip model")
    # save after step 2, restore into a fresh trainer, take step 3
    _, params, opt = run(DEV, steps=2)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(2, (params, opt))
    fresh = to(p0, DEV)
    (params, opt), meta = mgr.restore(
        (fresh, adamw.init_opt_state(fresh, tc)), device=DEV)
    resumed = run(DEV, steps=1, params=params, opt=opt, start=2)[0][0]
    bitwise = resumed[0] == card[2][0] and all(
        torch.equal(a, b) for a, b in zip(T.leaves(resumed[2]),
                                          T.leaves(card[2][2])))
    rel = max(float((a.double() - b.double()).norm() / b.double().norm())
              for a, b in zip(T.leaves(resumed[2]), T.leaves(card[2][2])))
    print(f"  restored at step 2, step 3: loss {resumed[0]:.6f} against "
          f"{card[2][0]:.6f} uninterrupted; parameters "
          f"{'bitwise equal' if bitwise else f'within {rel:.3g} rel L2'}",
          flush=True)
    require(abs(resumed[0] - card[2][0]) <= 1e-6 * abs(card[2][0]) and
            rel <= 1e-5, "path 9b: the restored step differs")
    require(not any(K.launch_counts().values()),
            "path 9b: a kernel ran in training")
    RESULTS["path9b"] = dict(tolerances=tol, worst_a_step=worst,
                             free_tolerances=FREE_RUN_TOL, free_drift=drift,
                             free_loss_drift=loss_drift,
                             losses_card=[x[0] for x in card],
                             losses_cpu=[x[0] for x in cpu],
                             restored_bitwise=bitwise, restored_rel=rel)
    return dict(cfg=cfg, tc=tc, p0=p0, data=data[DEV], ckpt=ckpt_dir)


def _to_meta(tree):
    """``tree`` with every tensor (and quantized weight) as a meta tensor
    of its shape and dtype: nothing copied."""
    from repro_torch import tree as T

    return T.map_leaves(lambda t: t.map(lambda u: u.to("meta"))
                        if isinstance(t, QuantizedTensor) else t.to("meta"),
                        tree)


def path10a(eng):
    """The whole-step roofline share of path 1: ``launch/op_cost.py`` over
    meta copies of path 1's decode step (the call its decode graph replays:
    ``api.decode_paged_fn`` at batch 4 against path 1's pools and page
    table) and of one prefill chunk (B=2, T=256), the H100 SXM's constants
    (``launch/roofline.py``) for the bound, and the decode step's device ms
    from :func:`profile_decode`: share = bound / device ms."""
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.op_cost import op_cost
    from repro_torch.models import api

    cfg, b = eng.cfg, 4
    params, pools = _to_meta(eng.params), _to_meta(eng.pools)
    i32 = dict(dtype=torch.int32, device="meta")
    K.reset_launch_counts()
    dec = op_cost(api.decode_paged_fn, params,
                  {"token": torch.empty(b, 1, **i32),
                   "position": torch.empty(b, **i32)}, pools,
                  torch.empty(b, eng.P, **i32), cfg)
    pre = op_cost(api.prefill_chunk_fn, params,
                  {"tokens": torch.empty(2, 256, **i32)}, pools,
                  torch.empty(2, eng.P, **i32), torch.empty(2, **i32),
                  torch.empty(2, **i32), cfg,
                  last_idx=torch.empty(2, **i32))
    require(not any(K.launch_counts().values()),
            "path 10a: a kernel launched on meta tensors")
    prof = RESULTS["profile"]
    dev_ms = prof["device_busy_s"] / prof["decode_steps"] * 1e3
    out = {}
    for name, c in (("decode", dec), ("prefill_chunk", pre)):
        rl = RL.Roofline(flops=c["flops"], hbm_bytes=c["bytes"],
                         coll_bytes=0.0, chips=1, model_flops=0.0)
        bound_ms = max(rl.t_compute, rl.t_memory) * 1e3
        require(math.isfinite(bound_ms) and bound_ms > 0,
                f"path 10a: no bound for the {name}")
        out[name] = dict(flops=c["flops"], bytes=c["bytes"],
                         t_compute_ms=rl.t_compute * 1e3,
                         t_memory_ms=rl.t_memory * 1e3, bound_ms=bound_ms,
                         bytes_by_op=c["bytes_by_op"])
        top = ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in sorted(
            c["bytes_by_op"].items(), key=lambda kv: -kv[1])[:5])
        print(f"  {name}: {c['flops']:.6g} FLOPs, {c['bytes']:.6g} bytes "
              f"({top}); t_compute {rl.t_compute * 1e3:.4f} ms, t_memory "
              f"{rl.t_memory * 1e3:.4f} ms, bound {bound_ms:.4f} ms",
              flush=True)
    share = out["decode"]["bound_ms"] / dev_ms
    require(math.isfinite(share) and share > 0, "path 10a: no share")
    print(f"  decode step: bound {out['decode']['bound_ms']:.4f} ms against "
          f"{dev_ms:.4f} device ms (profile_decode): share {share:.4f}",
          flush=True)
    RESULTS["path10a"] = dict(out, device_ms=dev_ms, share=share)


TEN_B_TOL = {"loss": 1e-6, "params": 1e-6}


def path10b(state):
    """The local mesh on the card: a (1, 1) ``DeviceMesh`` on ``cuda``
    (one rank, NCCL, a ``FileStore`` group).  Path 9b's train checkpoint
    restored with placements must equal ``restore(device="cuda")`` bit for
    bit, leaf by leaf; then one codellama-smoke train step with the params
    and optimizer state placed as ``DTensor`` s, from that state, held to
    the unplaced step (``TEN_B_TOL``: relative loss, worst leaf's relative
    L2); the group is destroyed before the next path."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree as T
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import mesh as LMESH
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    from repro_torch.train.trainer import make_train_step

    cfg, tc, p0, data, ckpt = (state[k] for k in ("cfg", "tc", "p0", "data",
                                                  "ckpt"))
    print(f"path 10b: a (1, 1) mesh on the card; path 9b's checkpoint "
          f"restored with placements, one placed train step; tolerances "
          f"{TEN_B_TOL}", flush=True)
    mesh = LMESH.make_local_mesh(device_type="cuda")
    require(tuple(mesh.shape) == (1, 1), "path 10b: not a (1, 1) mesh")
    K.reset_launch_counts()
    fresh = T.map_leaves(lambda t: t.to(DEV, copy=True), p0)
    like = (fresh, adamw.init_opt_state(fresh, tc))
    pspecs = rules.param_specs(fresh, mesh, cfg)
    ospecs = rules.opt_specs(like[1], pspecs, mesh)
    mgr = CheckpointManager(ckpt)
    (params, opt), _ = mgr.restore(like, device=DEV)
    (dparams, dopt), _ = mgr.restore(like, mesh=mesh,
                                     specs=(pspecs, ospecs))
    n = 0

    def same(t, spec, want):
        nonlocal n
        require(isinstance(t, DTensor) and t.placements == tuple(
            rules.placements(spec, mesh)), "path 10b: a leaf not placed")
        require(t.to_local().dtype == want.dtype
                and torch.equal(t.to_local(), want),
                "path 10b: a placed leaf differs from the plain restore")
        n += 1

    for placed, plain, specs in ((dparams, params, pspecs),
                                 (dopt, opt, ospecs)):
        flat = T.leaves(plain) if not isinstance(plain, adamw.OptState) \
            else [plain.step, *T.leaves(plain.mu), *T.leaves(plain.nu),
                  *T.leaves(plain.ef)]
        it = iter(flat)
        rules.map_specs(lambda t, sp: same(t, sp, next(it)), placed, specs)
    print(f"  restore with placements: {n} leaves, every one bitwise equal "
          "to restore(device='cuda')", flush=True)
    step = make_train_step(cfg, tc)
    batch = data.batch_at(3)
    dbatch = rules.map_specs(lambda t, sp: distribute_tensor(
        t, mesh, rules.placements(sp, mesh)), batch,
        rules.batch_specs(batch, mesh))
    p1, _, m1 = step(params, opt, batch)
    with implicit_replication():
        p2, _, m2 = step(dparams, dopt, dbatch)
    torch.cuda.synchronize()
    l2 = m2["loss"].full_tensor() if isinstance(m2["loss"], DTensor) \
        else m2["loss"]
    loss_rel = abs(float(l2) - float(m1["loss"])) / abs(float(m1["loss"]))
    rel = max(float((a.full_tensor().double() - b.double()).norm()
                    / b.double().norm().clamp_min(1e-30))
              for a, b in zip(T.leaves(p2), T.leaves(p1)))
    bitwise = all(torch.equal(a.full_tensor(), b)
                  for a, b in zip(T.leaves(p2), T.leaves(p1)))
    print(f"  placed step: loss {float(l2):.6f} against {float(m1['loss']):.6f}"
          f" unplaced (relative {loss_rel:.3g}); parameters "
          f"{'bitwise equal' if bitwise else f'within {rel:.3g} rel L2'}",
          flush=True)
    require(loss_rel <= TEN_B_TOL["loss"] and rel <= TEN_B_TOL["params"],
            "path 10b: the placed step differs from the unplaced one")
    require(not any(K.launch_counts().values()),
            "path 10b: a kernel ran in training")
    LMESH.close_mesh()
    RESULTS["path10b"] = dict(tolerances=TEN_B_TOL, leaves=n,
                              loss_rel=loss_rel, params_rel=rel,
                              bitwise=bitwise)


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
    check_k1_widths()
    check_k1_ssm()
    check_k1_whisper()
    b67, b4, b89 = check_grouped(), check_flash(), check_mla()
    check_mla_long()
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
    path2c()
    gc.collect()
    torch.cuda.empty_cache()
    counts3 = path3()
    gc.collect()
    torch.cuda.empty_cache()
    path3_group256()
    gc.collect()
    torch.cuda.empty_cache()
    counts4, counts4b = path4()
    gc.collect()
    torch.cuda.empty_cache()
    path5()
    gc.collect()
    torch.cuda.empty_cache()
    path6()
    gc.collect()
    torch.cuda.empty_cache()
    path7()
    gc.collect()
    torch.cuda.empty_cache()
    path8()
    gc.collect()
    torch.cuda.empty_cache()
    path9()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt:
        state = path9b(ckpt)
        gc.collect()
        torch.cuda.empty_cache()
        path10b(state)

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
