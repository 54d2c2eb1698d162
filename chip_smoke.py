"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--json PATH]

Needs one NVIDIA GPU (sm_90a) and nvcc; exits non-zero without printing a
result when there is no card or when run outside a checkout of the repo.
Imports neither JAX nor the JAX package.  Phases, each fatal on failure:

1. setup — card name and power limit, torch/CUDA versions, kernel build time
   (one nvcc per source, in parallel);
2. kernels — K1 (W4A16 GEMM), K2 (paged decode), K3 (paged chunked prefill)
   against their plain PyTorch versions at the main path's shapes, in f32 and
   bf16, with CUDA-event times beside the plain version's, one PyTorch
   library call's (never used by the port) and the card's bound;
3. main path — codellama-7b at full width with random seeded weights:
   SmoothQuant+ quantize-on-load in f32 (G=128), then 8 requests (prompts of
   32-200 tokens, 16 new tokens, batch 4, greedy) through the serving engine
   with every launch counter read; one prefill and one decode step checked
   against the same step on the dequantized weights with the dense-gather
   attention oracle;
4. summary — a ``kernels`` JSON line, the card line, and the final ``ok``
   line.  ``--json PATH`` also writes every measurement to PATH.

TF32 is disabled for matmuls and convolutions: f32 work is full f32.
"""
from __future__ import annotations

import argparse
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

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device available")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core.quantize import dequantize, quantize  # noqa: E402
from repro_torch.device import strict_fp32_matmul  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import w4a16_matmul as W4  # noqa: E402

HBM_BYTES_S = 3.35e12                 # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12,   # CUDA-core f32 (the kernels' route)
              torch.bfloat16: 989e12}
L2_BYTES = 50 * 2 ** 20
DEV = torch.device("cuda")
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


def bound(nbytes, flops, dtype):
    t_b, t_f = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def record(kernel, case, err, tol, ms, plain_ms, lib_ms, bnd, by):
    row = dict(kernel=kernel, case=case, max_abs_err=err, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
               bound_by=by)
    RESULTS["rows"].append(row)
    print(f"  {kernel:18s} {case:44s} err={err:.3g} (tol {tol:.3g}) "
          f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms library={lib_ms:.4f}ms "
          f"bound={bnd:.4f}ms ({by})", flush=True)
    require(err <= tol, f"{kernel} {case}: max |kernel - plain| = {err} > {tol}")
    return row


# --------------------------------------------------------------- kernels ---
def check_k1():
    print("K1 w4a16_matmul (replaces repro/kernels/w4a16_matmul.py:_kernel)")
    rows = {}
    for ci, co in ((4096, 4096), (4096, 11008), (11008, 4096)):
        gen = torch.Generator(device=DEV).manual_seed(ci + co)
        w = torch.randn(ci, co, generator=gen, device=DEV) * ci ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            qt = quantize(w, group_size=128, dtype=dt)
            n_copy = max(1, math.ceil(2 * L2_BYTES / qt.nbytes_quant()))
            qts = [qt] + [qt.map(torch.clone) for _ in range(n_copy - 1)]
            w_lib = dequantize(qt, torch.bfloat16)
            libs = [w_lib] + [w_lib.clone() for _ in range(
                max(0, math.ceil(2 * L2_BYTES / w_lib.nbytes) - 1))]
            for t in (4, 64, 512):
                x = torch.randn(t, ci, generator=gen, device=DEV).to(dt)
                ref = W4.w4a16_matmul_plain(x, qt)
                y = W4.w4a16_matmul_cuda(x, qt)
                torch.cuda.synchronize()
                scale = max(1.0, float(ref.float().abs().max()))
                tol = (1e-5 if dt == torch.float32 else 1e-2) * scale
                ms = time_ms([lambda q=q: W4.w4a16_matmul_cuda(x, q)
                              for q in qts])
                plain = time_ms([lambda q=q: W4.w4a16_matmul_plain(x, q)
                                 for q in qts])
                xb = x.to(torch.bfloat16)
                lib = time_ms([lambda m=m: torch.matmul(xb, m) for m in libs])
                el = x.element_size()
                nbytes = (t * ci * el + qt.nbytes_quant() + t * co * el)
                bnd, by = bound(nbytes, 2.0 * t * ci * co, dt)
                case = f"T={t} {ci}x{co} G=128 {str(dt)[6:]}"
                rows[(t, ci, co, dt)] = record("w4a16_matmul", case,
                                               max_err(y, ref), tol, ms,
                                               plain, lib, bnd, by)
            del qts, libs
    return rows


def _paged_inputs(b, hkv, grp, lengths, dt, ps=16, seed=0):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    pages = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(pages)
    kp = torch.randn(n_pages, ps, hkv, 128, generator=gen, device=DEV).to(dt)
    vp = torch.randn(n_pages, ps, hkv, 128, generator=gen, device=DEV).to(dt)
    p_max = max(max(pages), 1)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(
        seed))[:] + 1
    table = torch.zeros(b, p_max, dtype=torch.int32)
    k = 0
    for i, n in enumerate(pages):
        table[i, :n] = perm[k:k + n].to(torch.int32)
        k += n
    return kp, vp, table.to(DEV), gen


def _dense(pool, table, rows):
    """Gathered dense [B, Hkv, rows, D] view for the library yardstick."""
    g = PA._gather(pool, table)[:, :rows]
    return g.permute(0, 2, 1, 3).contiguous()


def check_k2():
    print("K2 gqa_paged_decode (replaces repro/kernels/paged_attention.py:"
          "_gqa_kernel)")
    rows = {}
    lengths = [1024, 700, 333, 17]
    b, hkv = 4, 32
    for grp in (1, 8):
        for dt in (torch.float32, torch.bfloat16):
            kp, vp, table, gen = _paged_inputs(b, hkv, grp, lengths, dt,
                                               seed=grp)
            lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
            q = torch.randn(b, hkv, grp, 128, generator=gen, device=DEV)
            sc = 128 ** -0.5
            ref = PA.gqa_paged_attention_plain(q, kp, vp, table, lens,
                                               sm_scale=sc)
            out = PA.gqa_paged_attention_cuda(q, kp, vp, table, lens,
                                              sm_scale=sc)
            torch.cuda.synchronize()
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            ms = time_ms([lambda: PA.gqa_paged_attention_cuda(
                q, kp, vp, table, lens, sm_scale=sc)])
            plain = time_ms([lambda: PA.gqa_paged_attention_plain(
                q, kp, vp, table, lens, sm_scale=sc)])
            s = max(lengths)
            kd = _dense(kp, table, s).repeat_interleave(grp, dim=1)
            vd = _dense(vp, table, s).repeat_interleave(grp, dim=1)
            mask = (torch.arange(s, device=DEV)[None, :]
                    < lens[:, None].long())[:, None, None, :]
            qd = q.reshape(b, hkv * grp, 1, 128).to(dt)
            lib = time_ms([lambda: torch.nn.functional.
                           scaled_dot_product_attention(qd, kd, vd,
                                                        attn_mask=mask)])
            el = kp.element_size()
            live = sum(lengths)
            nbytes = (q.numel() * 4 + live * hkv * 256 * el
                      + table.numel() * 4 + b * 4 + out.numel() * 4)
            flops = 2.0 * live * hkv * grp * 256
            bnd, by = bound(nbytes, flops, dt)
            case = f"B=4 Hkv=32 grp={grp} lens={lengths} {str(dt)[6:]}"
            rows[(grp, dt)] = record("gqa_paged_decode", case,
                                     max_err(out, ref), tol, ms, plain, lib,
                                     bnd, by)
    return rows


def check_k3():
    print("K3 gqa_paged_prefill (replaces repro/kernels/paged_attention.py:"
          "_gqa_prefill_kernel)")
    rows = {}
    b, hkv, grp = 4, 32, 1
    for t in (64, 256):
        for prefix in ([0, 0, 0, 0], [256, 130, 64, 0]):
            chunk = [t, t - 7, t // 2, 1]
            for dt in (torch.float32, torch.bfloat16):
                kp, vp, table, gen = _paged_inputs(
                    b, hkv, grp, [p + c for p, c in zip(prefix, chunk)], dt,
                    seed=t + prefix[0])
                pl = torch.tensor(prefix, dtype=torch.int32, device=DEV)
                cl = torch.tensor(chunk, dtype=torch.int32, device=DEV)
                q = torch.randn(b, t, hkv, grp, 128, generator=gen,
                                device=DEV)
                ks = torch.randn(b, t, hkv, 128, generator=gen,
                                 device=DEV).to(dt)
                vs = torch.randn(b, t, hkv, 128, generator=gen,
                                 device=DEV).to(dt)
                sc = 128 ** -0.5
                args = (q, ks, vs, kp, vp, table, pl, cl)
                ref = PA.gqa_paged_prefill_plain(*args, sm_scale=sc)
                out = PA.gqa_paged_prefill_cuda(*args, sm_scale=sc)
                torch.cuda.synchronize()
                tol = 1e-5 * max(1.0, float(ref.abs().max()))
                ms = time_ms([lambda: PA.gqa_paged_prefill_cuda(
                    *args, sm_scale=sc)])
                plain = time_ms([lambda: PA.gqa_paged_prefill_plain(
                    *args, sm_scale=sc)])
                s = max(prefix)
                kd = torch.cat([_dense(kp, table, s),
                                ks.permute(0, 2, 1, 3)], dim=2).contiguous()
                vd = torch.cat([_dense(vp, table, s),
                                vs.permute(0, 2, 1, 3)], dim=2).contiguous()
                kv = torch.arange(s, device=DEV)
                j = torch.arange(t, device=DEV)
                pre = (kv[None, None, :] < pl.long()[:, None, None]).expand(
                    b, t, s)
                suf = (j[None, None, :] <= j[None, :, None]) \
                    & (j[None, None, :] < cl.long()[:, None, None])
                mask = torch.cat([pre, suf], dim=-1)[:, None]
                qd = q.reshape(b, t, hkv, 128).permute(0, 2, 1, 3).to(
                    dt).contiguous()
                lib = time_ms([lambda: torch.nn.functional.
                               scaled_dot_product_attention(
                                   qd, kd, vd, attn_mask=mask)])
                el = kp.element_size()
                keys = sum(p * t + sum(min(i + 1, c) for i in range(t))
                           for p, c in zip(prefix, chunk))
                nbytes = (q.numel() * 4 + (ks.numel() + vs.numel()) * el
                          + sum(prefix) * hkv * 256 * el + table.numel() * 4
                          + 2 * b * 4 + out.numel() * 4)
                flops = 2.0 * keys * hkv * grp * 256
                bnd, by = bound(nbytes, flops, dt)
                case = (f"B=4 T={t} Hkv=32 prefix={prefix} chunk="
                        f"{chunk} {str(dt)[6:]}")
                rows[(t, sum(prefix) > 0, dt)] = record(
                    "gqa_paged_prefill", case, max_err(out, ref), tol, ms,
                    plain, lib, bnd, by)
    return rows


# ------------------------------------------------------------- main path ---
def dequantized_params(params):
    from repro_torch.core.quantize import QuantizedTensor

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if isinstance(node, QuantizedTensor):
            return dequantize(node, torch.float32)
        return node
    return conv(params)


@torch.no_grad()
def check_step_against_plain(eng, prompt):
    """One prefill chunk and one decode step through the kernels, against the
    same steps on the dequantized weights with the dense-gather oracle."""
    from repro_torch.models import lm as LM

    cfg, ps = eng.cfg, eng.PS
    pages = -(-(len(prompt) + 1) // ps)
    table = torch.arange(1, pages + 1, dtype=torch.int32,
                         device=DEV)[None]
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=DEV)[None]
    start = torch.zeros(1, dtype=torch.int32, device=DEV)
    clen = torch.tensor([len(prompt)], dtype=torch.int32, device=DEV)
    plain_params = dequantized_params(eng.params)
    logits = {}
    for name, params, c in (("kernel", eng.params, cfg),
                            ("plain", plain_params,
                             cfg.with_(paged_attn_impl="gather"))):
        pool = LM.init_paged_cache(c, pages + 1, ps, DEV)
        pre, pool = LM.lm_prefill_chunk(params, toks, pool, start, clen,
                                        table, c)
        nxt = torch.tensor([[int(prompt[-1])]], dtype=torch.int32, device=DEV)
        dec, _ = LM.lm_decode_paged(params, nxt, pool, clen, table, c)
        logits[name] = (pre, dec)
    del plain_params
    errs = []
    for i, step in enumerate(("prefill", "decode")):
        a, b = logits["kernel"][i], logits["plain"][i]
        require(bool(torch.isfinite(a).all()), f"{step} logits not finite")
        err = max_err(a, b)
        tol = 2e-3 * max(1.0, float(b.abs().max()))
        print(f"  {step} step logits vs plain: max |diff| = {err:.3g} "
              f"(tol {tol:.3g}), argmax {int(a.argmax())} vs "
              f"{int(b.argmax())}")
        require(err <= tol, f"{step} logits differ from the plain path")
        errs.append(err)
    return errs


def profile_decode(eng, reqs, steps=8):
    """Where a decode step's time goes, after the counted run: the main
    path's first four prompts again; one engine step prefills them all and
    starts decoding, then ``steps`` pure decode steps (batch 4) run under
    torch.profiler."""
    from repro_torch.serving.engine import Request

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for r in reqs[:4]:
        eng.submit(Request(uid=100 + r.uid, prompt=r.prompt,
                           max_tokens=steps + 2))
    eng.step()
    require(eng.stats.steps > 0 and not eng.queue,
            "profile window did not start decoding")
    torch.cuda.synchronize()
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
    print(f"  profile of {steps} decode steps: {wall * 1e3 / steps:.2f} ms "
          f"wall per step, {busy * 1e3 / steps:.2f} ms of device kernel time "
          f"per step (busy share {busy / wall:.3f})")
    for r in rows:
        print(f"    {r['device_s']:.4f}s {r['calls']:6d}x  {r['name']}")
    RESULTS["profile"] = dict(decode_steps=steps, wall_s=wall,
                              device_busy_s=busy, top=rows)


def main_path():
    from repro_torch.launch import serve

    print("main path: codellama-7b full width, SmoothQuant+ W4A16 f32, "
          "8 requests", flush=True)
    torch.cuda.reset_peak_memory_stats()
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
    tok_s = st.decoded_tokens / res["serve_s"]
    ttft = sorted(res["ttft_s"])
    print(f"  PTQ alpha={res['report'].alpha:.2f} in {res['ptq_s']:.1f}s; "
          f"served {st.completed} requests in {res['serve_s']:.2f}s: "
          f"{tok_s:.1f} decode tok/s, TTFT p50 {statistics.median(ttft):.3f}s "
          f"max {ttft[-1]:.3f}s, peak memory {peak / 2 ** 30:.2f} GiB")
    errs = check_step_against_plain(eng, reqs[0].prompt)
    RESULTS["main_path"] = dict(
        launches=counts, decode_steps=st.steps,
        prefill_batches=st.prefill_batches, decoded_tokens=st.decoded_tokens,
        prefilled_tokens=st.prefilled_tokens, serve_s=res["serve_s"],
        decode_tok_s=tok_s, ttft_s=ttft, ptq_s=res["ptq_s"],
        boot_s=res["boot_s"], alpha=res["report"].alpha,
        peak_mem_bytes=peak, prefill_logit_err=errs[0],
        decode_logit_err=errs[1])
    profile_decode(eng, reqs)
    return counts


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
    print(f"kernel build: {build_s:.1f}s (nvcc, sm_90a, 3 sources in "
          "parallel)", flush=True)
    RESULTS.update(card=card, torch=torch.__version__,
                   cuda=torch.version.cuda, build_s=build_s)

    k1, k2, k3 = check_k1(), check_k2(), check_k3()
    counts = main_path()

    # one row per kernel: its main-path shape, in the main path's f32
    picks = {
        "w4a16_matmul": (k1[(4, 4096, 11008, torch.float32)],
                         "csrc/w4a16_matmul.cu",
                         "src/repro/kernels/w4a16_matmul.py:72"),
        "gqa_paged_decode": (k2[(1, torch.float32)],
                             "csrc/gqa_paged_decode.cu",
                             "src/repro/kernels/paged_attention.py:65"),
        "gqa_paged_prefill": (k3[(256, False, torch.float32)],
                              "csrc/gqa_paged_prefill.cu",
                              "src/repro/kernels/paged_attention.py:315"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/{src}", "replaces": rep,
         "launches": counts[name], "max_abs_err": row["max_abs_err"],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"], "case": row["case"]}
        for name, (row, src, rep) in picks.items()]}
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
