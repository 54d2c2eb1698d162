"""Device times of the port's paged GQA attention kernels on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_attn [--reps N]
        [--only REGEX] [--json PATH]

K2 (``gqa_paged_attention_cuda`` and its int8 branch) and K3
(``gqa_paged_prefill_cuda`` and its int8 branch) at the cases of
``chip_smoke.py``: the kernel table's (K2: batch 4, 32 KV heads, lengths
1024/700/333/17, grp 1 and 8, f32/bf16/int8 pools; K3: batch 4, T = 64 and
256, without and with prefixes 256/130/64/0, its four pool/suffix
instances) and the paths' own shapes (codellama-7b decode and chunks, f32
and int8 pools; granite's Hkv=8, grp=2, Dh=64).  A case's time is a CUDA
graph of 24 wrapper calls cycling through pool copies that together exceed
L2, replayed, CUDA-event time per call (device time).  Each case is timed
``--reps`` times, the passes interleaved over the cases; ``--only`` keeps
the cases whose "KERNEL CASE" label (as printed) matches a regex.

The script calls only the kernels' public wrappers with arguments every
version of the port takes, so a copy of it (with ``bench_w4.py`` beside it)
runs in an older checkout: to compare two versions, run each checkout's
copy in turns (A, B, B, A) in one session on one card.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.launch.bench_w4 import L2_BYTES, graph_ms

TABLE_LENS = [1024, 700, 333, 17]
PATH_LENS = [216, 150, 90, 33]
KINDS = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _pools(dev, gen, lengths, ps, hkv, dh, kind):
    """(k, v, k_scale, v_scale, table): shuffled live pages, trash page 0."""
    pages = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(pages)
    shp = (n_pages, ps, hkv, dh)
    if kind == torch.int8:
        k, v = (torch.randint(-127, 128, shp, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shp[:3], generator=gen, device=dev) * 0.03
                  + 1e-3 for _ in range(2))
    else:
        k, v = (torch.randn(shp, generator=gen, device=dev).to(kind)
                for _ in range(2))
        ks = vs = None
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(0)) + 1
    table = torch.zeros(len(lengths), max(max(pages), 1), dtype=torch.int32)
    i0 = 0
    for i, n in enumerate(pages):
        table[i, :n] = perm[i0:i0 + n].to(torch.int32)
        i0 += n
    return (k, v, ks, vs), table.to(dev)


def _copies(pools):
    nbytes = sum(t.numel() * t.element_size() for t in pools if t is not None)
    n = max(1, math.ceil(2 * L2_BYTES / nbytes))
    return [pools] + [tuple(None if t is None else t.clone() for t in pools)
                      for _ in range(n - 1)]


def k2_cases():
    """(label, b, hkv, grp, dh, lengths, kind)"""
    out = [(f"grp={g} table {k}", 4, 32, g, 128, TABLE_LENS, k)
           for g in (1, 8) for k in KINDS]
    out += [("path1 f32", 4, 32, 1, 128, PATH_LENS, "f32"),
            ("path2 int8", 4, 32, 1, 128, PATH_LENS, "int8"),
            ("path3 f32", 4, 8, 2, 64, PATH_LENS, "f32")]
    return out


def k3_cases():
    """(label, b, t, hkv, grp, dh, prefix, chunk, pool kind, suffix kind)"""
    inst = (("f32", "f32"), ("bf16", "bf16"), ("int8", "f32"),
            ("int8", "bf16"))
    out = []
    for t in (64, 256):
        for prefix in ([0, 0, 0, 0], [256, 130, 64, 0]):
            for kind, sdt in inst:
                pre = "prefix" if prefix[0] else "noprefix"
                out.append((f"T={t} {pre} {kind}/{sdt}", 4, t, 32, 1, 128,
                            prefix, [t, t - 7, t // 2, 1], kind, sdt))
    out += [("path1 f32", 2, 256, 32, 1, 128, [0, 0], [256, 200], "f32",
             "f32"),
            ("path2 int8/f32", 1, 128, 32, 1, 128, [128], [128], "int8",
             "f32"),
            ("path3 f32", 2, 256, 8, 2, 64, [0, 0], [256, 200], "f32",
             "f32")]
    return out


def cases(dev, keep):
    """(name, case, [calls]) for every case whose label ``keep`` accepts."""
    from repro_torch.kernels import paged_attention as PA

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for label, b, hkv, grp, dh, lengths, kind in k2_cases():
        if not keep(f"K2 {label}"):
            continue
        dt = KINDS[kind]
        pools, table = _pools(dev, gen, lengths, 16, hkv, dh, dt)
        q = torch.randn(b, hkv, grp, dh, generator=gen, device=dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        fn = (PA.gqa_paged_attention_int8_cuda if dt == torch.int8
              else PA.gqa_paged_attention_cuda)
        extra = 2 if dt == torch.int8 else 0
        out.append(("K2", label, [
            lambda c=c, fn=fn, q=q, t=table, ln=lens, x=extra, s=dh ** -0.5:
            fn(q, c[0], c[1], t, ln, *c[2:2 + x], sm_scale=s)
            for c in _copies(pools)]))
    for label, b, t, hkv, grp, dh, prefix, chunk, kind, sdt in k3_cases():
        if not keep(f"K3 {label}"):
            continue
        dt = KINDS[kind]
        pools, table = _pools(dev, gen, [p + c for p, c in zip(prefix, chunk)],
                              16, hkv, dh, dt)
        q = torch.randn(b, t, hkv, grp, dh, generator=gen, device=dev)
        ks, vs = (torch.randn(b, t, hkv, dh, generator=gen,
                              device=dev).to(KINDS[sdt]) for _ in range(2))
        pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
        cl = torch.tensor(chunk, dtype=torch.int32, device=dev)
        fn = (PA.gqa_paged_prefill_int8_cuda if dt == torch.int8
              else PA.gqa_paged_prefill_cuda)
        extra = 2 if dt == torch.int8 else 0
        out.append(("K3", label, [
            lambda c=c, fn=fn, q=q, ks=ks, vs=vs, tb=table, pl=pl, cl=cl,
            x=extra, s=dh ** -0.5:
            fn(q, ks, vs, c[0], c[1], tb, pl, cl, *c[2:2 + x], sm_scale=s)
            for c in _copies(pools)]))
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
        sys.exit("bench_attn: no CUDA device available")
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
        for i, (_, _, fns) in enumerate(todo):
            times[i].append(graph_ms(fns, stream))
    rows = []
    for (name, case, _), ms in zip(todo, times):
        rows.append(dict(kernel=name, case=case, ms=ms,
                         median_ms=statistics.median(ms)))
        print(f"{name} {case:28s} median {statistics.median(ms):.4f} ms  "
              f"[{' '.join(f'{m:.4f}' for m in ms)}]", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(dict(card=card, rows=rows),
                                              indent=1))


if __name__ == "__main__":
    main()
