"""Device times of the port's attention kernels on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_attn [--reps N]
        [--only REGEX] [--json PATH]

K2 (``gqa_paged_attention_cuda`` and its int8 branch) and K3
(``gqa_paged_prefill_cuda`` and its int8 branch) at the cases of
``chip_smoke.py``: the kernel table's (K2: batch 4, 32 KV heads, lengths
1024/700/333/17, grp 1 and 8, f32/bf16/int8 pools; K3: batch 4, T = 64 and
256, without and with prefixes 256/130/64/0, its four pool/suffix
instances) and the paths' own shapes (codellama-7b decode and chunks, f32
and int8 pools; granite's Hkv=8, grp=2, Dh=64), and a 128-token chunk
behind a 1920-token prefix (f32 and int8 pools).  B8
(``mla_paged_attention_cuda`` and its int8 branch) and B9
(``mla_paged_prefill_cuda`` and its int8 branch) at deepseek-v2-236b's
width (128 heads, r = 512, dr = 64, PS = 16), f32/bf16/int8 latent pools:
B8 at path 4's decode lengths, B9 on path 4's 128-token chunk after a
128-token prefix and on the ragged 32-token chunks of ``chip_smoke.py``
(int8 pools with an f32 suffix); beside B8/B9's path 4 cases, the library
yardstick ``scaled_dot_product_attention`` on the same dense rows (key
``[ckv ‖ kpe]``, value ``ckv``, one KV head, int8 dequantized to f32).  B4
(``flash_attention_cuda``) at the cases of ``chip_smoke.py``: path 3's
calibration shape (granite-moe-1b-a400m: H=16, Hkv=8, D=64, T=24), granite
at T=64 and 2048 (f32 and bf16), codellama-7b's heads (H=Hkv=32, D=128) at
T=2048, causal, and granite's heads non-causal at T=1024, each with SDPA
(``enable_gqa``, same type) beside it (``--only B4`` for those alone).  A
case's time is a CUDA graph of 24 calls cycling through pool copies that
together exceed L2, replayed, CUDA-event time per call (device time).  Each
case is timed ``--reps`` times, the passes interleaved over the cases;
``--only`` keeps the cases whose "KERNEL CASE" label (as printed) matches a
regex.

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
    # chip_smoke.py's long prefix: P V summed over 2048 keys
    out += [(f"prefix1920 {kind}/f32", 1, 128, 32, 1, 128, [1920], [128],
             kind, "f32") for kind in ("f32", "int8")]
    return out


MLA = dict(h=128, r=512, dr=64, ps=16, scale=(128 + 64) ** -0.5)


def _mla_pools(dev, gen, lengths, kind):
    """((ckv, kpe, ckv_scale, kpe_scale), table) of deepseek's latent
    pools: shuffled live pages, trash page 0 (scales None for fp pools)."""
    ps, r, dr = MLA["ps"], MLA["r"], MLA["dr"]
    pages = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(pages)
    if kind == torch.int8:
        ckv, kpe = (torch.randint(-127, 128, (n_pages, ps, d), generator=gen,
                                  device=dev, dtype=torch.int8)
                    for d in (r, dr))
        cs, pe = (torch.rand(n_pages, ps, generator=gen, device=dev) * 0.03
                  + 1e-3 for _ in range(2))
    else:
        ckv, kpe = (torch.randn(n_pages, ps, d, generator=gen,
                                device=dev).to(kind) for d in (r, dr))
        cs = pe = None
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(0)) + 1
    table = torch.zeros(len(lengths), max(max(pages), 1), dtype=torch.int32)
    i0 = 0
    for i, n in enumerate(pages):
        table[i, :n] = perm[i0:i0 + n].to(torch.int32)
        i0 += n
    return (ckv, kpe, cs, pe), table.to(dev)


def _dense(pools, table, rows, ldt):
    """The library's [B, 1, rows, r + dr] keys and [B, 1, rows, r] values:
    the pools' first ``rows`` rows of each slot, dequantized."""
    g = [None if t is None else t[table.long()].flatten(1, 2)[:, :rows]
         .float() for t in pools]
    ckv, kpe = g[0], g[1]
    if g[2] is not None:
        ckv, kpe = ckv * g[2][..., None], kpe * g[3][..., None]
    return (torch.cat([ckv, kpe], -1)[:, None].to(ldt).contiguous(),
            ckv[:, None].to(ldt).contiguous())


def b8_cases():
    """(label, lengths, pool kind)"""
    return [(f"path4 {k}", PATH_LENS, k) for k in KINDS]


def b9_cases():
    """(label, t, prefix, chunk, pool kind, suffix kind)"""
    inst = (("f32", "f32"), ("bf16", "bf16"), ("int8", "f32"))
    out = [(f"path4 {k}/{s}", 128, [128], [128], k, s) for k, s in inst]
    out += [(f"ragged {k}/{s}", 32, [96, 50, 0, 0], [32, 29, 16, 1], k, s)
            for k, s in inst]
    return out


def mla_cases(dev, gen, keep):
    """B8 and B9 cases (and SDPA beside their path 4 cases)."""
    from repro_torch.kernels import paged_attention as PA

    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, r, dr, sc = MLA["h"], MLA["r"], MLA["dr"], MLA["scale"]
    out = []
    for label, lengths, kind in b8_cases():
        dt = KINDS[kind]
        pools, table = _mla_pools(dev, gen, lengths, dt)
        b = len(lengths)
        q_lat = torch.randn(b, h, r, generator=gen, device=dev)
        q_pe = torch.randn(b, h, dr, generator=gen, device=dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        fn = (PA.mla_paged_attention_int8_cuda if dt == torch.int8
              else PA.mla_paged_attention_cuda)
        x = 2 if dt == torch.int8 else 0
        if keep(f"B8 {label}"):
            out.append(("B8", label, [
                lambda c=c, fn=fn, x=x, q_lat=q_lat, q_pe=q_pe, tb=table,
                ln=lens: fn(q_lat, q_pe, c[0], c[1], tb, ln, *c[2:2 + x],
                            sm_scale=sc)
                for c in _copies(pools)]))
        if keep(f"SDPA B8 {label}"):
            ldt = torch.float32 if dt == torch.int8 else dt
            s = max(lengths)
            kd, vd = _dense(pools, table, s, ldt)
            qd = torch.cat([q_lat, q_pe], -1)[:, :, None].to(ldt)
            mask = (torch.arange(s, device=dev)[None, :]
                    < lens[:, None].long())[:, None, None, :]
            out.append(("SDPA", f"B8 {label}", [
                lambda qd=qd, kd=kd, vd=vd, mask=mask: sdpa(
                    qd, kd, vd, attn_mask=mask, scale=sc, enable_gqa=True)]))
    for label, t, prefix, chunk, kind, sdt in b9_cases():
        dt = KINDS[kind]
        b = len(prefix)
        pools, table = _mla_pools(dev, gen, [p + c for p, c in
                                             zip(prefix, chunk)], dt)
        q_lat = torch.randn(b, t, h, r, generator=gen, device=dev)
        q_pe = torch.randn(b, t, h, dr, generator=gen, device=dev)
        c_suf, k_suf = (torch.randn(b, t, d, generator=gen, device=dev)
                        .to(KINDS[sdt]) for d in (r, dr))
        pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
        cl = torch.tensor(chunk, dtype=torch.int32, device=dev)
        fn = (PA.mla_paged_prefill_int8_cuda if dt == torch.int8
              else PA.mla_paged_prefill_cuda)
        x = 2 if dt == torch.int8 else 0
        if keep(f"B9 {label}"):
            out.append(("B9", label, [
                lambda c=c, fn=fn, x=x, q_lat=q_lat, q_pe=q_pe, c_suf=c_suf,
                k_suf=k_suf, tb=table, pl=pl, cl=cl:
                fn(q_lat, q_pe, c_suf, k_suf, c[0], c[1], tb, pl, cl,
                   *c[2:2 + x], sm_scale=sc)
                for c in _copies(pools)]))
        if label.startswith("path4") and keep(f"SDPA B9 {label}"):
            ldt = torch.float32 if dt == torch.int8 else dt
            s = max(prefix)
            kd, vd = _dense(pools, table, s, ldt)
            kd = torch.cat([kd, torch.cat([c_suf, k_suf], -1).float()[
                :, None].to(ldt)], dim=2)
            vd = torch.cat([vd, c_suf.float()[:, None].to(ldt)], dim=2)
            qd = torch.cat([q_lat, q_pe], -1).permute(0, 2, 1, 3).to(ldt)
            kv = torch.arange(s, device=dev)
            j = torch.arange(t, device=dev)
            pre = (kv[None, None, :] < pl.long()[:, None, None]).expand(
                b, t, s)
            suf = (j[None, None, :] <= j[None, :, None]) \
                & (j[None, None, :] < cl.long()[:, None, None])
            mask = torch.cat([pre, suf], dim=-1)[:, None]
            out.append(("SDPA", f"B9 {label}", [
                lambda qd=qd, kd=kd, vd=vd, mask=mask: sdpa(
                    qd, kd, vd, attn_mask=mask, scale=sc, enable_gqa=True)]))
    return out


def b4_cases():
    """(label, b, t, h, hkv, d, causal, type)"""
    return [("path3 T=24 f32", 1, 24, 16, 8, 64, True, "f32"),
            ("granite T=64 f32", 1, 64, 16, 8, 64, True, "f32"),
            ("granite T=2048 f32", 1, 2048, 16, 8, 64, True, "f32"),
            ("granite T=2048 bf16", 1, 2048, 16, 8, 64, True, "bf16"),
            ("codellama T=2048 f32", 1, 2048, 32, 32, 128, True, "f32"),
            ("non-causal T=1024 f32", 1, 1024, 16, 8, 64, False, "f32")]


def flash_cases(dev, gen, keep):
    """B4 cases, SDPA beside each (on [B, heads, T, D] copies)."""
    from repro_torch.kernels import flash_attention as FA

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for label, b, t, h, hkv, d, causal, kind in b4_cases():
        dt = KINDS[kind]
        q = torch.randn(b, t, h, d, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dt)
                for _ in range(2))
        if keep(f"B4 {label}"):
            out.append(("B4", label, [
                lambda c=c, cz=causal: FA.flash_attention_cuda(*c, causal=cz)
                for c in _copies((q, k, v))]))
        if keep(f"SDPA B4 {label}"):
            dense = tuple(a.transpose(1, 2).contiguous() for a in (q, k, v))
            out.append(("SDPA", f"B4 {label}", [
                lambda c=c, cz=causal: sdpa(*c, is_causal=cz,
                                            enable_gqa=True)
                for c in _copies(dense)]))
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
    return out + mla_cases(dev, gen, keep) + flash_cases(dev, gen, keep)


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
