"""K3's error behind a long prefix with peaked scores, as a share of its
tolerance.

    PYTHONPATH=src python -m repro_torch.launch.k3_shares

One slot, a 128-token chunk after a prefix of 1920, 2048, 4096 or 8192
tokens (page size 16, 4 KV heads of 2 query heads, Dh 128), q scaled by 4;
fp32, bf16 and int8 pools, the suffix f32 (bf16 beside bf16 pools and
int8).  int8 pools come two ways: uniform codes with row scales in [1e-3,
0.031] (the card tests' pools), and normal rows quantized as the engine
writes them (``kv_quantize_rows``: per-row max |x| / 127).  Prints max
|kernel - plain| / (1e-5 * max(1, max |plain|)), the tolerance of the card
tests and ``chip_smoke.py``.  The tensor cores truncate each MMA's sum
towards 0, so P V carried in one accumulator over the whole key range
drifts with its length; K3 sums each 32 keys of its 3xTF32 P V in a fresh
accumulator (PERF.md, §6).  It calls only ``kernels.ops`` and
``kv_quantize_rows``, so a copy runs in an older checkout.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

PREFIXES = ((1920, 7), (2048, 5), (4096, 9), (8192, 11))  # (prefix, seed)
# (pool, suffix, int8 pools written as the engine writes them)
KINDS = ((torch.float32, torch.float32, False),
         (torch.int8, torch.float32, False), (torch.int8, torch.float32, True),
         (torch.bfloat16, torch.bfloat16, False),
         (torch.int8, torch.bfloat16, False),
         (torch.int8, torch.bfloat16, True))


def share(pfx: int, seed: int, kind, sdt, rows: bool, dev) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.attention import kv_quantize_rows

    b, t, hkv, grp, dh, ps = 1, 128, 4, 2, 128, 16
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + -(-(pfx + t) // ps)
    table = torch.from_numpy(np.random.default_rng(seed).permutation(
        np.arange(1, n_pages)).astype(np.int32))[None].to(dev)
    shp = (n_pages, ps, hkv, dh)
    if kind == torch.int8 and rows:
        (k, ks), (v, vs) = (kv_quantize_rows(torch.randn(
            shp, generator=gen, device=dev)) for _ in range(2))
    elif kind == torch.int8:
        k, v = (torch.randint(-127, 128, shp, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shp[:3], generator=gen, device=dev) * 0.03
                  + 1e-3 for _ in range(2))
    else:
        k, v = (torch.randn(shp, generator=gen, device=dev).to(kind)
                for _ in range(2))
        ks = vs = None
    q = 4 * torch.randn(b, t, hkv, grp, dh, generator=gen, device=dev)
    k_suf, v_suf = (torch.randn(b, t, hkv, dh, generator=gen,
                                device=dev).to(sdt) for _ in range(2))
    pl = torch.tensor([pfx], dtype=torch.int32, device=dev)
    cl = torch.tensor([t], dtype=torch.int32, device=dev)
    args = (q, k_suf, v_suf, k, v, table, pl, cl, ks, vs)
    ref = PA.gqa_paged_prefill_plain(*args, sm_scale=dh ** -0.5)
    out = ops.gqa_paged_prefill(*args, sm_scale=dh ** -0.5)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    return err / (1e-5 * max(1.0, float(ref.abs().max())))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k3_shares: no CUDA device available")
    from repro_torch.device import strict_fp32_matmul

    strict_fp32_matmul()
    dev = torch.device("cuda")
    for pfx, seed in PREFIXES:
        for kind, sdt, rows in KINDS:
            pools = str(kind)[6:] + (" (engine rows)" if rows else "")
            print(f"K3 prefix {pfx} + chunk 128, {pools} pools, "
                  f"{str(sdt)[6:]} suffix, q x4: error / tolerance "
                  f"{share(pfx, seed, kind, sdt, rows, dev):.3f}", flush=True)


if __name__ == "__main__":
    main()
