"""B8's and B9's error over long key ranges with peaked scores, as a share
of their tolerance.

    PYTHONPATH=src python -m repro_torch.launch.mla_shares

B9: one slot, a 128-token chunk of DeepSeek-V2's 128 heads (r 512, dr 64,
page size 16) after a prefix of 2048, 4096 or 8192 tokens.  B8: one slot
of 128 heads at 65,536 and 131,072 positions, where ``mla_decode_splits``
gives each of its 32 splits 2048 and 4096 keys.  Queries scaled by 4; f32,
bf16 and int8 latent pools, B9's suffix f32 (bf16 beside bf16 pools, and
int8 with either).  int8 pools come two ways: uniform codes with row scales
in [1e-3, 0.031] (the card tests' pools), and normal rows quantized as the
engine writes them (``kv_quantize_rows``: per-row max |x| / 127).

Prints three shares of the tolerance of the card tests and
``chip_smoke.py``, max |a - b| / (1e-5 * max(1, max |b|)): the kernel
against its plain version, the kernel against a float64 evaluation of the
same attention, and the plain version against that evaluation.  Peaked
scores reach |s| of 30 and more, where the plain version's own f32 score
rounding (an error in s is a relative error in its softmax weight) is
about the tolerance itself; so the kernel's drift is read against float64,
and the card tests hold the kernel to float64 on these inputs.  The tensor
cores truncate each MMA's sum towards 0, so P V carried in one accumulator
over a long key range drifts with its length; the tile sums each 32-key
tile's P V in a fresh accumulator (PERF.md, §6).  It calls only
``kernels.ops``, the plain versions and ``kv_quantize_rows``, so a copy
runs in an older checkout.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

H, R, DR, PS, T = 128, 512, 64, 16, 128
SCALE = (128 + 64) ** -0.5
B9_PREFIXES = ((2048, 5), (4096, 9), (8192, 11))      # (prefix, seed)
B8_LENGTHS = ((65536, 3), (131072, 4))                # (positions, seed)
# (pool, suffix, int8 pools written as the engine writes them)
KINDS = ((torch.float32, torch.float32, False),
         (torch.int8, torch.float32, False), (torch.int8, torch.float32, True),
         (torch.bfloat16, torch.bfloat16, False),
         (torch.int8, torch.bfloat16, False),
         (torch.int8, torch.bfloat16, True))
B8_KINDS = tuple((k, r) for k, s, r in KINDS if s == torch.float32
                 or k == torch.bfloat16)


def _pools(n_rows: int, kind, rows: bool, gen, dev):
    """(ckv, kpe, ckv scale, kpe scale, table) of one slot's ``n_rows``
    latent rows on shuffled pages (page 0 is trash, never read)."""
    n_pages = 1 + -(-n_rows // PS)
    table = torch.from_numpy(np.random.default_rng(n_rows).permutation(
        np.arange(1, n_pages)).astype(np.int32))[None].to(dev)
    if kind == torch.int8 and rows:
        from repro_torch.models.attention import kv_quantize_rows

        (ckv, cs), (kpe, ps) = (kv_quantize_rows(torch.randn(
            n_pages, PS, d, generator=gen, device=dev)) for d in (R, DR))
    elif kind == torch.int8:
        ckv, kpe = (torch.randint(-127, 128, (n_pages, PS, d), generator=gen,
                                  device=dev, dtype=torch.int8)
                    for d in (R, DR))
        cs, ps = (torch.rand(n_pages, PS, generator=gen, device=dev) * 0.03
                  + 1e-3 for _ in range(2))
    else:
        ckv, kpe = (torch.randn(n_pages, PS, d, generator=gen,
                                device=dev).to(kind) for d in (R, DR))
        cs = ps = None
    return ckv, kpe, cs, ps, table


def _share(out, ref) -> float:
    torch.cuda.synchronize()
    err = float((out.double() - ref.double()).abs().max())
    return err / (1e-5 * max(1.0, float(ref.abs().max())))


def _shares(out, plain, exact) -> tuple:
    """(kernel vs plain, kernel vs float64, plain vs float64)."""
    return _share(out, plain), _share(out, exact), _share(plain, exact)


def _rows64(pool, scale, table, n: int) -> torch.Tensor:
    """A slot's first ``n`` latent rows through the table, dequantized, in
    float64."""
    rows = pool[table[0].long()].flatten(0, 1)[:n].double()
    if scale is not None:
        rows = rows * scale[table[0].long()].flatten(0, 1)[:n, None].double()
    return rows


def _attend64(q_lat, q_pe, ckv, kpe, valid) -> torch.Tensor:
    """float64 softmax attention of queries [..., r] / [..., dr] over keys
    [S, r] ‖ [S, dr] (values ckv) where ``valid`` [..., S]."""
    s = (q_lat.double() @ ckv.T + q_pe.double() @ kpe.T) * SCALE
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    return p @ ckv


def b9_share(pfx: int, seed: int, kind, sdt, rows: bool, dev) -> tuple:
    """B9's shares (:func:`_shares`) behind a ``pfx``-token prefix."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA

    gen = torch.Generator(device=dev).manual_seed(seed)
    ckv, kpe, cs, ps, table = _pools(pfx + T, kind, rows, gen, dev)
    q_lat = 4 * torch.randn(1, T, H, R, generator=gen, device=dev)
    q_pe = 4 * torch.randn(1, T, H, DR, generator=gen, device=dev)
    c_suf, k_suf = (torch.randn(1, T, d, generator=gen, device=dev).to(sdt)
                    for d in (R, DR))
    pl = torch.tensor([pfx], dtype=torch.int32, device=dev)
    cl = torch.tensor([T], dtype=torch.int32, device=dev)
    args = (q_lat, q_pe, c_suf, k_suf, ckv, kpe, table, pl, cl, cs, ps)
    out = ops.mla_paged_prefill(*args, sm_scale=SCALE)
    plain = PA.mla_paged_prefill_plain(*args, sm_scale=SCALE)
    ckv64 = torch.cat([_rows64(ckv, cs, table, pfx), c_suf[0].double()])
    kpe64 = torch.cat([_rows64(kpe, ps, table, pfx), k_suf[0].double()])
    keys = torch.arange(pfx + T, device=dev)
    valid = keys[None] <= pfx + torch.arange(T, device=dev)[:, None]
    exact = _attend64(q_lat[0], q_pe[0], ckv64, kpe64, valid[:, None, :])
    return _shares(out, plain, exact[None])


def b8_share(n: int, seed: int, kind, rows: bool, dev) -> tuple:
    """B8's shares (:func:`_shares`) for one slot at ``n`` positions."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA

    gen = torch.Generator(device=dev).manual_seed(seed)
    ckv, kpe, cs, ps, table = _pools(n, kind, rows, gen, dev)
    q_lat = 4 * torch.randn(1, H, R, generator=gen, device=dev)
    q_pe = 4 * torch.randn(1, H, DR, generator=gen, device=dev)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    args = (q_lat, q_pe, ckv, kpe, table, lens, cs, ps)
    out = ops.mla_paged_attention(*args, sm_scale=SCALE)
    plain = PA.mla_paged_attention_plain(*args, sm_scale=SCALE)
    valid = torch.ones(1, n, dtype=torch.bool, device=dev)
    exact = _attend64(q_lat[0], q_pe[0], _rows64(ckv, cs, table, n),
                      _rows64(kpe, ps, table, n), valid)
    return _shares(out, plain, exact[None])


def pools_label(kind, rows: bool) -> str:
    return str(kind)[6:] + (" (engine rows)" if rows else "")


def shares_text(shares) -> str:
    return ("error / tolerance: kernel vs plain {:.3f}, kernel vs float64 "
            "{:.3f}, plain vs float64 {:.3f}".format(*shares))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mla_shares: no CUDA device available")
    from repro_torch.device import strict_fp32_matmul
    from repro_torch.kernels import paged_attention as PA

    strict_fp32_matmul()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for pfx, seed in B9_PREFIXES:
        for kind, sdt, rows in KINDS:
            print(f"B9 prefix {pfx} + chunk {T}, {pools_label(kind, rows)} "
                  f"pools, {str(sdt)[6:]} suffix, q x4: "
                  + shares_text(b9_share(pfx, seed, kind, sdt, rows, dev)),
                  flush=True)
    for n, seed in B8_LENGTHS:
        splits, pps = PA.mla_decode_splits(1, H, n // PS, PS, sms)
        for kind, rows in B8_KINDS:
            print(f"B8 one slot at {n} ({splits} splits of {pps * PS} keys), "
                  f"{pools_label(kind, rows)} pools, q x4: "
                  + shares_text(b8_share(n, seed, kind, rows, dev)),
                  flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
