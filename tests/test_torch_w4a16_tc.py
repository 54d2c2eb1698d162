"""The arithmetic of the K1/B6 tensor-core tile (``csrc/w4a16_tile.cuh``),
emulated in numpy, against the JAX package's oracles
``ref.w4a16_matmul_ref`` and ``ref.w4a16_grouped_ref`` on the same weights;
and B6's per-expert ``rows`` on the CPU (plain version, ``apply_moe``).

The emulation follows the kernel step by step: f32 X split into three bf16
terms (bf16 X is one term), the A operand built from the packed bytes as
the kernel builds it (byte pairs of packed rows r and r + 4, nibble masks,
the bf16 ``0x4300 | code`` minus 136, the code centred at 8), the MMA k
order and column order of
the fragments, the ring's chunks (a group of G > 128 walks several stages,
a chunk of G % 16 != 0 is padded to a whole k-step with zero X), one f32
centred-code sum P per group beside the group sum xs (summed in the
kernel's staging order, chunk by chunk), the fold ``acc += scale · (P −
(zero − 8) · xs)``, and the split-K partition of the groups summed in split
order.  Tolerances relative to max |ref|: f32 1e-5 (sums in another
order), bf16 1e-2 (the output is rounded to bf16).  With the MMAs' sums
truncated towards zero, a positive-mean input (a GELU MLP's hidden) over a
24576-wide contraction stays within the tolerance with the centred codes
and misses it with the raw codes 0..15, which the tile summed before.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.core.quantize import dequantize, quantize, unpack_codes
from repro_torch.kernels import ops
from repro_torch.kernels import w4a16_grouped as G
from repro_torch.models import mlp as TM


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), returned as f32."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _terms(x, f32):
    """The B operand's bf16 terms of x: hi, mid, lo (f32 x) or x (bf16)."""
    if not f32:
        return [x]
    hi = _bf16(x)
    mid = _bf16(x - hi)
    lo = _bf16(x - hi - mid)
    return [hi, mid, lo]


def _bf16_bits(v):
    """bf16 bit patterns (uint32 holding 16 bits) → f32 values."""
    return (v.astype(np.uint32) << 16).view(np.float32)


def _a_operand(pc):
    """The kernel's A operand of one staged chunk: codes[k, c] in MMA k
    order (k = 16 s + kk) built from the packed bytes pc[rows, Co] (rows a
    multiple of 8), and the staged X position each MMA k reads: r for the
    low nibble of packed row r, rows + r for its high nibble."""
    n, co = pc.shape
    codes = np.zeros((2 * n, co), np.float32)
    src = np.zeros(2 * n, np.int64)
    for s in range(n // 8):
        for t4 in range(4):
            r = 8 * s + t4
            # __byte_perm(w0, w1, j | (4 + j) << 8): byte 0 row r, byte 2
            # row r + 4 of the same column
            u = pc[r].astype(np.uint32) | (pc[r + 4].astype(np.uint32) << 16)
            lo = (u & 0x000F000F) | 0x43004300
            hi = ((u >> 4) & 0x000F000F) | 0x43004300
            for reg, base in ((lo, 0), (hi, 8)):
                k = 16 * s + base + 2 * t4
                codes[k] = _bf16_bits(reg & 0xFFFF) - 136.0
                codes[k + 1] = _bf16_bits(reg >> 16) - 136.0
                src[k] = r + (n if base else 0)
                src[k + 1] = r + 4 + (n if base else 0)
    return codes, src


def _chunks(g, step):
    """The ring's chunks of a group (csrc/w4_ring.cuh Chunking): (first
    packed row, packed rows holding weights, staged rows padded to whole
    k-steps of ``step`` packed rows)."""
    half = g // 2
    for r0 in range(0, half, 64):
        nv = min(64, half - r0)
        yield r0, nv, -(-nv // step) * step


def _fragment_columns(co):
    """The output column of (32-column warp block, MMA tile m, M row):
    M row g8 + 8 h of tile m is column 4 g8 + 2 m + h."""
    cols = []
    for c0 in range(0, co, 32):
        for m in range(2):
            cols.append([c0 + 4 * (r % 8) + 2 * m + r // 8 for r in range(16)])
    return np.asarray(cols)                              # [tiles, 16]


def _tile(x, packed, scales, zeros, g, splits, f32):
    """The kernel's arithmetic for one weight: x[T, Ci] (f32 values, bf16
    ones when ``not f32``) → f32 y[T, Co]."""
    t, ci = x.shape
    co = packed.shape[1]
    half, n_groups = g // 2, ci // g
    pad = -co % 32                        # columns past Co are zero-filled
    pk = np.pad(packed, ((0, 0), (0, pad)))
    sc = np.pad(scales.astype(np.float32), ((0, 0), (0, pad)))
    zr = np.pad(zeros.astype(np.float32), ((0, 0), (0, pad)))
    frag = _fragment_columns(co + pad).ravel()   # MMA tiles side by side
    assert sorted(frag.tolist()) == list(range(co + pad))
    tpr = 16 if t <= 16 else 4         # threads per X row in the staging
    parts = []
    for sp in range(splits):
        acc = np.zeros((t, co + pad), np.float32)
        for gi in range(sp * n_groups // splits,
                        (sp + 1) * n_groups // splits):
            P = np.zeros((t, co + pad), np.float32)
            for c, (r0, nv, rows) in enumerate(_chunks(g, 8)):
                # the stage: packed rows past nv and their X are zero
                pc = np.zeros((rows, co + pad), np.uint8)
                pc[:nv] = pk[gi * half + r0:gi * half + r0 + nv]
                codes, src = _a_operand(pc)
                xc = np.zeros((t, 2 * rows), np.float32)
                xc[:, :nv] = x[:, gi * g + r0:gi * g + r0 + nv]
                xc[:, rows:rows + nv] = x[:, gi * g + half + r0:
                                          gi * g + half + r0 + nv]
                terms = [tm[:, src] for tm in _terms(xc, f32)]
                # xs: each of a row's threads sums whole k-steps ks = l
                # (mod tpr) of the B operand's staging, then an xor-shuffle
                # tree; the chunks' sums add up
                lane = np.zeros((tpr, t), np.float32)
                for ks in range(rows // 8):
                    for i in range(4):
                        r = 8 * ks + i
                        lane[ks % tpr] += (xc[:, r] + xc[:, r + 4]) \
                            + (xc[:, rows + r] + xc[:, rows + r + 4])
                o = tpr // 2
                while o:
                    lane = lane + lane[np.arange(tpr) ^ o]
                    o //= 2
                xs = lane[0][:, None] if c == 0 else xs + lane[0][:, None]
                for s in range(rows // 8):
                    ks = slice(16 * s, 16 * s + 16)
                    for tm in terms:          # one MMA per 16-column tile
                        prod = tm[:, ks].astype(np.float64) \
                            @ codes[ks][:, frag].astype(np.float64)
                        P[:, frag] = (P[:, frag] + prod).astype(np.float32)
            inner = (P.astype(np.float64)
                     - (zr[gi].astype(np.float64) - 8.0) * xs
                     ).astype(np.float32)
            acc = (acc.astype(np.float64) + sc[gi].astype(np.float64)
                   * inner).astype(np.float32)
        parts.append(acc)
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y[:, :co]


def _close(got, want, f32):
    want = np.asarray(want, np.float32)
    tol = (1e-5 if f32 else 1e-2) * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol)


@functools.lru_cache(maxsize=None)
def _oracle_case(lead, t, ci, co, g, offset_only, f32):
    """Seeded x[*lead, t, ci] (bf16 values when ``not f32``), the weight
    quantized by the port (the reference's bytes: test_torch_quantize.py),
    and the JAX oracle's output in f32.  Rows are independent, so a case
    with fewer rows slices this one."""
    rng = np.random.default_rng(ci + co + g + len(lead))
    w = rng.standard_normal((*lead, ci, co)).astype(np.float32) * ci ** -0.5
    tqt = quantize(torch.from_numpy(w), group_size=g)
    zeros = tqt.zeros.numpy().copy()
    if offset_only:                       # group 0: zero point -15000
        zeros[..., 0, :] = -15000.0
    qt = jq.QuantizedTensor(jnp.asarray(tqt.packed.numpy()),
                            jnp.asarray(tqt.scales.numpy()),
                            jnp.asarray(zeros))
    x = rng.standard_normal((*lead, t, ci)).astype(np.float32)
    if not f32:
        x = _bf16(x)
    jx = jnp.asarray(x) if f32 else jnp.asarray(x).astype(jnp.bfloat16)
    oracle = jref.w4a16_grouped_ref if lead else jref.w4a16_matmul_ref
    want = np.asarray(oracle(jx, qt).astype(jnp.float32))
    return x, tuple(np.asarray(a) for a in (qt.packed, qt.scales, qt.zeros)), want


CASES = [  # (t, ci, co, g, splits, offset_only): weights shared per (ci..)
    (1, 256, 72, 32, 1, False), (7, 256, 72, 32, 3, False),
    (9, 256, 72, 32, 8, False), (17, 256, 72, 32, 2, False),
    (65, 256, 72, 32, 1, False),
    (5, 128, 64, 128, 1, False),           # Ci = G: one group
    (9, 256, 48, 128, 2, True),            # offset-only group
    (7, 64, 48, 16, 4, False),             # G = 16
    (17, 96, 48, 48, 2, False),            # G = 48
    (17, 512, 72, 256, 2, False),          # G = 256: two ring stages a group
    (9, 64, 40, 8, 3, False),              # G = 8: a chunk padded to a k-step
]
_ROWS = 65     # the oracle runs once per weight at the most rows of a case


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("t,ci,co,g,splits,offset_only", CASES)
def test_tile_arithmetic_matches_k1_oracle(t, ci, co, g, splits, offset_only,
                                           f32):
    x, (packed, scales, zeros), want = _oracle_case((), _ROWS, ci, co, g,
                                                    offset_only, f32)
    y = _tile(x[:t], packed, scales, zeros, g, splits, f32)
    if not f32:
        y = _bf16(y)
    _close(y, want[:t], f32)


def _trunc32(v):
    """float64 → f32 rounded towards zero (an MMA's accumulator write)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


@pytest.mark.parametrize("centre", [8.0, 0.0])
def test_centred_codes_hold_positive_mean_inputs(centre):
    """starcoder2-15b's down projection: a GELU hidden (mean ~0.28 of its
    ~0.6 spread) into Ci = 24576 (192 groups of 128).  Each k-step's MMA
    adds 16 exact products to P and truncates towards zero; the fold is
    ``scale · (P − (zero − centre) · xs)``.  With the codes centred at 8 the
    tile stays within half of the f32 tolerance against the plain
    version; with the raw codes (centre 0) P and zero · xs cancel and the
    truncations leave more than the tolerance."""
    rng = np.random.default_rng(0)
    ci, co, t, g = 24576, 64, 2, 128
    w = torch.from_numpy((rng.standard_normal((ci, co)) * ci ** -0.5)
                         .astype(np.float32))
    qt = quantize(w, group_size=g)
    codes = unpack_codes(qt.packed, g).numpy().astype(np.float64) - centre
    sc, zr = qt.scales.numpy(), qt.zeros.numpy().astype(np.float64) - centre
    x = torch.nn.functional.gelu(torch.from_numpy(rng.standard_normal(
        (t, ci)).astype(np.float32)), approximate="tanh").numpy()
    terms = _terms(x, True)
    acc = np.zeros((t, co), np.float32)
    for gi in range(ci // g):
        P = np.zeros((t, co), np.float32)
        for k0 in range(gi * g, (gi + 1) * g, 16):
            for tm in terms:
                P = _trunc32(P.astype(np.float64)
                             + tm[:, k0:k0 + 16].astype(np.float64)
                             @ codes[k0:k0 + 16])
        xs = x[:, gi * g:(gi + 1) * g].sum(1, dtype=np.float32)[:, None]
        inner = (P.astype(np.float64) - zr[gi] * xs).astype(np.float32)
        acc = (acc.astype(np.float64) + sc[gi].astype(np.float64)
               * inner).astype(np.float32)
    plain = x @ dequantize(qt, torch.float32).numpy()
    ratio = np.abs(acc - plain).max() / (1e-5 * max(1.0,
                                                    np.abs(plain).max()))
    assert (ratio < 0.5) if centre else (ratio > 1.0), ratio


def test_three_bf16_terms_hold_f32_exactly():
    x = (np.random.default_rng(0).standard_normal(4096)
         * 10.0 ** np.random.default_rng(1).integers(-6, 6, 4096)
         ).astype(np.float32)
    hi, mid, lo = _terms(x, True)
    for tm in (hi, mid, lo):
        assert np.array_equal(_bf16(tm), tm)
    assert np.array_equal(hi.astype(np.float64) + mid + lo,
                          x.astype(np.float64))


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("e,c,ci,co,g,splits,offset_only", [
    (3, 9, 96, 48, 48, 2, False), (4, 6, 128, 40, 128, 1, True),
    (2, 20, 512, 40, 256, 1, False), (3, 9, 48, 40, 8, 2, False)])
def test_tile_arithmetic_matches_grouped_oracle(e, c, ci, co, g, splits,
                                                offset_only, f32):
    x, (packed, scales, zeros), want = _oracle_case((e,), c, ci, co, g,
                                                    offset_only, f32)
    y = np.stack([_tile(x[i], packed[i], scales[i], zeros[i], g, splits, f32)
                  for i in range(e)])
    if not f32:
        y = _bf16(y)
    _close(y, want, f32)


def test_b6_plain_rows_and_apply_moe_counts(monkeypatch):
    """The plain B6 zeroes rows >= rows[e] (and nothing else); apply_moe
    hands the grouped matmul each expert's filled-row prefix, clamped to
    the capacity, and its output does not depend on it."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 5, 64)).astype(np.float32))
    qt = quantize(torch.from_numpy(
        rng.standard_normal((4, 64, 32)).astype(np.float32)), group_size=16)
    rows = torch.tensor([0, 5, 2, 3], dtype=torch.int32)
    y = G.w4a16_grouped_plain(x, qt, rows)
    full = G.w4a16_grouped_plain(x, qt)
    for i, n in enumerate(rows.tolist()):
        assert bool((y[i, n:] == 0).all())
        assert torch.equal(y[i, :n], full[i, :n])

    cfg = get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32")
    p = TM.init_moe(torch.Generator().manual_seed(0), cfg)
    p["experts"] = {k: quantize(v, group_size=16)
                    for k, v in p["experts"].items()}
    seen = []
    real = ops.w4a16_grouped_matmul

    def spy(xb, w, *, act="a16", rows=None):
        seen.append((xb.clone(), rows.clone()))
        return real(xb, w, act=act, rows=rows)

    monkeypatch.setattr(ops, "w4a16_grouped_matmul", spy)
    xin = torch.from_numpy(
        rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32))
    out, _ = TM.apply_moe(p, xin, cfg)
    assert len(seen) == 3
    m = cfg.moe
    cap = TM.moe_capacity(14, m)
    probs = torch.softmax(xin.reshape(14, -1) @ p["router"]["w"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :m.top_k]
    want = torch.clamp(torch.bincount(top.reshape(-1),
                                      minlength=m.num_experts), max=cap)
    for xb, r in seen:
        assert r.dtype == torch.int32
        assert torch.equal(r.long(), want)
        filled = xb.abs().amax(dim=-1) > 0              # [E, C]
        prefix = torch.arange(cap)[None, :] < r[:, None]
        assert torch.equal(filled, prefix)

    monkeypatch.setattr(ops, "w4a16_grouped_matmul",
                        lambda xb, w, *, act="a16", rows=None:
                        real(xb, w, act=act))
    out_none, _ = TM.apply_moe(p, xin, cfg)
    assert torch.equal(out, out_none)
