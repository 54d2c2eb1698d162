"""The arithmetic of the B5/B7 int8 tensor-core tile (``csrc/w4a8_tile.cuh``
on the ring of ``csrc/w4_ring.cuh``), emulated in numpy, against the JAX
package's oracles ``ref.w4a8_matmul_ref`` and ``ref.w4a8_grouped_ref`` on
the same weights and activations.

The emulation follows the kernel step by step: the activations quantized
per row as the wrapper does (the port's ``quantize_acts_per_token``); the
ring's chunks of at most 64 packed rows (a group of G = 256 walks two
stages, a chunk of G % 32 != 0 is padded to a whole k-step with zero X);
the packed rows staged under the 16-byte-piece swizzle and read back at
the kernel's swizzled addresses; the 4x4 byte transpose and nibble split;
the zero-point fold per byte, by the modular byte add where every zero of
the warp's 32 columns lies in [-112, 128] and by the two saturating steps
elsewhere (a clip group takes the latter); the m16n8k32 k order (low
nibbles k 4 t4.., high nibbles k 16 + 4 t4..) and the fragments' column
permutation; one exact int32 sum per (row, group), folded as
``acc = fma(float(part), scale, acc)``; the split-K partition of the
groups summed in split order, then ``· xs``; B7's ``rows``.

The int32 sums must equal the exact integer contraction of the reference's
own codes.  The outputs must be within 1e-5 of max |ref|: f32 sums in
another order than XLA's.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels import ref as jref
from repro_torch.core.quantize import quantize, quantize_acts_per_token


def _swizzle(r, col):
    """csrc/w4_ring.cuh swizzle(): the staged byte of column ``col`` of
    packed row ``r``."""
    return col ^ (((r >> 2) & 3) << 5)


def _bytes(w):
    """uint32 words → their 4 bytes as int16 values of the int8 bytes."""
    b = (w[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF
    return b.astype(np.uint8).view(np.int8).astype(np.int16)


def _words(b):
    """int16 byte values in [-128, 127] (last axis 4) → uint32 words."""
    u = (b.astype(np.int64) & 0xFF).astype(np.uint32)
    return (u << (8 * np.arange(4, dtype=np.uint32))).sum(
        axis=-1, dtype=np.uint32)


def _vsubss4(a, b):
    """__vsubss4: per-byte signed saturating a - b."""
    return _words(np.clip(_bytes(a) - _bytes(b), -128, 127))


def _splat(v):
    return (np.asarray(v, np.int64) & 0xFF).astype(np.uint32) * np.uint32(
        0x01010101)


def _fold_params(z):
    """Per column (u, v) as the kernel takes them, and per column whether
    its warp (32 columns) folds by the fast path."""
    safe = (z >= -112) & (z <= 128)
    fast = np.repeat(safe.reshape(-1, 32).all(axis=1), 32)
    a = np.clip(z, -128, 127)
    b = np.clip(z - a, -128, 127)
    cz = _splat(-np.where(fast, z, 0).astype(np.int64))
    u = np.where(fast, cz & 0x7F7F7F7F, _splat(a.astype(np.int64)))
    v = np.where(fast, cz & 0x80808080, _splat(b.astype(np.int64)))
    return u.astype(np.uint32), v.astype(np.uint32), fast


def _fold(codes, u, v, fast):
    f = ((codes + u) ^ v).astype(np.uint32)
    return np.where(fast, f, _vsubss4(_vsubss4(codes, u), v))


def _frag_rows(bm):
    """Column (within a block of ``bm``) of M row R of MMA tile m of warp
    wm: 4 (R % 8) + 2 m + R // 8 — ``[bm // 32, 2, 16]``."""
    r = np.arange(16)
    return np.asarray([[wm * 32 + 4 * (r % 8) + 2 * m + r // 8
                        for m in range(2)] for wm in range(bm // 32)])


def _a8_tile(xq, packed, zeros, g, bm):
    """The kernel's exact int32 group sums for one weight: xq int8 [T, Ci]
    → int64 part [T, G#, Co] (int64 so an overflow would show)."""
    t, ci = xq.shape
    co = packed.shape[1]
    half, n_groups = g // 2, ci // g
    padc = -co % bm
    cop = co + padc
    pk = np.pad(packed, ((0, 0), (0, padc)))
    zr = np.rint(np.pad(zeros.astype(np.float32), ((0, 0), (0, padc))))
    frag = _frag_rows(bm)
    parts = np.zeros((t, n_groups, cop), np.int64)
    thread_cols = np.arange(0, bm, 4)             # cw of each (wm, g8)
    for gi in range(n_groups):
        u, v, fast = _fold_params(zr[gi])
        want_fold = np.clip(np.arange(16)[:, None] - zr[gi][None, :],
                            -128, 127)            # [code, column]
        for r0 in range(0, half, 64):
            nv = min(64, half - r0)
            pad = -(-min(half, 64) // 16) * 16
            stage = np.zeros((pad, cop), np.uint8)
            rr = np.arange(pad)[:, None]
            for b0 in range(0, cop, bm):
                cols = np.arange(bm)[None, :]
                src = np.zeros((pad, bm), np.uint8)
                src[:nv] = pk[gi * half + r0:gi * half + r0 + nv, b0:b0 + bm]
                stage[rr, b0 + _swizzle(rr, cols)] = src
            xc = np.zeros((t, 2 * pad), np.int64)
            xc[:, :nv] = xq[:, gi * g + r0:gi * g + r0 + nv]
            xc[:, pad:pad + nv] = xq[:, gi * g + half + r0:
                                     gi * g + half + r0 + nv]
            for s in range(-(-nv // 16)):
                # A [column, 32 k], B [T, 32 k] of this k-step, column by
                # column as the lanes build them
                a = np.zeros((cop, 32), np.int64)
                for t4 in range(4):
                    p = 16 * s + 4 * t4                      # rows p..p+3
                    for b0 in range(0, cop, bm):
                        cw = b0 + thread_cols
                        addr = b0 + _swizzle(p, thread_cols)
                        # four 32-bit reads (rows p..p+3), then the
                        # transpose: col[j] byte i = row p + i, column cw + j
                        col = np.zeros((len(cw), 4), np.uint32)
                        for i in range(4):
                            w = stage[p + i, addr[:, None] + np.arange(4)]
                            col |= w.astype(np.uint32) << np.uint32(8 * i)
                        for j in range(4):
                            c = cw + j
                            for hi, base in ((0, 0), (1, 16)):
                                nib = (col[:, j] >> np.uint32(4 * hi)) \
                                    & np.uint32(0x0F0F0F0F)
                                f = _bytes(_fold(nib, u[c], v[c], fast[c]))
                                codes = _bytes(nib)
                                np.testing.assert_array_equal(
                                    f, want_fold[codes, c[:, None]])
                                a[c, base + 4 * t4:base + 4 * t4 + 4] = f
                bx = np.zeros((t, 32), np.int64)
                for t4 in range(4):
                    k = 16 * s + 4 * t4
                    bx[:, 4 * t4:4 * t4 + 4] = xc[:, k:k + 4]
                    bx[:, 16 + 4 * t4:20 + 4 * t4] = xc[:, pad + k:
                                                         pad + k + 4]
                # the MMAs: per warp and 16-column tile, A in M-row order
                # (the fragment's column permutation), D scattered back
                for b0 in range(0, cop, bm):
                    for wm in range(bm // 32):
                        for m in range(2):
                            cols = b0 + frag[wm, m]
                            d = bx @ a[cols].T               # [T, 16]
                            parts[:, gi, cols] += d
    assert np.abs(parts).max(initial=0) < 2 ** 31
    return parts[:, :, :co]


def _fold_groups(parts, scales, xs, splits):
    """acc = fma(float(part), scale, acc) over each split's groups, the
    splits summed in order, then · xs."""
    t, n_groups, co = parts.shape
    outs = []
    for sp in range(splits):
        acc = np.zeros((t, co), np.float32)
        for gi in range(sp * n_groups // splits,
                        (sp + 1) * n_groups // splits):
            acc = (parts[:, gi].astype(np.float32).astype(np.float64)
                   * scales[gi].astype(np.float64)
                   + acc.astype(np.float64)).astype(np.float32)
        outs.append(acc)
    y = outs[0]
    for o in outs[1:]:
        y = (y + o).astype(np.float32)
    return (y * xs).astype(np.float32)


def _bm(co):
    """The tile's columns, as kernels/w4a16_matmul.py:_plan picks them."""
    return 256 if co % 256 == 0 else 128


@functools.lru_cache(maxsize=None)
def _case(lead, t, ci, co, g, clip, seed):
    """Seeded x[*lead, t, ci] and the weight quantized by the port (the
    reference's bytes), group 0's first four zero points set so their fold
    needs the clip when ``clip``; the JAX quantized tensor beside it."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((*lead, ci, co)).astype(np.float32) * ci ** -0.5
    tqt = quantize(torch.from_numpy(w), group_size=g)
    zeros = tqt.zeros.numpy().copy()
    if clip:
        zeros[..., 0, :4] = [140.0, 130.0, -150.0, -114.0]
    x = rng.standard_normal((*lead, t, ci)).astype(np.float32)
    packed, scales = tqt.packed.numpy(), tqt.scales.numpy()
    jqt = jq.QuantizedTensor(jnp.asarray(packed), jnp.asarray(scales),
                             jnp.asarray(zeros))
    return x, packed, scales, zeros, jqt


def _exact_parts(xq, wq):
    """The integer contraction of the reference's own codes: xq int8
    [T, Ci], wq folded [G#, G, Co] → int64 [T, G#, Co]."""
    n_groups, g, _ = wq.shape
    xg = xq.astype(np.int64).reshape(xq.shape[0], n_groups, g)
    return np.einsum("tgi,gio->tgo", xg, wq.astype(np.int64))


def _close(got, want):
    want = np.asarray(want, np.float32)
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("t,ci,co,g,splits,clip", [
    (20, 256, 72, 16, 1, True),     # G = 16 (a padded half k-step); Co ragged
    (33, 192, 128, 48, 2, True),    # G = 48: a chunk of 24 rows, padded
    (64, 512, 256, 128, 3, False),  # G = 128, the 256-column tile, all fast
    (64, 512, 256, 128, 1, True),   # a clip group on the 256-column tile
    (17, 512, 200, 256, 2, True),   # G = 256: two ring stages a group
    (16, 64, 40, 8, 2, False),      # G = 8
])
def test_a8_tile_matches_b5_oracle(t, ci, co, g, splits, clip):
    x, packed, scales, zeros, jqt = _case((), t, ci, co, g, clip, ci + co)
    xq, xs = (a.numpy() for a in quantize_acts_per_token(torch.from_numpy(x)))
    parts = _a8_tile(xq, packed, zeros, g, _bm(co))
    jxq, _ = jq.quantize_acts_per_token(jnp.asarray(x))
    wq = np.asarray(jref._folded_int_codes(jqt))
    np.testing.assert_array_equal(parts, _exact_parts(np.asarray(jxq), wq))
    y = _fold_groups(parts, scales, xs, splits)
    _close(y, np.asarray(jref.w4a8_matmul_ref(jnp.asarray(x), jqt)))


@pytest.mark.parametrize("e,c,ci,co,g,splits,rows", [
    (3, 21, 96, 48, 48, 1, (21, 5, 0)),
    (2, 20, 512, 64, 256, 2, (20, 7)),
])
def test_a8_tile_matches_b7_oracle_with_rows(e, c, ci, co, g, splits, rows):
    """B7 per expert, with ``rows``: the rows past rows[e] are zero rows of
    x (as the MoE hands them) and come out exactly zero; expert 0 holds a
    clip group."""
    x, packed, scales, zeros, jqt = _case((e,), c, ci, co, g, True, e + ci)
    x = x.copy()
    for i, n in enumerate(rows):
        x[i, n:] = 0.0
    jqt = jq.QuantizedTensor(jqt.packed, jqt.scales, jnp.asarray(zeros))
    xq, xs = (a.numpy() for a in quantize_acts_per_token(torch.from_numpy(x)))
    jxq, _ = jq.quantize_acts_per_token(jnp.asarray(x))
    wq = np.asarray(jref._folded_int_codes(jqt))
    want = np.asarray(jref.w4a8_grouped_ref(jnp.asarray(x), jqt))
    y = np.zeros_like(want)
    for i, n in enumerate(rows):
        if n == 0:                 # the kernel reads nothing, writes zeros
            continue
        parts = _a8_tile(xq[i, :n], packed[i], zeros[i], g, _bm(co))
        np.testing.assert_array_equal(
            parts, _exact_parts(np.asarray(jxq)[i, :n], wq[i]))
        y[i, :n] = _fold_groups(parts, scales[i], xs[i, :n], splits)
    for i, n in enumerate(rows):
        assert not y[i, n:].any()
    _close(y, want)


def test_fast_fold_equals_saturating_fold():
    """The modular byte add gives the saturating fold's bytes for every
    code and every zero point in [-112, 128]; outside it the clip engages
    for some code."""
    codes = np.arange(16, dtype=np.uint32) * np.uint32(0x01010101)
    for z in range(-200, 201):
        want = np.clip(np.arange(16) - z, -128, 127)
        u, v, fast = _fold_params(np.full(32, float(z)))
        got = _bytes(_fold(codes, u[0], v[0], fast[0]))    # [code, byte]
        np.testing.assert_array_equal(got, np.repeat(want[:, None], 4, 1))
        assert fast[0] == (-112 <= z <= 128)
        assert fast[0] == bool(np.all((np.arange(16) - z >= -128)
                                      & (np.arange(16) - z <= 127)))
