"""The arithmetic of the redesigned B4 (``csrc/flash_attention.cu`` on the
tensor-core tile of ``csrc/attn_tile.cuh``, K3's), emulated in numpy, held
against the JAX Pallas ``flash_attention`` in interpret mode (small blocks,
as ``tests/test_torch_flash.py`` runs it) and against the port's
``flash_attention_plain`` on the same seeded numpy inputs.

The emulation walks the blocks in the order the card starts them (grid
(Hkv * value slices, B, row tiles), x fastest, the row tiles last first when
causal), 64 rows of the flattened T*grp axis a block in warps of 16 rows,
64-key tiles of contiguous K/V up to min(t of the block's last row + 1, S),
a warp skipping the tiles above its rows' diagonal and masking the rest per
row (t = R // grp), widths zero-padded to a multiple of 16, value columns
cut into slices of 64 or 128, and the online softmax in base 2 (scores
scaled by D^-0.5 * log2(e), exponentials 2^x).  Products: f32 q/k/v are
3xTF32 (each operand cut to TF32 by a bit mask, big*big + big*small +
small*big), P V summed in groups of 32 keys added in f32; bf16 q/k/v
take S = Q K^T as one bf16 MMA (exact products, f32 sums) and P in two
bf16 terms cut by bit mask against bf16 V.  A last test models the tensor
cores' truncating accumulator: one accumulator carried over a 2048-key row
misses the f32 tolerance where the 32-key groups hold it.

Tolerances, the card tests' (relative to max(1, max |ref|)): 1e-5 in f32,
1e-2 in bf16 (outputs rounded to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import flash_attention as FA

F32 = np.float32
NEG = F32(-1e30)
ROWS, KEYS, WARP = 64, 64, 16     # rows a block, keys a tile, rows a warp
TOL = {"f32": 1e-5, "bf16": 1e-2}
P_TERMS = 2                       # attn_tile.cuh's kBf16QPTerms


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), returned as f32."""
    b = np.ascontiguousarray(a, F32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


def _cut(a, mask):
    b = np.ascontiguousarray(a, F32).view(np.uint32)
    return (b & mask).astype(np.uint32).view(F32)


def _tf32(a):
    """f32 cut to TF32 by the kernel's bit mask (low 13 mantissa bits)."""
    return _cut(a, 0xFFFFE000)


def _mm_tf32x3(a, b):
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (asm @ bb + ab @ bsm + ab @ bb).astype(F32)


def _mm_tf32x3_grouped(a, b, group=32):
    """3xTF32 with each ``group`` of the contraction summed apart, added in
    f32 (the tile's fresh P V accumulators, kValueGroup)."""
    out = np.zeros((a.shape[0], b.shape[1]), F32)
    for k0 in range(0, a.shape[1], group):
        out = (out + _mm_tf32x3(a[:, k0:k0 + group],
                                b[k0:k0 + group])).astype(F32)
    return out


def _p_terms(p, n):
    """P's bf16 terms cut by bit mask (attn_tile.cuh:split_bf16_mask):
    each keeps the top 8 significant bits of what the earlier ones left."""
    terms, r = [], np.asarray(p, F32)
    for _ in range(n):
        t = _cut(r, 0xFFFF0000)
        terms.append(t)
        r = (r - t).astype(F32)
    return terms


def _geometry(t, grp, d):
    kdv = 64 if d <= 64 else 128
    return -(-d // 16) * 16, kdv, -(-d // kdv), -(-(t * grp) // ROWS)


def _launch_order(b, t, hkv, grp, d, causal):
    """(row tile, KV head, first value column, batch) of each block, in the
    order the card starts them: grid x = head * slices + slice, y = batch,
    z = row tile (reversed when causal: the longest tiles first)."""
    _, kdv, n_vs, n_rt = _geometry(t, grp, d)
    for z in range(n_rt):
        for y in range(b):
            for x in range(hkv * n_vs):
                yield (n_rt - 1 - z if causal else z), x // n_vs, \
                    (x % n_vs) * kdv, y


def _b4_emulate(q, k, v, causal, kind, writes=None):
    """B4's tile kernel on f32 arrays (bf16-exact for ``kind="bf16"``, whose
    output is rounded to bf16 as the kernel stores it).  ``writes`` counts
    the stores of each output element."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    grp, tg = h // hkv, t * (h // hkv)
    dhp, kdv, n_vs, _ = _geometry(t, grp, d)
    scale = F32(F32(d ** -0.5) * F32(np.log2(np.e)))    # base 2
    pad = lambda a, w: np.pad(a, [(0, 0)] * 3 + [(0, w - d)])  # noqa: E731
    qp, kp, vp = pad(q, dhp), pad(k, dhp), pad(v, n_vs * kdv)
    out = np.zeros(q.shape, F32)
    for rt, hh, v0, bi in _launch_order(b, t, hkv, grp, d, causal):
        r0 = rt * ROWS
        nrows = min(ROWS, tg - r0)
        kv_end = min((r0 + nrows - 1) // grp + 1, s) if causal else s
        qh = qp[bi, :, hh * grp:(hh + 1) * grp].reshape(tg, dhp)
        vw = min(kdv, d - v0)
        for w0 in range(0, nrows, WARP):          # warps without rows idle
            rows = r0 + w0 + np.arange(WARP)
            live = rows < tg
            qw = np.zeros((WARP, dhp), F32)
            qw[live] = qh[rows[live]]
            tr = rows // grp
            m = np.full(WARP, NEG, F32)
            l = np.zeros(WARP, F32)
            o = np.zeros((WARP, kdv), F32)
            for j0 in range(0, kv_end, KEYS):
                if causal and j0 > tr[-1]:
                    continue                      # above the warp's diagonal
                keys = j0 + np.arange(KEYS)
                ok = keys < kv_end                # never read past kv_end
                kt = np.zeros((KEYS, dhp), F32)
                vt = np.zeros((KEYS, kdv), F32)
                kt[ok] = kp[bi, keys[ok], hh]
                vt[ok] = vp[bi, keys[ok], hh, v0:v0 + kdv]
                if causal:
                    valid = (keys[None] <= tr[:, None]) & (keys[None] < s)
                else:
                    valid = np.broadcast_to(keys[None] < s, (WARP, KEYS))
                if kind == "f32":
                    sc = _mm_tf32x3(qw, kt.T)
                else:                              # one bf16 MMA, f32 sums
                    sc = (qw @ kt.T).astype(F32)
                sc = np.where(valid, sc * scale, NEG).astype(F32)
                mx = np.maximum(m, sc.max(1))
                corr = np.exp2(m - mx)
                p = np.where(valid, np.exp2(sc - mx[:, None]), 0).astype(F32)
                l = l * corr + p.sum(1)
                if kind == "f32":
                    pv = _mm_tf32x3_grouped(p, vt)
                else:                              # lowest term first
                    pv = sum(tm @ vt for tm in _p_terms(p, P_TERMS)[::-1])
                o = (o * corr[:, None] + pv).astype(F32)
                m = mx
            res = o / np.maximum(l, F32(1e-30))[:, None]
            for i, rr in enumerate(rows):
                if rr < tg:
                    tt, gq = divmod(int(rr), grp)
                    out[bi, tt, hh * grp + gq, v0:v0 + vw] = res[i, :vw]
                    if writes is not None:
                        writes[bi, tt, hh * grp + gq, v0:v0 + vw] += 1
    return _bf16(out) if kind == "bf16" else out


def _qkv(b, t, s, h, hkv, d, kind, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shp).astype(F32)
            for shp in ((b, t, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    return [_bf16(a) for a in arrs] if kind == "bf16" else arrs


def _pallas(q, k, v, causal, kind, block=16):
    dt = jnp.bfloat16 if kind == "bf16" else jnp.float32
    out = j_flash(*(jnp.asarray(a, dt) for a in (q, k, v)), causal=causal,
                  block_q=block, block_kv=block, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _plain(q, k, v, causal, kind):
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    out = FA.flash_attention_plain(*(torch.from_numpy(a).to(dt)
                                     for a in (q, k, v)), causal=causal)
    return out.float().numpy()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,hkv,d,causal", [
    (2, 70, 4, 2, 16, True),    # grp 2: rows straddle the diagonal; T*grp
                                # = 140, a ragged third row tile
    (1, 64, 4, 4, 32, True),    # grp 1, whole tiles
    (2, 32, 4, 2, 16, False),   # non-causal, S a multiple of the block
])
def test_b4_emulation_matches_pallas(kind, b, t, h, hkv, d, causal):
    q, k, v = _qkv(b, t, t, h, hkv, d, kind, seed=t + h)
    ref = _pallas(q, k, v, causal, kind)
    out = _b4_emulate(q, k, v, causal, kind)
    assert _rel_err(out, ref) <= TOL[kind]
    assert _rel_err(out, _plain(q, k, v, causal, kind)) <= TOL[kind]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("d", [8, 80, 144])
def test_b4_any_head_width(kind, d):
    """Widths padded to 16 in shared memory (8, 80, 144), value columns in
    slices (144: 128 + 16), grp 4 with T*grp = 160: the emulated tile
    against the plain version, every output element stored once."""
    b, t, h, hkv = 1, 40, 8, 2
    q, k, v = _qkv(b, t, t, h, hkv, d, kind, seed=d)
    writes = np.zeros(q.shape, np.int64)
    out = _b4_emulate(q, k, v, True, kind, writes)
    assert (writes == 1).all()
    assert _rel_err(out, _plain(q, k, v, True, kind)) <= TOL[kind]


def test_b4_causal_keys_past_t_are_never_read():
    """Causal with S > T: keys at or past T are masked for every row, so the
    block's key range ends at its last row's t + 1 and a NaN there is never
    read; the result is the reference's on clean keys."""
    b, t, s, h, hkv, d = 2, 45, 100, 6, 2, 16   # T*grp = 135
    q, k, v = _qkv(b, t, s, h, hkv, d, "f32", seed=5)
    kn, vn = k.copy(), v.copy()
    kn[:, t:], vn[:, t:] = np.nan, np.nan
    out = _b4_emulate(q, kn, vn, True, "f32")
    assert np.isfinite(out).all()
    assert _rel_err(out, _plain(q, k, v, True, "f32")) <= TOL["f32"]
    assert _rel_err(out, _pallas(q, k, v, True, "f32")) <= TOL["f32"]


def test_b4_non_causal_long_keys():
    """Non-causal T = 128 against S = 1024 keys (16 key tiles a block, S a
    multiple of the reference's 512 block)."""
    q, k, v = _qkv(1, 128, 1024, 2, 1, 16, "f32", seed=6)
    out = _b4_emulate(q, k, v, False, "f32")
    assert _rel_err(out, _pallas(q, k, v, False, "f32", block=512)) \
        <= TOL["f32"]
    assert _rel_err(out, _plain(q, k, v, False, "f32")) <= TOL["f32"]


def test_bf16_scores_in_one_mma_are_exact_products():
    """bf16 Q and K: every product has at most 16 significant bits, exact in
    f32, so one bf16 MMA with f32 sums gives the scores of the f32 path
    (which splits f32 Q into three terms) to f32 rounding."""
    rng = np.random.default_rng(7)
    qv = _bf16(rng.standard_normal((16, 64)).astype(F32))
    kv = _bf16(rng.standard_normal((64, 64)).astype(F32))
    prod = qv[:, None, :] * kv[None, :, :]
    assert np.array_equal(prod.astype(np.float64),
                          qv.astype(np.float64)[:, None, :]
                          * kv.astype(np.float64)[None, :, :])
    exact = qv.astype(np.float64) @ kv.T.astype(np.float64)
    assert np.abs((qv @ kv.T) - exact).max() <= 1e-6 * np.abs(exact).max()


@pytest.mark.parametrize("n,bound", [(1, 2.0 ** -7), (2, 2.0 ** -15)])
def test_p_terms_by_bit_mask(n, bound):
    """P in ``n`` bf16 terms by bit mask: each term is exact in bf16, their
    sum never exceeds P, and what is left is under 2^(1 - 8n) of P."""
    p = np.random.default_rng(8).random(4096).astype(F32)
    terms = _p_terms(p, n)
    for tm in terms:
        assert np.array_equal(_bf16(tm), tm)
    left = p.astype(np.float64) - sum(tm.astype(np.float64) for tm in terms)
    assert (left >= 0).all() and (left <= bound * p).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,hkv,grp,d", [(2, 70, 2, 2, 16), (1, 1, 3, 8, 64),
                                           (3, 33, 1, 4, 256)])
def test_launch_order_longest_first_each_row_once(causal, b, t, hkv, grp, d):
    """Every (batch, row, KV head, value column) belongs to exactly one
    block; under causal the blocks start in non-increasing order of their
    key tiles (row tiles on the slowest grid axis, last first)."""
    _, kdv, n_vs, _ = _geometry(t, grp, d)
    tg = t * grp
    seen = np.zeros((b, tg, hkv, n_vs * kdv), np.int64)
    tiles = []
    for rt, hh, v0, bi in _launch_order(b, t, hkv, grp, d, causal):
        r0 = rt * ROWS
        nrows = min(ROWS, tg - r0)
        seen[bi, r0:r0 + nrows, hh, v0:v0 + kdv] += 1
        kv_end = (r0 + nrows - 1) // grp + 1 if causal else t
        tiles.append(-(-kv_end // KEYS))
    assert (seen == 1).all()
    if causal:
        assert tiles == sorted(tiles, reverse=True)


def _truncating_pv(p, v, group):
    """P V on a model of the tensor cores: 3xTF32 MMAs over 8 keys, each
    MMA's sum truncated towards 0 into its f32 accumulator; one accumulator
    for the whole row (``group=None``) or a fresh one per ``group`` keys,
    added in f32."""
    def mma3(acc, a, b):
        ab, bb = _tf32(a), _tf32(b)
        for x, y in ((_tf32(a - ab), bb), (ab, _tf32(b - bb)), (ab, bb)):
            exact = acc.astype(np.float64) + x.astype(np.float64) @ y
            acc = exact.astype(F32)
            over = np.abs(acc.astype(np.float64)) > np.abs(exact)
            acc[over] = np.nextafter(acc[over], F32(0))
        return acc

    out = np.zeros((p.shape[0], v.shape[1]), F32)
    step = group or p.shape[1]
    for j0 in range(0, p.shape[1], step):
        acc = np.zeros_like(out) if group else out
        for j in range(j0, j0 + step, 8):
            acc = mma3(acc, p[:, j:j + 8], v[j:j + 8])
        out = (out + acc).astype(F32) if group else acc
    return out


def test_fresh_accumulators_bound_the_truncation_drift():
    """A 2048-key causal row with peaked attention (q scaled by 4): P V in
    one truncating accumulator (768 MMAs) shrinks the output by more than
    the 1e-5 tolerance; 32-key groups in fresh accumulators keep it under
    a tenth of it.  Hence the tile's f32 grouping, in B4 and K3."""
    t, d = 2048, 16
    rng = np.random.default_rng(0)
    q = (4 * rng.standard_normal((t, d))).astype(F32)
    k, v = rng.standard_normal((2, t, d)).astype(F32)
    sc = q.astype(np.float64) @ k.T.astype(np.float64) * d ** -0.5
    sc = np.where(np.tril(np.ones((t, t), bool)), sc, -np.inf)
    p = np.exp(sc - sc.max(1, keepdims=True))
    l = p.sum(1, keepdims=True)
    ref = p @ v.astype(np.float64) / l
    one = _truncating_pv(p.astype(F32), v, None) / l
    grouped = _truncating_pv(p.astype(F32), v, 32) / l
    assert _rel_err(one, ref) > TOL["f32"]
    assert _rel_err(grouped, ref) < 0.1 * TOL["f32"]
