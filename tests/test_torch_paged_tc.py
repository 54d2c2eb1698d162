"""The arithmetic of the redesigned K2 (split-KV paged decode,
``csrc/gqa_paged_decode.cu``) and K3 (tensor-core chunked prefill,
``csrc/gqa_paged_prefill.cu``), emulated in numpy, against the JAX Pallas
kernels in interpret mode (as ``tests/test_torch_paged_attention.py`` runs
them) on the same inputs.

K2: the split rule (``gqa_decode_splits``, the wrapper's own function), each
split's block as the kernel runs it (lane groups of L lanes per row taking
rows ``row0 + gid + k * step`` in steps of kUnroll rows, one online-softmax
step per kUnroll rows, the groups merged in group order), each split's
partial state (m, l, acc) held against a direct float64 softmax over its
rows, and the fixed split-order combine; fp and int8 pools, grp 1 and 2, an
empty slot, a slot with fewer live pages than splits, and S = 1.

K3: 64-row query tiles of the flattened T*grp axis in warps of 16 rows,
64-key tiles (prefix tiles gathered row by row through the table, so a tile
spans pages of PS 8, 16 or 48; suffix tiles a contiguous slice), the causal
tile skip per warp, the online softmax per tile, and the operand split of
each instance: 3xTF32 (big*big + big*small + small*big, each operand cut to
TF32 by a bit mask as the kernel cuts it) where both operands are f32, three
exact bf16 terms of the f32 operand (bf16 rounding by bit mask) against bf16
values or int8 codes otherwise; P V with each MMA's sum truncated towards 0
into its accumulator (as the tensor cores round it), each 32 keys in a fresh
accumulator added in f32.  Tolerance 1e-5 relative to max(1, max |ref|), as
the card tests; plain TF32 products miss it, which is why the split is
there, and behind a 2048-token peaked prefix one accumulator misses it,
which is why the groups are there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.paged_attention import gqa_paged_attention as j_decode
from repro.kernels.paged_attention import gqa_paged_prefill as j_prefill
from repro_torch.kernels import paged_attention as TPA

TOL = 1e-5
NEG = np.float32(-1e30)
F32 = np.float32


def _rel_err(a, ref):
    return float(np.abs(a - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), returned as f32."""
    b = np.ascontiguousarray(a, F32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


def _tf32(a):
    """Cut f32 to TF32 (its low 13 mantissa bits cleared, as the kernel's
    mask and as the MMA reads a tf32 register), returned as f32."""
    b = np.ascontiguousarray(a, F32).view(np.uint32)
    return (b & 0xFFFFE000).astype(np.uint32).view(F32)


def _mm_tf32x3(a, b):
    """a @ b on the tensor cores as 3xTF32: each operand x = big + small
    (big = x cut to TF32, small = x - big, cut again by the MMA), summed as
    small*big + big*small + big*big, each product exact, in f32."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (asm @ bb + ab @ bsm + ab @ bb).astype(F32)


def _mm_bf16x3(a, b):
    """a @ b with f32 ``a`` split into three exact bf16 terms (hi + mid +
    lo) against ``b`` exact in bf16 (bf16 values or int8 codes)."""
    assert np.array_equal(_bf16(b), b)
    hi = _bf16(a)
    mid = _bf16(a - hi)
    lo = _bf16(a - hi - mid)
    assert np.array_equal(hi + mid + lo, a)          # the split is exact
    return (lo @ b + mid @ b + hi @ b).astype(F32)


def _mm_tf32(a, b):
    """Plain TF32: one pass on operands cut to TF32."""
    return (_tf32(a) @ _tf32(b)).astype(F32)


def _pools(rng, n_pages, ps, hkv, dh, kind):
    """K/V pools of ``kind`` (``"f32"``, ``"bf16"`` or ``"int8"``) as f32
    values (bf16-rounded, or int8 codes) plus f32 row scales for int8, and
    the arrays the JAX kernel takes."""
    shp = (n_pages, ps, hkv, dh)
    if kind == "int8":
        k = rng.integers(-127, 128, shp).astype(F32)
        v = rng.integers(-127, 128, shp).astype(F32)
        ks = (rng.random(shp[:3]) * 0.03 + 1e-3).astype(F32)
        vs = (rng.random(shp[:3]) * 0.03 + 1e-3).astype(F32)
        jx = (jnp.asarray(k.astype(np.int8)), jnp.asarray(v.astype(np.int8)),
              jnp.asarray(ks), jnp.asarray(vs))
        return k, v, ks, vs, jx
    k = rng.standard_normal(shp).astype(F32)
    v = rng.standard_normal(shp).astype(F32)
    if kind == "bf16":
        k, v = _bf16(k), _bf16(v)
        return k, v, None, None, (jnp.asarray(k, jnp.bfloat16),
                                  jnp.asarray(v, jnp.bfloat16), None, None)
    return k, v, None, None, (jnp.asarray(k), jnp.asarray(v), None, None)


def _table(rng, rows, ps, width):
    """Shuffled distinct pages for each slot's live rows, trash page 0
    beyond; returns (table, number of pool pages)."""
    live = [-(-n // ps) for n in rows]
    n_pages = 1 + sum(live)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((len(rows), width), np.int32)
    k = 0
    for i, n in enumerate(live):
        table[i, :n] = perm[k:k + n]
        k += n
    return table, n_pages


def _rows(pool, table, b, h, n):
    """Rows 0..n-1 of slot b, head h, read through the table one row at a
    time (as the kernels read them: any page size)."""
    ps = pool.shape[1]
    idx = np.arange(n)
    return pool[table[b, idx // ps], idx % ps, h]


# ------------------------------------------------------------------ K2 -----
def test_decode_split_rule():
    """Static shapes only; about 4 blocks per SM; one split at most per
    page; every split but the last takes pps pages and none is empty."""
    for b, hkv, grp, p, sms in [(4, 32, 1, 64, 132), (4, 32, 1, 16, 132),
                                (4, 8, 2, 16, 132), (1, 32, 8, 8, 132),
                                (64, 32, 1, 16, 132), (2, 4, 12, 40, 132),
                                (3, 2, 1, 0, 132), (5, 2, 2, 17, 1)]:
        s, pps = TPA.gqa_decode_splits(b, hkv, grp, p, sms)
        assert 1 <= s <= max(1, min(p, 32)) and pps >= 1
        assert (s - 1) * pps < max(p, 1) <= s * pps
        blocks = b * hkv * -(-grp // 8)
        assert s == 1 or (s - 1) * blocks < 4 * sms or p <= s
    assert TPA.gqa_decode_splits(4, 32, 1, 64, 132) == (5, 13)
    assert TPA.gqa_decode_splits(4, 8, 2, 16, 132) == (16, 1)
    assert TPA.gqa_decode_splits(64, 32, 1, 16, 132) == (1, 16)


def _lanes(dh, dv, nc=1):
    """Lanes per row of the register path (csrc lanes_per_row)."""
    per = -(-(-(-max(dh, dv) // 4)) // nc)
    lanes = 1
    while lanes < per:
        lanes *= 2
    return lanes


def _k2_block(qg, k, v, ksc, vsc, row0, row1, scale, lanes, unroll=4,
              warps=4):
    """One K2 block of the register path over rows [row0, row1) of a slot:
    qg[ng, Dh]; k, v the slot's rows (f32 values or int8 codes), ksc/vsc
    their int8 row scales or None.  Returns the block's state (m[ng],
    l[ng], acc[ng, Dv]), merged over its lane groups in group order."""
    ng, dv = qg.shape[0], v.shape[1]
    r_per = 32 // lanes                      # rows a warp reads at once
    step = warps * r_per
    states = []
    for gid in range(warps * r_per):
        m = np.full(ng, NEG, F32)
        l = np.zeros(ng, F32)
        acc = np.zeros((ng, dv), F32)
        warp, sub = divmod(gid, r_per)
        for wb in range(row0 + warp * r_per, row1, step * unroll):
            rs = [wb + sub + u * step for u in range(unroll)]
            ok = np.array([r < row1 for r in rs])
            kr = np.stack([k[r] if r < row1 else np.zeros_like(k[0])
                           for r in rs])
            vr = np.stack([v[r] if r < row1 else np.zeros_like(v[0])
                           for r in rs])
            s = (qg @ kr.T).astype(F32) * F32(scale)          # [ng, unroll]
            if ksc is not None:
                s = s * np.array([ksc[r] if r < row1 else 0 for r in rs], F32)
            s = np.where(ok[None], s, NEG)
            mx = np.maximum(m, s.max(1))
            corr = np.exp(m - mx)
            p = np.where(ok[None], np.exp(s - mx[:, None]), 0).astype(F32)
            l = l * corr + p.sum(1)
            if vsc is not None:
                p = p * np.array([vsc[r] if r < row1 else 0 for r in rs], F32)
            acc = acc * corr[:, None] + p @ vr
            m = mx
        states.append((m, l, acc))
    return _merge(states)


def _merge(states):
    """Merge (m, l, acc) states in list order: m = max m_j, l = sum l_j
    e^(m_j - m), acc = sum acc_j e^(m_j - m) (K2's block merge and its
    split combine)."""
    big = np.max([m for m, _, _ in states], axis=0)
    l = np.zeros_like(states[0][1])
    acc = np.zeros_like(states[0][2])
    for m, lj, aj in states:
        w = np.exp(m - big).astype(F32)
        l = l + lj * w
        acc = acc + aj * w[:, None]
    return big, l, acc


def _k2_emulate(q, k, v, ks, vs, table, lengths, scale, splits, pps,
                partial_check=None):
    """K2's whole launch: splits x blocks, partial states, combine."""
    b, hkv, grp, dh = q.shape
    ps, dv, width = k.shape[1], v.shape[-1], table.shape[1]
    lanes = _lanes(dh, dv)
    out = np.zeros((b, hkv, grp, dv), F32)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), width * ps)
        for h in range(hkv):
            kr, vr = _rows(k, table, bi, h, n), _rows(v, table, bi, h, n)
            kq = _rows(ks, table, bi, h, n) if ks is not None else None
            vq = _rows(vs, table, bi, h, n) if vs is not None else None
            parts = []
            for s in range(splits):
                row0, row1 = s * pps * ps, min((s + 1) * pps * ps, n)
                if row0 >= row1:                       # the empty state
                    parts.append((np.full(grp, NEG, F32), np.zeros(grp, F32),
                                  np.zeros((grp, dv), F32)))
                else:
                    parts.append(_k2_block(q[bi, h], kr, vr, kq, vq, row0,
                                           row1, scale, lanes))
                if partial_check is not None:
                    partial_check(q[bi, h], kr, vr, kq, vq, row0, row1,
                                  scale, parts[-1])
            m, l, acc = _merge(parts)                  # split order
            out[bi, h] = acc / np.maximum(l, F32(1e-30))[:, None]
    return out


def _check_partial(qg, k, v, ksc, vsc, row0, row1, scale, state):
    """A split's partial state against float64 softmax sums over its
    rows."""
    m, l, acc = state
    if row0 >= row1:
        assert (m == NEG).all() and not l.any() and not acc.any()
        return
    s = (qg.astype(np.float64) @ k[row0:row1].T.astype(np.float64)) * scale
    if ksc is not None:
        s = s * ksc[row0:row1]
    mr = s.max(1)
    p = np.exp(s - mr[:, None])
    lr = p.sum(1)
    if vsc is not None:
        p = p * vsc[row0:row1]
    ar = p @ v[row0:row1].astype(np.float64)
    np.testing.assert_allclose(m, mr, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l, lr, rtol=1e-5)
    assert _rel_err(acc, ar) <= TOL


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("grp", [1, 2])
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_k2_split_emulation_matches_pallas(kind, grp, sms):
    """sms=132: 17 splits of one page (the 5-row slot has fewer live pages
    than splits); sms=1: S == 1.  Slot 0 is empty."""
    rng = np.random.default_rng(7 * grp + (kind == "int8"))
    ps, hkv, dh, width = 8, 2, 16, 17
    lengths = np.array([0, 5, 37, 64, 130], np.int32)
    b = len(lengths)
    table, n_pages = _table(rng, lengths, ps, width)
    k, v, ks, vs, jx = _pools(rng, n_pages, ps, hkv, dh, kind)
    q = rng.standard_normal((b, hkv, grp, dh)).astype(F32)
    scale = dh ** -0.5
    splits, pps = TPA.gqa_decode_splits(b, hkv, grp, width, sms)
    assert (splits, pps) == ((17, 1) if sms == 132 else (1, 17))
    ref = np.asarray(j_decode(jnp.asarray(q), jx[0], jx[1],
                              jnp.asarray(table), jnp.asarray(lengths),
                              jx[2], jx[3], sm_scale=scale, interpret=True))
    out = _k2_emulate(q, k, v, ks, vs, table, lengths, scale, splits, pps,
                      _check_partial)
    assert _rel_err(out, ref) <= TOL
    assert not out[0].any()                   # empty slot: exact zeros


def test_k2_lane_groups():
    """Dh = 128: one row per warp (L = 32); Dh = 64: two (L = 16); the
    second slice of 4 per lane halves the lanes."""
    assert _lanes(128, 128) == 32 and _lanes(64, 64) == 16
    assert _lanes(16, 16) == 4 and _lanes(256, 256, 2) == 32
    assert _lanes(100, 64) == 32 and _lanes(4, 4) == 1


# ------------------------------------------------------------------ K3 -----
ARITH = {"tf32x3": _mm_tf32x3, "bf16x3": _mm_bf16x3, "tf32": _mm_tf32}


def _trunc_mma(acc, a, b):
    """One MMA: ``acc + a @ b`` with exact products, its sum truncated
    towards 0 into the f32 accumulator, as the tensor cores round it."""
    exact = acc.astype(np.float64) + a.astype(np.float64) @ b
    out = exact.astype(F32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], F32(0))
    return out


# keys per MMA of P V, by arithmetic
PV_STEP = {"tf32x3": 8, "bf16x3": 16, "tf32": 8}
# the arithmetics whose P V K3 sums in fresh 32-key accumulators
K3_FRESH = ("tf32x3", "bf16x3")


def _pv_terms(arith, p, v):
    """The MMAs' operand pairs for ``p @ v`` over one MMA's keys, in the
    kernel's order: 3xTF32 small*big, big*small, big*big; bf16x3 lo, mid,
    hi terms of P against v exact in bf16."""
    if arith == "tf32x3":
        pb, vb = _tf32(p), _tf32(v)
        return [(_tf32(p - pb), vb), (pb, _tf32(v - vb)), (pb, vb)]
    if arith == "bf16x3":
        hi = _bf16(p)
        mid = _bf16(p - hi)
        return [(_bf16(p - hi - mid), v), (mid, v), (hi, v)]
    return [(_tf32(p), _tf32(v))]


def _pv(o, p, vt, arith, fresh):
    """``o + p @ vt`` over one 64-key tile as K3's MMAs sum it: each MMA's
    sum truncated into its accumulator; with ``fresh`` each 32 keys in a
    fresh accumulator added to ``o`` in f32, else ``o`` itself carries every
    MMA."""
    step, span = PV_STEP[arith], 32 if fresh else p.shape[1]
    for g0 in range(0, p.shape[1], span):
        acc = np.zeros_like(o) if fresh else o
        for j in range(g0, g0 + span, step):
            for a, b in _pv_terms(arith, p[:, j:j + step], vt[j:j + step]):
                acc = _trunc_mma(acc, a, b)
        o = (o + acc).astype(F32) if fresh else acc
    return o


def _k3_emulate(q, k_suf, v_suf, k, v, ks, vs, table, prefix, chunk, scale,
                pre_arith, suf_arith, fresh=K3_FRESH):
    """K3's tensor-core path: ``pre_arith`` / ``suf_arith`` name the
    products of the prefix and suffix phases (keys of an int8 pool are its
    codes, scaled on the scores; ``vs`` on P, not on l); P V truncates each
    MMA's sum, in fresh 32-key accumulators for the arithmetics in
    ``fresh``."""
    b, t, hkv, grp, dh = q.shape
    ps, dv, width = k.shape[1], v.shape[-1], table.shape[1]
    tg = t * grp
    out = np.zeros((b, t, hkv, grp, dv), F32)
    mm_pre, mm_suf = ARITH[pre_arith], ARITH[suf_arith]
    for bi in range(b):
        pfx = min(max(int(prefix[bi]), 0), width * ps)
        cl = min(max(int(chunk[bi]), 0), t)
        for h in range(hkv):
            qh = q[bi, :, h].reshape(tg, dh)          # row R = t * grp + g
            kp, vp = _rows(k, table, bi, h, pfx), _rows(v, table, bi, h, pfx)
            kq = _rows(ks, table, bi, h, pfx) if ks is not None else None
            vq = _rows(vs, table, bi, h, pfx) if vs is not None else None
            for r0 in range(0, tg, 64):
                nrows = min(64, tg - r0)
                kv_end = min((r0 + nrows - 1) // grp + 1, cl)
                n_pt = -(-pfx // 64)
                tiles = [(True, 64 * i) for i in range(n_pt)] + \
                        [(False, j0) for j0 in range(0, kv_end, 64)]
                for w in range(4):
                    rows = np.arange(r0 + 16 * w, r0 + 16 * w + 16)
                    qw = np.zeros((16, dh), F32)
                    live = rows < tg
                    qw[live] = qh[rows[live]]
                    tr = rows // grp
                    m = np.full(16, NEG, F32)
                    l = np.zeros(16, F32)
                    o = np.zeros((16, dv), F32)
                    for pre, j0 in tiles:
                        if not pre and j0 > tr[-1]:
                            continue          # above the warp's diagonal
                        keys = j0 + np.arange(64)
                        kt = np.zeros((64, dh), F32)
                        vt = np.zeros((64, dv), F32)
                        if pre:
                            ok = keys < pfx
                            kt[ok], vt[ok] = kp[keys[ok]], vp[keys[ok]]
                            valid = np.broadcast_to(ok, (16, 64))
                            s = mm_pre(qw, kt.T) * F32(scale)
                            if kq is not None:
                                ksc = np.zeros(64, F32)
                                ksc[ok] = kq[keys[ok]]
                                s = s * ksc
                        else:
                            ok = keys < kv_end
                            kt[ok] = k_suf[bi, keys[ok], h]
                            vt[ok] = v_suf[bi, keys[ok], h]
                            valid = (keys[None] <= tr[:, None]) \
                                & (keys[None] < cl)
                            s = mm_suf(qw, kt.T) * F32(scale)
                        s = np.where(valid, s, NEG).astype(F32)
                        mx = np.maximum(m, s.max(1))
                        corr = np.exp(m - mx)
                        p = np.where(valid, np.exp(s - mx[:, None]), 0) \
                            .astype(F32)
                        l = l * corr + p.sum(1)
                        if pre and vq is not None:
                            vsc = np.zeros(64, F32)
                            vsc[ok] = vq[keys[ok]]
                            p = p * vsc
                        ar = pre_arith if pre else suf_arith
                        o = _pv((o * corr[:, None]).astype(F32), p, vt, ar,
                                ar in fresh)
                        m = mx
                    res = o / np.maximum(l, F32(1e-30))[:, None]
                    for i, rr in enumerate(rows):
                        if rr < tg:
                            out[bi, rr // grp, h, rr % grp] = res[i]
    return out


# (pool kind, suffix type) → (prefix arithmetic, suffix arithmetic), as the
# kernel's instances choose them
INSTANCES = {("f32", "f32"): ("tf32x3", "tf32x3"),
             ("bf16", "bf16"): ("bf16x3", "bf16x3"),
             ("int8", "f32"): ("bf16x3", "tf32x3"),
             ("int8", "bf16"): ("bf16x3", "bf16x3")}


def _k3_case(kind, sdt, ps, grp=2, t=70, seed=0):
    """Inputs of one K3 case: prefixes that are not page-aligned and span
    several 64-key tiles, T not a multiple of 64, a cold slot, a padded
    chunk; and the JAX reference."""
    rng = np.random.default_rng(seed)
    hkv, dh = 2, 16
    prefix = np.array([100, 13, 0], np.int32)
    chunk = np.array([t, 41, t - 5], np.int32)
    b = len(prefix)
    width = -(-int((prefix + chunk).max()) // ps)
    table, n_pages = _table(rng, prefix + chunk, ps, width)
    k, v, ks, vs, jx = _pools(rng, n_pages, ps, hkv, dh, kind)
    q = rng.standard_normal((b, t, hkv, grp, dh)).astype(F32)
    k_suf = rng.standard_normal((b, t, hkv, dh)).astype(F32)
    v_suf = rng.standard_normal((b, t, hkv, dh)).astype(F32)
    if sdt == "bf16":
        k_suf, v_suf = _bf16(k_suf), _bf16(v_suf)
    jdt = jnp.bfloat16 if sdt == "bf16" else jnp.float32
    scale = dh ** -0.5
    ref = np.asarray(j_prefill(
        jnp.asarray(q), jnp.asarray(k_suf, jdt), jnp.asarray(v_suf, jdt),
        jx[0], jx[1], jnp.asarray(table), jnp.asarray(prefix),
        jnp.asarray(chunk), jx[2], jx[3], sm_scale=scale, interpret=True))
    return (q, k_suf, v_suf, k, v, ks, vs, table, prefix, chunk, scale), ref


@pytest.mark.parametrize("ps", [8, 16, 48])
@pytest.mark.parametrize("kind,sdt", list(INSTANCES))
def test_k3_tensor_core_emulation_matches_pallas(kind, sdt, ps):
    args, ref = _k3_case(kind, sdt, ps, seed=ps)
    out = _k3_emulate(*args, *INSTANCES[(kind, sdt)])
    assert _rel_err(out, ref) <= TOL


def test_k3_causal_tile_skip_is_exact():
    """A warp skips the suffix tiles above its diagonal: fully masked
    tiles leave (m, l, acc) as they were, so grp 1, T = 130 (three row
    tiles, the third of 2 rows) gives the reference's result."""
    args, ref = _k3_case("f32", "f32", 16, grp=1, t=130, seed=3)
    out = _k3_emulate(*args, "tf32x3", "tf32x3")
    assert _rel_err(out, ref) <= TOL


def test_k3_plain_tf32_misses_the_tolerance():
    """One TF32 pass per product (10-bit mantissas) is off by far more than
    1e-5 of the output: hence 3xTF32 and the bf16 split."""
    args, ref = _k3_case("f32", "f32", 16, seed=1)
    assert _rel_err(_k3_emulate(*args, "tf32", "tf32"), ref) > 10 * TOL
    assert _rel_err(_k3_emulate(*args, "tf32x3", "tf32x3"), ref) <= TOL


def _k3_long_case(kind, pfx=2048, t=32, grp=2, dh=16, ps=16, seed=0):
    """One slot's chunk of ``t`` queries behind a ``pfx``-token prefix,
    attention peaked (q scaled by 4); int8 pools quantize f32 rows per row
    (scale max |row| / 127).  The reference is float64 softmax attention
    over the dequantized prefix and the causal chunk."""
    rng = np.random.default_rng(seed)
    table, n_pages = _table(rng, [pfx + t], ps, -(-(pfx + t) // ps))
    kf, vf = rng.standard_normal((2, n_pages, ps, 1, dh)).astype(F32)
    k, v, ks, vs = kf, vf, None, None
    if kind == "int8":
        ks, vs = ((np.abs(a).max(-1) / 127).astype(F32) for a in (kf, vf))
        k, v = np.round(kf / ks[..., None]), np.round(vf / vs[..., None])
        kf, vf = k * ks[..., None], v * vs[..., None]
    q = (4 * rng.standard_normal((1, t, 1, grp, dh))).astype(F32)
    k_suf, v_suf = rng.standard_normal((2, 1, t, 1, dh)).astype(F32)
    scale = dh ** -0.5
    keys = np.concatenate([_rows(kf, table, 0, 0, pfx), k_suf[0, :, 0]])
    vals = np.concatenate([_rows(vf, table, 0, 0, pfx), v_suf[0, :, 0]])
    sc = np.einsum("tgd,sd->tgs", q[0, :, 0].astype(np.float64), keys) \
        * scale
    sc = np.where(np.arange(pfx + t)[None, None] <= pfx
                  + np.arange(t)[:, None, None], sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    ref = (p @ vals / p.sum(-1, keepdims=True))[None, :, None]
    args = (q, k_suf, v_suf, k, v, ks, vs, table,
            np.array([pfx], np.int32), np.array([t], np.int32), scale)
    return args, ref


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_k3_fresh_accumulators_bound_the_long_prefix_drift(kind):
    """A 2048-token prefix with peaked attention: P V in one truncating
    accumulator (f32 pools: 864 3xTF32 MMAs; int8 pools: 384 bf16 ones on
    the prefix) misses the 1e-5 tolerance; K3's 32-key groups meet it.  The
    card's bf16 MMAs drift less than this model of them: there one
    accumulator of bf16 terms crosses the tolerance between 4096 and 8192
    prefix tokens (``launch/k3_shares.py``)."""
    args, ref = _k3_long_case(kind)
    inst = INSTANCES[(kind, "f32")]
    assert _rel_err(_k3_emulate(*args, *inst, fresh=()), ref) > TOL
    assert _rel_err(_k3_emulate(*args, *inst), ref) <= 0.5 * TOL
