"""The arithmetic of the redesigned B8 (split-KV paged MLA decode,
``csrc/mla_paged_decode.cu``) and B9 (tensor-core MLA chunked prefill,
``csrc/mla_paged_prefill.cu``), both on the tile of ``csrc/mla_tile.cuh``,
emulated in numpy, against the JAX Pallas kernels in interpret mode (as
``tests/test_torch_mla.py`` runs them) on the same inputs.

The tile: 64 query rows a block (B8: 64 heads of one slot; B9: 64 flattened
``t*H + h`` rows, the last row tile launched first) in row groups of 16,
32-key latent tiles (prefix tiles gathered row by row through the table, so
a tile spans pages of any size; B9's suffix tiles a contiguous slice), a
row group skipping the suffix tiles above its diagonal, one online-softmax
step per tile, scores summed in 32-dimension slices (widths padded to whole
slices), and the operand split of each instance: 3xTF32 (each operand cut
to TF32 by a bit mask as the kernel cuts it) where both operands are f32,
three exact bf16 terms of the f32 operand (cut by bit mask) against bf16
values or int8 codes otherwise.  fp tiles sum the latent and rope scores in
one accumulator; int8 tiles keep them apart for their own row scales
(``s_lat * cs + s_pe * ps``) and scale P by ``cs``, not l.  A row group's
two warps split each tile's keys 16 / 16 for the scores and keep l over
their own keys, added at the end; both multiply the whole tile's P into
their half of the value columns, which computes each column as one warp
would, so the emulation holds all of them at once.

B8's split rule (``mla_decode_splits``, the wrapper's own function: static
shapes only), each split's partial state (m, l, acc), the empty state of a
split past the slot's length, and the fixed split-order combine.

P V: each MMA's exact products summed and truncated towards 0 into its f32
accumulator, as the tensor cores round; the tile sums each 32-key tile in
a fresh accumulator added to the output in f32.  Over a long peaked key
range one accumulator drifts past the tolerance (the last tests: a B9
prefix and a B8 split of 2048 keys in f32, 4096 with the bf16 terms).

Tolerance 1e-5 relative to max(1, max |ref|), as the card tests; plain TF32
products miss it at r = 512 (the last test), which is why the split is
there.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.paged_attention import mla_paged_attention as j_decode
from repro.kernels.paged_attention import mla_paged_prefill as j_prefill
from repro_torch.kernels import paged_attention as TPA

TOL = 1e-5
NEG = np.float32(-1e30)
F32 = np.float32
ROWS, KEYS, GROUP = 64, 32, 16


def _rel_err(a, ref):
    return float(np.abs(a - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _bf16(a):
    """Round f32 to bf16 (nearest, ties to even), returned as f32."""
    b = np.ascontiguousarray(a, F32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


def _tf32(a):
    """Cut f32 to TF32 (its low 13 mantissa bits cleared), as f32."""
    b = np.ascontiguousarray(a, F32).view(np.uint32)
    return (b & 0xFFFFE000).astype(np.uint32).view(F32)


def _mm_tf32x3(a, b):
    """a @ b as 3xTF32: small*big + big*small + big*big."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (asm @ bb + ab @ bsm + ab @ bb).astype(F32)


def _trunc16(a):
    """Cut f32 to bf16 by clearing its low 16 bits, as f32."""
    b = np.ascontiguousarray(a, F32).view(np.uint32)
    return (b & 0xFFFF0000).astype(np.uint32).view(F32)


def _mm_bf16x3(a, b):
    """a @ b with f32 ``a`` in three exact bf16 terms cut by bit mask (hi
    and mid each the top 8 significant bits of what is left, lo the
    rest), against ``b`` exact in bf16 (bf16 values or int8 codes)."""
    assert np.array_equal(_bf16(b), b)
    hi = _trunc16(a)
    mid = _trunc16(a - hi)
    lo = (a - hi - mid).astype(F32)
    assert np.array_equal(_trunc16(lo), lo)          # lo is a bf16 value
    assert np.array_equal(hi + mid + lo, a)          # the split is exact
    return (lo @ b + mid @ b + hi @ b).astype(F32)


def _mm_tf32(a, b):
    """Plain TF32: one pass on operands cut to TF32."""
    return (_tf32(a) @ _tf32(b)).astype(F32)


ARITH = {"tf32x3": _mm_tf32x3, "bf16x3": _mm_bf16x3, "tf32": _mm_tf32}
SLICE = 32       # score dimensions summed in one accumulator


def _pad_slices(a):
    """``a`` [n, d] zero-padded to whole SLICE-wide slices, as staged."""
    return np.pad(a, ((0, 0), (0, -a.shape[1] % SLICE)))


def _scores(mm, q, k):
    """q @ k.T as the tile sums it: SLICE-dimension slices, each product
    on its own, added in f32."""
    s = np.zeros((q.shape[0], k.shape[0]), F32)
    for c in range(0, q.shape[1], SLICE):
        s = s + mm(q[:, c:c + SLICE], k[:, c:c + SLICE].T)
    return s


# ------------------------------------------------------ P V's MMAs ------
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
# the arithmetics whose P V the tile sums in a fresh accumulator per 32-key
# tile (every exact one)
MLA_FRESH = ("tf32x3", "bf16x3")


def _pv_terms(arith, p, v):
    """The MMAs' operand pairs for ``p @ v`` over one MMA's keys, in the
    tile's order: 3xTF32 small*big, big*small, big*big; the lo, mid and hi
    bf16 terms of P (cut by bit mask) against v exact in bf16."""
    if arith == "tf32x3":
        pb, vb = _tf32(p), _tf32(v)
        return [(_tf32(p - pb), vb), (pb, _tf32(v - vb)), (pb, vb)]
    if arith == "bf16x3":
        hi = _trunc16(p)
        mid = _trunc16(p - hi)
        return [((p - hi - mid).astype(F32), v), (mid, v), (hi, v)]
    return [(_tf32(p), _tf32(v))]


def _pv(o, p, vt, arith, fresh):
    """``o + p @ vt`` over one 32-key tile as the tile's MMAs sum it: each
    MMA's sum truncated into its accumulator; with ``fresh`` into a fresh
    accumulator added to ``o`` in f32, else ``o`` itself carries every MMA
    of the key range."""
    acc = np.zeros_like(o) if fresh else o
    step = PV_STEP[arith]
    for j in range(0, p.shape[1], step):
        for a, b in _pv_terms(arith, p[:, j:j + step], vt[j:j + step]):
            acc = _trunc_mma(acc, a, b)
    return (o + acc).astype(F32) if fresh else acc


# ------------------------------------------------------------ inputs ------
def _pools(rng, n_pages, ps, r, dr, kind):
    """Latent pools of ``kind`` as f32 values (bf16-rounded, or int8 codes)
    plus f32 row scales for int8, and the arrays the JAX kernels take."""
    if kind == "int8":
        ckv = rng.integers(-127, 128, (n_pages, ps, r)).astype(F32)
        kpe = rng.integers(-127, 128, (n_pages, ps, dr)).astype(F32)
        cs = rng.uniform(0.002, 0.03, (n_pages, ps)).astype(F32)
        pe = rng.uniform(0.002, 0.03, (n_pages, ps)).astype(F32)
        jx = (jnp.asarray(ckv.astype(np.int8)),
              jnp.asarray(kpe.astype(np.int8)), jnp.asarray(cs),
              jnp.asarray(pe))
        return ckv, kpe, cs, pe, jx
    ckv = rng.standard_normal((n_pages, ps, r)).astype(F32)
    kpe = rng.standard_normal((n_pages, ps, dr)).astype(F32)
    if kind == "bf16":
        ckv, kpe = _bf16(ckv), _bf16(kpe)
        return ckv, kpe, None, None, (jnp.asarray(ckv, jnp.bfloat16),
                                      jnp.asarray(kpe, jnp.bfloat16),
                                      None, None)
    return ckv, kpe, None, None, (jnp.asarray(ckv), jnp.asarray(kpe), None,
                                  None)


def _table(rng, rows, ps, width):
    """Shuffled distinct pages for each slot's live rows, trash page 0
    beyond; returns (table, number of pool pages)."""
    live = [-(-int(n) // ps) for n in rows]
    n_pages = 1 + sum(live)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((len(rows), width), np.int32)
    k = 0
    for i, n in enumerate(live):
        table[i, :n] = perm[k:k + n]
        k += n
    return table, n_pages


def _rows(pool, table, b, n):
    """Rows 0..n-1 of slot b through the table, one row at a time."""
    if pool is None:
        return None
    ps = pool.shape[1]
    idx = np.arange(n)
    return pool[table[b, idx // ps], idx % ps]


# ------------------------------------------------------- the tile --------
def _key_tile(ckv, kpe, cs, ps, j0, n):
    """Keys j0..j0+31 of the given rows (first n live, the rest zero)."""
    live = min(KEYS, n - j0)
    ct = np.zeros((KEYS, ckv.shape[1]), F32)
    kt = np.zeros((KEYS, kpe.shape[1]), F32)
    ct[:live], kt[:live] = ckv[j0:j0 + live], kpe[j0:j0 + live]
    sc = None
    if cs is not None:
        sc = (np.zeros(KEYS, F32), np.zeros(KEYS, F32))
        sc[0][:live], sc[1][:live] = cs[j0:j0 + live], ps[j0:j0 + live]
    return ct, kt, sc


def _tile_step(state, q_lat, q_pe, ct, kt, sc, valid, scale, arith,
               fresh=MLA_FRESH):
    """One online-softmax step of a row group: ``valid`` [16, 32].  Its
    two warps score keys 0-15 and 16-31 (the latent and rope dimensions
    padded to whole slices) and keep l over their own keys (``l`` [2, 16]);
    both multiply the whole tile's P into the values, each MMA's sum
    truncated (:func:`_pv`)."""
    m, l, o = state
    mm = ARITH[arith]
    ql, cl = _pad_slices(q_lat), _pad_slices(ct)
    qp, kp = _pad_slices(q_pe), _pad_slices(kt)
    if sc is None:        # one accumulator for both score parts
        s = _scores(mm, np.concatenate([ql, qp], 1),
                    np.concatenate([cl, kp], 1)) * F32(scale)
    else:
        s = (_scores(mm, ql, cl) * sc[0] + _scores(mm, qp, kp) * sc[1]) \
            * F32(scale)
    s = np.where(valid, s, NEG).astype(F32)
    mx = np.maximum(m, s.max(1))
    corr = np.exp(m - mx)
    p = np.where(valid, np.exp(s - mx[:, None]), 0).astype(F32)
    l = l * corr + np.stack([p[:, :KEYS // 2].sum(1), p[:, KEYS // 2:].sum(1)])
    if sc is not None:
        p = p * sc[0]                       # value weights carry cs, l not
    o = _pv((o * corr[:, None]).astype(F32), p, ct, arith, arith in fresh)
    return mx, l, o


def _empty(n, r):
    return np.full(n, NEG, F32), np.zeros((2, n), F32), np.zeros((n, r), F32)


def _block_state(state):
    """A row group's state after its key loop: the two warps' l added."""
    m, l, acc = state
    return m, l[0] + l[1], acc


def _merge(states):
    """Split-order combine: m = max m_s, l = sum l_s e^(m_s - m), acc
    likewise."""
    big = np.max([m for m, _, _ in states], axis=0)
    l = np.zeros_like(states[0][1])
    acc = np.zeros_like(states[0][2])
    for m, lj, aj in states:
        w = np.exp(m - big).astype(F32)
        l = l + lj * w
        acc = acc + aj * w[:, None]
    return big, l, acc


def _out(state):
    m, l, acc = state
    return acc / np.maximum(l, F32(1e-30))[:, None]


# ----------------------------------------------------------------- B8 ----
def _b8_emulate(q_lat, q_pe, ckv, kpe, cs, ps, table, lengths, scale,
                splits, pps, arith, fresh=MLA_FRESH):
    b, h, r = q_lat.shape
    page, width = ckv.shape[1], table.shape[1]
    out = np.zeros((b, h, r), F32)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), width * page)
        rows = [_rows(a, table, bi, n) for a in (ckv, kpe, cs, ps)]
        for h0 in range(0, h, ROWS):                  # a block's 64 heads
            for g0 in range(h0, min(h0 + ROWS, h), GROUP):
                g1 = min(g0 + GROUP, h)
                parts = []
                for s in range(splits):
                    row0 = s * pps * page
                    row1 = min(row0 + pps * page, n)
                    state = _empty(g1 - g0, r)
                    for j0 in range(row0, row1, KEYS):
                        ct, kt, sc = _key_tile(*rows[:2], *rows[2:], j0, row1)
                        valid = np.broadcast_to(
                            j0 + np.arange(KEYS) < row1, (g1 - g0, KEYS))
                        state = _tile_step(state, q_lat[bi, g0:g1],
                                           q_pe[bi, g0:g1], ct, kt, sc,
                                           valid, scale, arith, fresh)
                    parts.append(_block_state(state))
                out[bi, g0:g1] = _out(_merge(parts))
    return out


def _b8_case(kind, r, dr, h, ps, lengths, seed):
    rng = np.random.default_rng(seed)
    width = max(-(-max(lengths) // ps), 1) + 1       # a dead entry or more
    table, n_pages = _table(rng, lengths, ps, width)
    ckv, kpe, cs, pe, jx = _pools(rng, n_pages, ps, r, dr, kind)
    b = len(lengths)
    q_lat = rng.standard_normal((b, h, r)).astype(F32)
    q_pe = rng.standard_normal((b, h, dr)).astype(F32)
    lengths = np.asarray(lengths, np.int32)
    scale = (128 + 64) ** -0.5
    ref = np.asarray(j_decode(jnp.asarray(q_lat), jnp.asarray(q_pe), jx[0],
                              jx[1], jnp.asarray(table), jnp.asarray(lengths),
                              jx[2], jx[3], sm_scale=scale, interpret=True))
    return (q_lat, q_pe, ckv, kpe, cs, pe, table, lengths, scale), ref


B8_ARITH = {"f32": "tf32x3", "bf16": "bf16x3", "int8": "bf16x3"}
# (r, dr, heads, page size, lengths): the smoke widths (a slot of length 0,
# lengths that are not page multiples, a slot of several splits); full
# latent width with few heads
B8_SHAPES = {"smoke": (16, 8, 4, 8, [0, 5, 37, 70]),
             "r512": (512, 64, 3, 16, [21, 64, 0])}


@pytest.mark.parametrize("shape", list(B8_SHAPES))
@pytest.mark.parametrize("kind", list(B8_ARITH))
def test_b8_split_emulation_matches_pallas(kind, shape):
    r, dr, h, ps, lengths = B8_SHAPES[shape]
    args, ref = _b8_case(kind, r, dr, h, ps, lengths, seed=len(kind) + r)
    width = args[6].shape[1]
    splits, pps = TPA.mla_decode_splits(len(lengths), h, width, ps, 132)
    assert splits > 1
    out = _b8_emulate(*args, splits, pps, B8_ARITH[kind])
    assert _rel_err(out, ref) <= TOL
    assert not out[list(lengths).index(0)].any()   # empty slot: exact zeros
    # one split, as at a full batch: the same result
    one = _b8_emulate(*args, 1, width, B8_ARITH[kind])
    assert _rel_err(one, ref) <= TOL


def test_b8_split_rule_reads_static_shapes_only():
    """The rule's inputs are the batch, heads, table pages, page size and
    SMs — no lengths — so two steps of one batch shape take the same
    splits, and both give the reference's result through the split-order
    combine.  One block per SM, each split at least one 32-key tile."""
    assert list(inspect.signature(TPA.mla_decode_splits).parameters) == [
        "b", "h", "pages", "ps", "sms"]
    # path 4's decode: 4 slots x 128 heads = 8 blocks, 16 pages of 16 rows
    assert TPA.mla_decode_splits(4, 128, 16, 16, 132) == (8, 2)
    assert TPA.mla_decode_splits(64, 128, 16, 16, 132) == (1, 16)
    for b, h, p, ps, sms in [(4, 128, 16, 16, 132), (1, 4, 40, 8, 132),
                             (3, 200, 7, 64, 8), (2, 64, 0, 16, 132),
                             (300, 128, 16, 16, 132), (1, 128, 63, 16, 132)]:
        s, pps = TPA.mla_decode_splits(b, h, p, ps, sms)
        assert 1 <= s <= max(1, min(p, 32)) and pps >= 1
        assert (s - 1) * pps < max(p, 1) <= s * pps
        assert s == 1 or b * -(-h // 64) * s <= sms
        assert s == 1 or pps * ps >= 32
    for lengths in ([3, 60], [60, 0]):
        args, ref = _b8_case("f32", 16, 8, 4, 8, lengths, seed=5)
        splits, pps = TPA.mla_decode_splits(2, 4, args[6].shape[1], 8, 132)
        assert _rel_err(_b8_emulate(*args, splits, pps, "tf32x3"),
                        ref) <= TOL


# ----------------------------------------------------------------- B9 ----
def _b9_emulate(q_lat, q_pe, c_suf, k_suf, ckv, kpe, cs, ps, table, prefix,
                chunk, scale, pre_arith, suf_arith, fresh=MLA_FRESH):
    b, t, h, r = q_lat.shape
    dr = q_pe.shape[-1]
    page, width = ckv.shape[1], table.shape[1]
    th = t * h
    out = np.zeros((b, th, r), F32)
    for bi in range(b):
        pfx = min(max(int(prefix[bi]), 0), width * page)
        cl = min(max(int(chunk[bi]), 0), t)
        rows = [_rows(a, table, bi, pfx) for a in (ckv, kpe, cs, ps)]
        ql = q_lat[bi].reshape(th, r)                # row R = t * h + head
        qp = q_pe[bi].reshape(th, dr)
        n_rt = -(-th // ROWS)
        for rt in reversed(range(n_rt)):             # last row tile first
            r0 = rt * ROWS
            nrows = min(ROWS, th - r0)
            kv_end = min((r0 + nrows - 1) // h + 1, cl)
            for g0 in range(r0, r0 + ROWS, GROUP):
                rid = np.arange(g0, g0 + GROUP)
                live = rid < th
                qg = np.zeros((GROUP, r), F32)
                pg = np.zeros((GROUP, dr), F32)
                qg[live], pg[live] = ql[rid[live]], qp[rid[live]]
                tr = rid // h
                state = _empty(GROUP, r)
                for j0 in range(0, pfx, KEYS):
                    ct, kt, sc = _key_tile(*rows[:2], *rows[2:], j0, pfx)
                    valid = np.broadcast_to(j0 + np.arange(KEYS) < pfx,
                                            (GROUP, KEYS))
                    state = _tile_step(state, qg, pg, ct, kt, sc, valid,
                                       scale, pre_arith, fresh)
                for j0 in range(0, kv_end, KEYS):
                    if j0 > min(tr[-1], cl - 1):
                        continue             # above the group's diagonal
                    ct, kt, _ = _key_tile(c_suf[bi], k_suf[bi], None, None,
                                          j0, kv_end)
                    keys = j0 + np.arange(KEYS)
                    valid = (keys[None] <= tr[:, None]) & (keys[None] < cl)
                    state = _tile_step(state, qg, pg, ct, kt, None, valid,
                                       scale, suf_arith, fresh)
                res = _out(_block_state(state))
                out[bi, rid[live]] = res[live]
    return out.reshape(b, t, h, r)


def _b9_case(kind, sdt, r, dr, h, ps, t, prefix, chunk, seed):
    rng = np.random.default_rng(seed)
    prefix = np.asarray(prefix, np.int32)
    chunk = np.asarray(chunk, np.int32)
    b = len(prefix)
    width = max(-(-int((prefix + chunk).max()) // ps), 1)
    table, n_pages = _table(rng, prefix + chunk, ps, width)
    ckv, kpe, cs, pe, jx = _pools(rng, n_pages, ps, r, dr, kind)
    q_lat = rng.standard_normal((b, t, h, r)).astype(F32)
    q_pe = rng.standard_normal((b, t, h, dr)).astype(F32)
    c_suf = rng.standard_normal((b, t, r)).astype(F32)
    k_suf = rng.standard_normal((b, t, dr)).astype(F32)
    if sdt == "bf16":
        c_suf, k_suf = _bf16(c_suf), _bf16(k_suf)
    jdt = jnp.bfloat16 if sdt == "bf16" else jnp.float32
    scale = (128 + 64) ** -0.5
    ref = np.asarray(j_prefill(
        jnp.asarray(q_lat), jnp.asarray(q_pe), jnp.asarray(c_suf, jdt),
        jnp.asarray(k_suf, jdt), jx[0], jx[1], jnp.asarray(table),
        jnp.asarray(prefix), jnp.asarray(chunk), jx[2], jx[3], sm_scale=scale,
        interpret=True))
    return (q_lat, q_pe, c_suf, k_suf, ckv, kpe, cs, pe, table, prefix, chunk,
            scale), ref


# (pool kind, suffix type) → (prefix arithmetic, suffix arithmetic), as the
# kernel's instances choose them
B9_INSTANCES = {("f32", "f32"): ("tf32x3", "tf32x3"),
                ("bf16", "bf16"): ("bf16x3", "bf16x3"),
                ("int8", "f32"): ("bf16x3", "tf32x3"),
                ("int8", "bf16"): ("bf16x3", "bf16x3")}
# (r, dr, heads, page size, T, prefix, chunk): the smoke widths with three
# row tiles (the last of 32 rows), a prefix spanning tiles and pages, a
# cold slot, padding rows; full latent width with few heads
B9_SHAPES = {"smoke": (16, 8, 4, 8, 40, [45, 0, 13], [40, 33, 1]),
             "r512": (512, 64, 2, 16, 20, [37, 0], [20, 13])}


@pytest.mark.parametrize("shape", list(B9_SHAPES))
@pytest.mark.parametrize("kind,sdt", list(B9_INSTANCES))
def test_b9_tile_emulation_matches_pallas(kind, sdt, shape):
    args, ref = _b9_case(kind, sdt, *B9_SHAPES[shape], seed=len(kind + sdt))
    out = _b9_emulate(*args, *B9_INSTANCES[(kind, sdt)])
    assert _rel_err(out, ref) <= TOL


def test_b9_causal_tile_skip_is_exact():
    """T*H = 16 rows a token (H = 16): each row group is one token, so the
    groups of the first 32 tokens skip the second suffix tile entirely and
    the diagonal tile is masked; the result is the reference's."""
    args, ref = _b9_case("f32", "f32", 16, 8, 16, 8, 40, [9], [40], seed=3)
    out = _b9_emulate(*args, "tf32x3", "tf32x3")
    assert _rel_err(out, ref) <= TOL


def test_plain_tf32_misses_the_tolerance_at_full_width():
    """One TF32 pass per product (10-bit mantissas) over r + dr = 576 is
    off by far more than 1e-5 of the output; 3xTF32 is not."""
    args, ref = _b9_case("f32", "f32", *B9_SHAPES["r512"], seed=1)
    assert _rel_err(_b9_emulate(*args, "tf32", "tf32"), ref) > 10 * TOL
    assert _rel_err(_b9_emulate(*args, "tf32x3", "tf32x3"), ref) <= TOL
    args, ref = _b8_case("f32", *B8_SHAPES["r512"], seed=2)
    split = TPA.mla_decode_splits(3, 3, args[6].shape[1], 16, 132)
    assert _rel_err(_b8_emulate(*args, *split, "tf32"), ref) > 10 * TOL
    assert _rel_err(_b8_emulate(*args, *split, "tf32x3"), ref) <= TOL


# ------------------------------------------ long key ranges (C.3) --------
def _mla_long_case(kind, pfx, t=16, r=512, dr=64, ps=16, seed=0):
    """One slot, one query head: a chunk of ``t`` tokens behind a
    ``pfx``-token prefix of latent pages, attention peaked (q scaled by
    4).  ``kind`` f32 / bf16 pools, or int8 pools written as the engine
    writes them (per row, scale max |row| / 127).  The reference is float64
    softmax attention over the dequantized prefix and the causal chunk."""
    rng = np.random.default_rng(seed)
    table, n_pages = _table(rng, [pfx + t], ps, -(-(pfx + t) // ps))
    ckv = rng.standard_normal((n_pages, ps, r)).astype(F32)
    kpe = rng.standard_normal((n_pages, ps, dr)).astype(F32)
    cs = pe = None
    if kind == "bf16":
        ckv, kpe = _bf16(ckv), _bf16(kpe)
    elif kind == "int8":
        cs, pe = ((np.abs(a).max(-1) / 127).astype(F32) for a in (ckv, kpe))
        ckv = np.round(ckv / cs[..., None]).astype(F32)
        kpe = np.round(kpe / pe[..., None]).astype(F32)
    q_lat = (4 * rng.standard_normal((1, t, 1, r))).astype(F32)
    q_pe = (4 * rng.standard_normal((1, t, 1, dr))).astype(F32)
    c_suf = rng.standard_normal((1, t, r)).astype(F32)
    k_suf = rng.standard_normal((1, t, dr)).astype(F32)
    if kind == "bf16":
        c_suf, k_suf = _bf16(c_suf), _bf16(k_suf)
    scale = (128 + 64) ** -0.5
    deq = [_rows(a, table, 0, pfx).astype(np.float64) for a in (ckv, kpe)]
    if kind == "int8":
        deq[0] = deq[0] * _rows(cs, table, 0, pfx)[:, None]
        deq[1] = deq[1] * _rows(pe, table, 0, pfx)[:, None]
    keys = np.concatenate([np.concatenate(deq, 1),
                           np.concatenate([c_suf[0], k_suf[0]], 1)])
    vals = np.concatenate([deq[0], c_suf[0]])
    qf = np.concatenate([q_lat[0, :, 0], q_pe[0, :, 0]], 1).astype(np.float64)
    sc = qf @ keys.T * scale
    sc = np.where(np.arange(pfx + t)[None] <= pfx + np.arange(t)[:, None],
                  sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    ref = (p @ vals / p.sum(-1, keepdims=True))[None, :, None]
    args = (q_lat, q_pe, c_suf, k_suf, ckv, kpe, cs, pe, table,
            np.array([pfx], np.int32), np.array([t], np.int32), scale)
    return args, ref


def _b8_long_case(kind, n, h=16, r=512, dr=64, ps=16, seed=0):
    """One slot of ``n`` latent rows decoded by ``h`` heads, attention
    peaked (q scaled by 4); pools as :func:`_mla_long_case`'s; the float64
    reference."""
    args, _ = _mla_long_case(kind, n, t=h, r=r, dr=dr, ps=ps, seed=seed)
    q_lat, q_pe, _, _, ckv, kpe, cs, pe, table, _, _, scale = args
    q_lat, q_pe = q_lat[:, :, 0], q_pe[:, :, 0]       # [1, h, ·]
    deq = [_rows(a, table, 0, n).astype(np.float64) for a in (ckv, kpe)]
    if kind == "int8":
        deq[0] = deq[0] * _rows(cs, table, 0, n)[:, None]
        deq[1] = deq[1] * _rows(pe, table, 0, n)[:, None]
    qf = np.concatenate([q_lat[0], q_pe[0]], 1).astype(np.float64)
    sc = qf @ np.concatenate(deq, 1).T * scale
    p = np.exp(sc - sc.max(-1, keepdims=True))
    ref = (p @ deq[0] / p.sum(-1, keepdims=True))[None]
    return (q_lat, q_pe, ckv, kpe, cs, pe, table,
            np.array([n], np.int32), scale), ref


# (pool kind, key range): f32 crosses the tolerance on one accumulator
# behind 2048 keys, the bf16 terms (bf16 values, int8 codes) behind 4096
LONG = [("f32", 2048), ("bf16", 4096), ("int8", 4096)]


@pytest.mark.parametrize("kind,pfx", LONG)
def test_b9_fresh_accumulators_bound_the_long_prefix_drift(kind, pfx):
    """A chunk behind a long prefix with peaked attention: P V carried in
    one truncating accumulator over the whole key range (f32 pools: 768
    3xTF32 MMAs a 2048-token prefix) misses the 1e-5 tolerance; the tile's
    fresh accumulator per 32-key tile meets it.  The card's bf16 MMAs
    drift less than this model of them (``launch/mla_shares.py``)."""
    args, ref = _mla_long_case(kind, pfx)
    inst = B9_INSTANCES[(kind, "bf16" if kind == "bf16" else "f32")]
    assert _rel_err(_b9_emulate(*args, *inst, fresh=()), ref) > TOL
    assert _rel_err(_b9_emulate(*args, *inst), ref) <= 0.5 * TOL


@pytest.mark.parametrize("kind,n", LONG)
def test_b8_fresh_accumulators_bound_a_long_split(kind, n):
    """B8 caps its splits at 32, so one slot at 65,536 (131,072) positions
    gives each split 2048 (4096) keys, one accumulator's worth before the
    combine: one truncating accumulator misses the tolerance there, the
    tile's fresh one per 32-key tile meets it."""
    for pos, keys in ((65536, 2048), (131072, 4096)):
        splits, pps = TPA.mla_decode_splits(1, 128, pos // 16, 16, 132)
        assert (splits, pps * 16) == (32, keys)
    args, ref = _b8_long_case(kind, n)
    arith = B8_ARITH[kind]
    one_split = (1, args[6].shape[1])
    assert _rel_err(_b8_emulate(*args, *one_split, arith, fresh=()),
                    ref) > TOL
    assert _rel_err(_b8_emulate(*args, *one_split, arith), ref) <= 0.5 * TOL
