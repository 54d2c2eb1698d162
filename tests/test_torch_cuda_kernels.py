"""The port's CUDA kernels (K1 W4A16 GEMM, B5 W4A8 GEMM, K2 paged decode and
K3 paged chunked prefill, fp and int8 pools, B6/B7 grouped expert GEMMs, B4
flash attention, B8/B9 absorbed MLA paged decode and chunked prefill, fp and
int8 latent pools) against their plain PyTorch versions on the card.

Marked ``cuda``: skipped where there is no GPU.  Run on the GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.

Tolerances, relative to the largest |reference| value: f32 outputs 1e-5
(sums in another order); K1/B5/B6/B7 and B4 with bf16 activations 1e-2
(the output is rounded to bf16).  K1 and B6 run the tensor-core tile of
``csrc/w4a16_tile.cuh``, B5 and B7 the int8 one of ``csrc/w4a8_tile.cuh``,
both on the ring of ``csrc/w4_ring.cuh``: group sizes 8 to 256 (G = 256
walks two ring stages a group), row tiles (8 and 64), split-K, an
offset-only group, bitwise repeatability and B6's and B7's ``rows`` (idle
experts' scales poisoned with NaN: never read) are tested on their own.  Dead table
entries point at a trash page filled with NaN (int8 pools: codes -128 and
NaN scales): the kernels must never read it (the plain versions are given
a clean copy).  K2 (split-KV with a split-order combine) and K3 (tensor-core
tiles), and B8 (split-KV) and B9 on the tensor-core tile of
``csrc/mla_tile.cuh``, are also tested at the paths' shapes and at every
shape class that takes another of their code paths (B8/B9: r > 512 takes
the CUDA-core kernel, by shape), for bitwise repeatability, and in a CUDA
graph replayed after the lengths, table and prefix lengths change in place;
over long key ranges with peaked scores (B9 behind 2048 and 8192 prefix
tokens, B8 at 65,536 positions) they are held to a float64 evaluation,
since there the plain version's own f32 scores are about the tolerance
off (``launch/mla_shares.py``).
The dense decoders' shapes: K2/K3 at their (Hkv, grp) (8, 3), (4, 7),
(4, 12), (2, 16), (8, 12) with Dh 128 at path 1's lengths and chunks (K3
also behind prefixes), fp and int8 pools, and K1 at their MLP widths
(4096 ↔ 13696, 6144 ↔ 24576, 12288 ↔ 28672) at T=4 and 512.
B4, on K3's tile (``csrc/attn_tile.cuh``), likewise: head widths 8 to 256
and the widths past one ring stage that take its CUDA-core kernel (the
route at each), causal S > T, non-causal S > T, ragged T*grp, grp 1 to 8.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core.quantize import quantize
from repro_torch.device import strict_fp32_matmul
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import w4a16_grouped as W4G
from repro_torch.kernels import w4a16_matmul as W4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    strict_fp32_matmul()
    return torch.device("cuda")


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("xdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("t,ci,co,g", [(1, 256, 96, 32), (5, 128, 48, 16),
                                       (21, 512, 200, 128), (4, 4096, 11008, 128),
                                       (64, 11008, 4096, 128),
                                       (4, 4096, 4096, 256),
                                       (65, 768, 200, 256), (9, 64, 40, 8)])
def test_w4a16_kernel_matches_plain(dev, t, ci, co, g, xdt, sdt):
    gen = torch.Generator(device=dev).manual_seed(t + co)
    w = torch.randn(ci, co, generator=gen, device=dev) * ci ** -0.5
    qt = quantize(w, group_size=g, dtype=sdt)
    x = torch.randn(t, ci, generator=gen, device=dev).to(xdt)
    before = W4.w4a16_matmul_cuda.launches
    y = ops.w4a16_matmul(x, qt)
    torch.cuda.synchronize()
    assert W4.w4a16_matmul_cuda.launches == before + 1
    assert y.dtype == xdt and tuple(y.shape) == (t, co)
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(y, W4.w4a16_matmul_plain(x, qt)) <= tol


# the SSM paths' GEMMs: zamba2-7b's Mamba2 in_dt (3584 -> 112) and in_bc
# (3584 -> 128), narrower than one K1 tile, the same at Ci 7168, and its
# out_proj (7168 -> 3584)
SSM_WIDTHS = [(3584, 112), (3584, 128), (7168, 112), (7168, 128),
              (7168, 3584)]


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [4, 256])
@pytest.mark.parametrize("ci,co", SSM_WIDTHS)
def test_w4a16_kernel_ssm_widths(dev, ci, co, t, xdt):
    gen = torch.Generator(device=dev).manual_seed(ci + co + t)
    w = torch.randn(ci, co, generator=gen, device=dev) * ci ** -0.5
    qt = quantize(w, group_size=128, dtype=xdt)
    x = torch.randn(t, ci, generator=gen, device=dev).to(xdt)
    y = ops.w4a16_matmul(x, qt)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (t, co) and y.dtype == xdt
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(y, W4.w4a16_matmul_plain(x, qt)) <= tol


# the dense decoders' GEMM widths: chatglm3-6b, starcoder2-15b,
# mistral-large-123b
DENSE_WIDTHS = [(4096, 13696), (13696, 4096), (6144, 24576), (24576, 6144),
                (12288, 28672), (28672, 12288)]


@pytest.mark.parametrize("t", [4, 512])
@pytest.mark.parametrize("ci,co", DENSE_WIDTHS)
def test_w4a16_kernel_dense_widths(dev, ci, co, t):
    gen = torch.Generator(device=dev).manual_seed(ci + co + t)
    w = torch.randn(ci, co, generator=gen, device=dev) * ci ** -0.5
    qt = quantize(w, group_size=128)
    del w
    x = torch.randn(t, ci, generator=gen, device=dev)
    y = ops.w4a16_matmul(x, qt)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (t, co)
    assert _rel_err(y, W4.w4a16_matmul_plain(x, qt)) <= 1e-5


@pytest.mark.parametrize("xdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("t,ci,co,g", [(16, 256, 96, 32), (21, 512, 200, 128),
                                       (33, 96, 112, 16), (64, 4096, 11008, 128),
                                       (512, 11008, 4096, 128),
                                       (40, 144, 72, 48), (16, 64, 40, 8),
                                       (64, 4096, 4096, 256),
                                       (129, 768, 256, 256)])
def test_w4a8_kernel_matches_plain(dev, t, ci, co, g, xdt, sdt):
    gen = torch.Generator(device=dev).manual_seed(t + co + 1)
    w = torch.randn(ci, co, generator=gen, device=dev) * ci ** -0.5
    qt = quantize(w, group_size=g, dtype=sdt)
    zeros = qt.zeros.clone()              # a group whose fold needs the clip
    zeros[0, :4] = torch.tensor([140.0, 130.0, -150.0, -114.0])
    qt = dataclasses.replace(qt, zeros=zeros)
    x = torch.randn(t, ci, generator=gen, device=dev).to(xdt)
    before = W4.w4a8_matmul_cuda.launches
    y = ops.w4a16_matmul(x, qt, act="a8")
    torch.cuda.synchronize()
    assert W4.w4a8_matmul_cuda.launches == before + 1
    assert y.dtype == xdt and tuple(y.shape) == (t, co)
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(y, W4.w4a8_matmul_plain(x, qt)) <= tol


def test_a8_gate_on_the_card(dev):
    w = torch.randn(256, 64, device=dev) * 256 ** -0.5
    qt = quantize(w, group_size=32)
    x = torch.randn(16, 256, device=dev)
    K.reset_launch_counts()
    ops.w4a16_matmul(x[:15], qt, act="a8")                       # decode-sized
    ops.w4a16_matmul(x, dataclasses.replace(qt, a8=False), act="a8")
    ops.w4a16_matmul(x, qt, act="a8")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["w4a16_matmul"], counts["w4a8_matmul"]) == (2, 1)


def _paged(dev, dt, b, grp, lengths, ps=16, hkv=4, dh=128, pages=5, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * pages
    kp = torch.randn(n_pages, ps, hkv, dh, generator=gen, device=dev).to(dt)
    vp = torch.randn(n_pages, ps, hkv, dh, generator=gen, device=dev).to(dt)
    table = torch.zeros(b, pages, dtype=torch.int32)
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    k = 0
    for i, n in enumerate(lengths):
        live = -(-int(n) // ps)
        table[i, :live] = torch.from_numpy(perm[k:k + live].astype(np.int32))
        k += live
    return kp, vp, table.to(dev)


def _poison_trash(pool):
    bad = pool.clone()
    bad[0] = float("nan")
    return bad


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grp", [1, 3, 8])
def test_decode_kernel_matches_plain(dev, dt, grp):
    lengths = torch.tensor([1, 17, 80, 33, 0], dtype=torch.int32, device=dev)
    b = len(lengths)
    kp, vp, table = _paged(dev, dt, b, grp, lengths.tolist(), seed=grp)
    q = torch.randn(b, 4, grp, 128, device=dev)
    ref = PA.gqa_paged_attention_plain(q, kp, vp, table, lengths,
                                       sm_scale=128 ** -0.5)
    out = ops.gqa_paged_attention(q, _poison_trash(kp), _poison_trash(vp),
                                  table, lengths, sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= 1e-5
    assert not out[-1].any()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grp,t", [(1, 8), (3, 33), (1, 64)])
def test_prefill_kernel_matches_plain(dev, dt, grp, t):
    prefix = torch.tensor([0, 5, 16, 40, 0], dtype=torch.int32, device=dev)
    chunk = torch.tensor([t, 3, t - 1, 0, 0], dtype=torch.int32, device=dev)
    b = len(prefix)
    kp, vp, table = _paged(dev, dt, b, grp,
                           (prefix + chunk).tolist(), seed=10 + grp)
    gen = torch.Generator(device=dev).manual_seed(t)
    q = torch.randn(b, t, 4, grp, 128, generator=gen, device=dev)
    ks = torch.randn(b, t, 4, 128, generator=gen, device=dev).to(dt)
    vs = torch.randn(b, t, 4, 128, generator=gen, device=dev).to(dt)
    ref = PA.gqa_paged_prefill_plain(q, ks, vs, kp, vp, table, prefix, chunk,
                                     sm_scale=128 ** -0.5)
    out = ops.gqa_paged_prefill(q, ks, vs, _poison_trash(kp),
                                _poison_trash(vp), table, prefix, chunk,
                                sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= 1e-5
    assert not out[4].any()


def _int8_paged(dev, b, lengths, seed, ps=16, hkv=4, dh=128, pages=5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    kp, vp, table = _paged(dev, torch.float32, b, 1, lengths, ps, hkv, dh,
                           pages, seed)
    kq = torch.randint(-127, 128, kp.shape, generator=gen, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, vp.shape, generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(kp.shape[:3], generator=gen, device=dev) * 0.03 + 1e-3
    vs = torch.rand(kp.shape[:3], generator=gen, device=dev) * 0.03 + 1e-3
    return kq, vq, ks, vs, table


def _poison_int8(codes, scales):
    bad_c, bad_s = codes.clone(), scales.clone()
    bad_c[0] = -128                       # 0x80
    bad_s[0] = float("nan")
    return bad_c, bad_s


@pytest.mark.parametrize("grp", [1, 3, 8])
def test_int8_decode_kernel_matches_plain(dev, grp):
    lengths = torch.tensor([1, 17, 80, 33, 0], dtype=torch.int32, device=dev)
    b = len(lengths)
    kq, vq, ks, vs, table = _int8_paged(dev, b, lengths.tolist(), 40 + grp)
    q = torch.randn(b, 4, grp, 128, device=dev)
    ref = PA.gqa_paged_attention_plain(q, kq, vq, table, lengths, ks, vs,
                                       sm_scale=128 ** -0.5)
    (kb, ksb), (vb, vsb) = _poison_int8(kq, ks), _poison_int8(vq, vs)
    before = PA.gqa_paged_attention_int8_cuda.launches
    out = ops.gqa_paged_attention(q, kb, vb, table, lengths, ksb, vsb,
                                  sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert PA.gqa_paged_attention_int8_cuda.launches == before + 1
    assert _rel_err(out, ref) <= 1e-5
    assert not out[-1].any()


@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grp,t", [(1, 8), (3, 33), (1, 64)])
def test_int8_prefill_kernel_matches_plain(dev, sdt, grp, t):
    prefix = torch.tensor([0, 5, 16, 40, 0], dtype=torch.int32, device=dev)
    chunk = torch.tensor([t, 3, t - 1, 0, 0], dtype=torch.int32, device=dev)
    b = len(prefix)
    kq, vq, ks, vs, table = _int8_paged(dev, b, (prefix + chunk).tolist(),
                                        50 + grp)
    gen = torch.Generator(device=dev).manual_seed(t + 1)
    q = torch.randn(b, t, 4, grp, 128, generator=gen, device=dev)
    k_suf = torch.randn(b, t, 4, 128, generator=gen, device=dev).to(sdt)
    v_suf = torch.randn(b, t, 4, 128, generator=gen, device=dev).to(sdt)
    ref = PA.gqa_paged_prefill_plain(q, k_suf, v_suf, kq, vq, table, prefix,
                                     chunk, ks, vs, sm_scale=128 ** -0.5)
    (kb, ksb), (vb, vsb) = _poison_int8(kq, ks), _poison_int8(vq, vs)
    before = PA.gqa_paged_prefill_int8_cuda.launches
    out = ops.gqa_paged_prefill(q, k_suf, v_suf, kb, vb, table, prefix,
                                chunk, ksb, vsb, sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert PA.gqa_paged_prefill_int8_cuda.launches == before + 1
    assert _rel_err(out, ref) <= 1e-5
    assert not out[4].any()


# K2/K3 at the paths' shapes and at the shapes that take their other code
# paths: the split rule at long lengths, page sizes that do not divide a
# 64-key tile, T not a multiple of 64, prefixes that are not page-aligned,
# grp > 8 (K2's head chunks), Dv != Dh and Dv > 128 (K3's value slices),
# widths that are not multiples of 16 (K3 pads them) or 4, pools that are
# not aligned for wide loads, and rows too wide for K3's tensor-core tile.
def _pools_general(dev, kind, n_pages, ps, hkv, dh, dv, seed, offset=0):
    """(k, v, k_scale, v_scale) of ``kind`` (f32, bf16, or int8 codes with
    f32 row scales), clean; ``offset`` elements shift the pools' data off
    their allocation's alignment."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def one(d):
        n = n_pages * ps * hkv * d
        if kind == torch.int8:
            flat = torch.randint(-127, 128, (n + offset,), generator=gen,
                                 device=dev, dtype=torch.int8)
        else:
            flat = torch.randn(n + offset, generator=gen, device=dev).to(kind)
        return flat[offset:].view(n_pages, ps, hkv, d)

    k, v = one(dh), one(dv)
    if kind != torch.int8:
        return k, v, None, None
    ks = torch.rand(n_pages, ps, hkv, generator=gen, device=dev) * 0.03 + 1e-3
    vs = torch.rand(n_pages, ps, hkv, generator=gen, device=dev) * 0.03 + 1e-3
    return k, v, ks, vs


def _poisoned(pools):
    """The kernel's copy: trash page 0 NaN (int8: codes -128, NaN scales)."""
    out = []
    for t in pools:
        if t is None:
            out.append(None)
            continue
        t = t.clone()
        t[0] = -128 if t.dtype == torch.int8 else float("nan")
        out.append(t)
    return out


def _table_for(dev, rows, ps, width, seed):
    live = [-(-int(n) // ps) for n in rows]
    n_pages = 1 + sum(live)
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    table = torch.zeros(len(rows), width, dtype=torch.int32)
    k = 0
    for i, n in enumerate(live):
        table[i, :n] = torch.from_numpy(perm[k:k + n].astype(np.int32))
        k += n
    return table.to(dev), n_pages


_KINDS = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
# (b, hkv, grp, dh, dv, ps, lengths)
K2_SHAPES = {
    "path1": (4, 32, 1, 128, 128, 16, [216, 150, 90, 33]),
    "path3": (4, 8, 2, 64, 64, 16, [216, 150, 90, 33]),
    "long": (4, 4, 1, 128, 128, 16, [1024, 700, 333, 17]),
    "ps8": (3, 4, 2, 64, 64, 8, [77, 1, 0]),
    "ps32": (3, 4, 3, 128, 128, 32, [100, 33, 64]),
    "grp12": (2, 2, 12, 64, 64, 16, [50, 7]),
    "dv192": (2, 2, 2, 128, 192, 16, [40, 17]),
    "narrow": (2, 2, 1, 36, 20, 16, [40, 17]),
    "wide": (2, 2, 2, 512, 512, 16, [40, 17]),
}


def _k2_case(dev, kind, shape, seed=0, offset=0):
    b, hkv, grp, dh, dv, ps, lengths = shape
    width = max(-(-max(lengths) // ps), 1)
    table, n_pages = _table_for(dev, lengths, ps, width, seed)
    clean = _pools_general(dev, kind, n_pages, ps, hkv, dh, dv, seed, offset)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn(b, hkv, grp, dh, generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, clean, table, lens, dh ** -0.5


def _k2_check(q, clean, table, lens, sc):
    ref = PA.gqa_paged_attention_plain(q, clean[0], clean[1], table, lens,
                                       *clean[2:], sm_scale=sc)
    bad = _poisoned(clean)
    out = ops.gqa_paged_attention(q, bad[0], bad[1], table, lens, *bad[2:],
                                  sm_scale=sc)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _rel_err(out, ref) <= 1e-5
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            assert not out[i].any()
    return out


@pytest.mark.parametrize("kind", list(_KINDS))
@pytest.mark.parametrize("shape", list(K2_SHAPES))
def test_k2_shapes_match_plain(dev, shape, kind):
    _k2_check(*_k2_case(dev, _KINDS[kind], K2_SHAPES[shape]))


@pytest.mark.parametrize("kind,dh,offset", [("f32", 128, 1), ("bf16", 64, 1),
                                            ("f32", 33, 0), ("bf16", 33, 0),
                                            ("int8", 64, 4)])
def test_k2_unaligned_and_odd_widths(dev, kind, dh, offset):
    """Pools off 16-byte alignment and widths that are not multiples of 4
    take the general path (int8 keeps its 4-code rule)."""
    _k2_check(*_k2_case(dev, _KINDS[kind],
                        (3, 2, 2, dh, dh, 16, [40, 0, 17]), 3, offset))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_k2_split_combine_bitwise_repeatable(dev, kind):
    q, clean, table, lens, sc = _k2_case(dev, _KINDS[kind],
                                         K2_SHAPES["long"], 5)
    splits, _ = PA.gqa_decode_splits(4, 4, 1, table.shape[1],
                                     torch.cuda.get_device_properties(
                                         dev).multi_processor_count)
    assert splits > 1
    a = ops.gqa_paged_attention(q, clean[0], clean[1], table, lens,
                                *clean[2:], sm_scale=sc)
    b = ops.gqa_paged_attention(q, clean[0], clean[1], table, lens,
                                *clean[2:], sm_scale=sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the dense decoders' (Hkv, grp) at Dh 128: llama3.2-3b (8, 3), qwen2-vl-7b
# (4, 7), starcoder2-15b (4, 12), chatglm3-6b (2, 16), mistral-large-123b
# (8, 12); path 1's decode lengths and prefill chunks
DENSE_GROUPS = [(8, 3), (4, 7), (4, 12), (2, 16), (8, 12)]


@pytest.mark.parametrize("kind", list(_KINDS))
@pytest.mark.parametrize("hkv,grp", DENSE_GROUPS)
def test_k2_dense_groups_match_plain(dev, hkv, grp, kind):
    _k2_check(*_k2_case(dev, _KINDS[kind], (4, hkv, grp, 128, 128, 16,
                                            [216, 150, 90, 33]), grp))


@pytest.mark.parametrize("kind", list(_KINDS))
def test_k2_dh112_matches_plain(dev, kind):
    """zamba2-7b's shared attention: 32 heads of 112, grp 1."""
    _k2_check(*_k2_case(dev, _KINDS[kind], (4, 32, 1, 112, 112, 16,
                                            [216, 150, 90, 33]), 112))


# (b, t, hkv, grp, dh, dv, ps, prefix, chunk)
K3_SHAPES = {
    "path1": (2, 256, 32, 1, 128, 128, 16, [0, 0], [256, 200]),
    "path2": (1, 128, 32, 1, 128, 128, 16, [128], [128]),
    "path3": (2, 128, 8, 2, 64, 64, 16, [0, 0], [128, 77]),
    "ps8": (3, 70, 4, 2, 64, 64, 8, [100, 13, 0], [70, 41, 65]),
    "ps32": (3, 33, 4, 3, 128, 128, 32, [45, 0, 64], [33, 20, 1]),
    "ps48_dv192": (2, 40, 2, 1, 128, 192, 48, [100, 3], [40, 11]),
    "grp12": (2, 17, 2, 12, 64, 64, 16, [20, 0], [17, 5]),
    "narrow": (2, 21, 2, 2, 36, 20, 16, [30, 0], [21, 9]),
    "wide": (1, 24, 2, 1, 512, 512, 16, [40], [24]),
}
K3_KINDS = {"f32": ("f32", "f32"), "bf16": ("bf16", "bf16"),
            "int8_f32": ("int8", "f32"), "int8_bf16": ("int8", "bf16")}


def _k3_case(dev, kind, sdt, shape, seed=0, offset=0):
    b, t, hkv, grp, dh, dv, ps, prefix, chunk = shape
    rows = [p + c for p, c in zip(prefix, chunk)]
    width = max(-(-max(rows) // ps), 1)
    table, n_pages = _table_for(dev, rows, ps, width, seed)
    clean = _pools_general(dev, kind, n_pages, ps, hkv, dh, dv, seed, offset)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    q = torch.randn(b, t, hkv, grp, dh, generator=gen, device=dev)
    k_suf = torch.randn(b, t, hkv, dh, generator=gen, device=dev).to(sdt)
    v_suf = torch.randn(b, t, hkv, dv, generator=gen, device=dev).to(sdt)
    pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
    cl = torch.tensor(chunk, dtype=torch.int32, device=dev)
    return q, k_suf, v_suf, clean, table, pl, cl, dh ** -0.5


def _k3_check(q, k_suf, v_suf, clean, table, pl, cl, sc):
    ref = PA.gqa_paged_prefill_plain(q, k_suf, v_suf, clean[0], clean[1],
                                     table, pl, cl, *clean[2:], sm_scale=sc)
    bad = _poisoned(clean)
    out = ops.gqa_paged_prefill(q, k_suf, v_suf, bad[0], bad[1], table, pl,
                                cl, *bad[2:], sm_scale=sc)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert _rel_err(out, ref) <= 1e-5
    return out


@pytest.mark.parametrize("kind", list(K3_KINDS))
@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_k3_shapes_match_plain(dev, shape, kind):
    pool, suf = K3_KINDS[kind]
    _k3_check(*_k3_case(dev, _KINDS[pool], _KINDS[suf], K3_SHAPES[shape]))


@pytest.mark.parametrize("kind", list(K3_KINDS))
@pytest.mark.parametrize("hkv,grp", DENSE_GROUPS)
def test_k3_dense_groups_match_plain(dev, hkv, grp, kind):
    pool, suf = K3_KINDS[kind]
    _k3_check(*_k3_case(dev, _KINDS[pool], _KINDS[suf],
                        (2, 256, hkv, grp, 128, 128, 16, [0, 0], [256, 200]),
                        grp))
    _k3_check(*_k3_case(dev, _KINDS[pool], _KINDS[suf],
                        (2, 128, hkv, grp, 128, 128, 16, [128, 37],
                         [128, 90]), grp + 1))


@pytest.mark.parametrize("kind", list(K3_KINDS))
def test_k3_dh112_matches_plain(dev, kind):
    """zamba2-7b's shared attention (Dh 112, grp 1): a fresh chunk and one
    behind ragged prefixes."""
    pool, suf = K3_KINDS[kind]
    for shape in ((2, 256, 32, 1, 112, 112, 16, [0, 0], [256, 200]),
                  (2, 128, 32, 1, 112, 112, 16, [128, 37], [128, 90])):
        _k3_check(*_k3_case(dev, _KINDS[pool], _KINDS[suf], shape, 112))


@pytest.mark.parametrize("kind", list(K3_KINDS))
def test_k3_long_prefix_peaked_scores(dev, kind):
    """A 2048-token prefix and a 128-token chunk with peaked scores (q
    scaled by 4): K3 sums P V in fresh 32-key accumulators, and holds the
    1e-5 tolerance where one 3xTF32 accumulator carried over the whole key
    range drifts past it (``tests/test_torch_paged_tc.py`` models both; one
    accumulator of bf16 terms drifts past it behind longer prefixes,
    ``launch/k3_shares.py``)."""
    pool, suf = K3_KINDS[kind]
    q, *rest = _k3_case(dev, _KINDS[pool], _KINDS[suf],
                        (1, 128, 4, 2, 128, 128, 16, [2048], [128]), 5)
    _k3_check(4 * q, *rest)


@pytest.mark.parametrize("kind,dh,offset", [("f32", 128, 1), ("bf16", 64, 1),
                                            ("f32", 33, 0), ("bf16", 33, 0),
                                            ("int8", 64, 4)])
def test_k3_unaligned_and_odd_widths(dev, kind, dh, offset):
    """Pools off 16-byte alignment take 4-byte (bf16 at an odd element:
    2-byte) copies; odd widths are padded."""
    suf = torch.float32 if kind == "int8" else _KINDS[kind]
    _k3_check(*_k3_case(dev, _KINDS[kind], suf,
                        (2, 37, 2, 2, dh, dh, 16, [50, 0], [37, 20]), 4,
                        offset))


def _captured(fn):
    """``fn()`` captured in a CUDA graph (after a warm-up on a side
    stream): (graph, its output tensor)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_k2_k3_replay_after_in_place_updates(dev, kind):
    """K2 and K3 in a CUDA graph (as a captured decode step would hold
    them): lengths, table and prefix_len updated in place, the replay
    equals the eager call on the updated tensors, bit for bit."""
    dt = _KINDS[kind]
    q, clean, table, lens, sc = _k2_case(dev, dt, K2_SHAPES["path1"], 11)
    table2 = table.flip(0).contiguous()            # other slots' pages
    lens2 = lens.flip(0).contiguous() - 5
    graph, out = _captured(lambda: ops.gqa_paged_attention(
        q, clean[0], clean[1], table, lens, *clean[2:], sm_scale=sc))
    table.copy_(table2)
    lens.copy_(lens2)
    graph.replay()
    torch.cuda.synchronize()
    eager = _k2_check(q, clean, table, lens, sc)
    assert torch.equal(out, eager)

    suf = torch.float32 if kind == "int8" else dt
    q, k_suf, v_suf, clean, table, pl, cl, sc = _k3_case(
        dev, dt, suf, (2, 70, 4, 2, 64, 64, 16, [100, 13], [70, 41]), 12)
    graph, out = _captured(lambda: ops.gqa_paged_prefill(
        q, k_suf, v_suf, clean[0], clean[1], table, pl, cl, *clean[2:],
        sm_scale=sc))
    table.copy_(table.flip(0))
    pl.copy_(torch.tensor([3, 90], dtype=torch.int32, device=dev))
    cl.copy_(torch.tensor([41, 70], dtype=torch.int32, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    eager = _k3_check(q, k_suf, v_suf, clean, table, pl, cl, sc)
    assert torch.equal(out, eager)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("xdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("e,c,ci,co,g", [(3, 21, 96, 48, 48),
                                         (32, 8, 1024, 512, 128),
                                         (32, 40, 512, 1024, 128),
                                         (4, 17, 256, 200, 32),
                                         (4, 33, 512, 256, 256)])
def test_grouped_kernels_match_plain(dev, e, c, ci, co, g, xdt, sdt, a8):
    """B6 (a8=False) and B7 with ragged zero capacity rows, which must come
    out exactly zero; B7 with a group whose zero fold needs the clip."""
    gen = torch.Generator(device=dev).manual_seed(e + c + co)
    w = torch.randn(e, ci, co, generator=gen, device=dev) * ci ** -0.5
    qt = quantize(w, group_size=g, dtype=sdt)
    if a8:
        zeros = qt.zeros.clone()
        zeros[0, 0, :4] = torch.tensor([140.0, 130.0, -150.0, -114.0])
        qt = dataclasses.replace(qt, zeros=zeros)
    x = torch.randn(e, c, ci, generator=gen, device=dev)
    filled = torch.randint(0, c + 1, (e,), generator=gen, device=dev)
    x = torch.where(torch.arange(c, device=dev)[None, :, None]
                    < filled[:, None, None], x, 0.0).to(xdt)
    kern = W4G.w4a8_grouped_cuda if a8 else W4G.w4a16_grouped_cuda
    plain = W4G.w4a8_grouped_plain if a8 else W4G.w4a16_grouped_plain
    before = kern.launches
    y = kern(x, qt)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert y.dtype == xdt and tuple(y.shape) == (e, c, co)
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(y, plain(x, qt)) <= tol
    for i, n in enumerate(filled.tolist()):
        assert not y[i, n:].any()


def _a16_case(dev, kind, t, ci, co, g, xdt, seed, e=3):
    """A K1 (``kind="k1"``: x[t, ci]) or B6 (x[e, t, ci]) case: operands,
    the wrapper, its plain version."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = () if kind == "k1" else (e,)
    w = torch.randn(*lead, ci, co, generator=gen, device=dev) * ci ** -0.5
    qt = quantize(w, group_size=g, dtype=xdt)
    x = torch.randn(*lead, t, ci, generator=gen, device=dev).to(xdt)
    if kind == "k1":
        return x, qt, W4.w4a16_matmul_cuda, W4.w4a16_matmul_plain
    return x, qt, W4G.w4a16_grouped_cuda, W4G.w4a16_grouped_plain


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("co", [200, 256])
@pytest.mark.parametrize("t", [1, 7, 9, 17, 65, 129])
@pytest.mark.parametrize("kind", ["k1", "b6"])
def test_a16_tile_row_counts(dev, kind, t, co, xdt):
    """Ragged row counts across the 8- and 64-row tiles; Co = 200 (not a
    multiple of 16: 4-byte copies; the 128-column prefill tile) and 256
    (the 256-column prefill tile)."""
    x, qt, kern, plain = _a16_case(dev, kind, t, 256, co, 32, xdt, t)
    y = kern(x, qt)
    torch.cuda.synchronize()
    assert y.dtype == xdt and y.shape == plain(x, qt).shape
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(y, plain(x, qt)) <= tol


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,t,ci,co,g", [("k1", 4, 128, 512, 128),
                                            ("k1", 129, 128, 96, 128),
                                            ("b6", 6, 128, 512, 128),
                                            ("b6", 65, 128, 512, 128),
                                            ("b6", 129, 48, 112, 48)])
def test_a16_tile_one_group(dev, kind, t, ci, co, g, xdt):
    """Ci = G: a single quantization group (no split-K possible)."""
    x, qt, kern, plain = _a16_case(dev, kind, t, ci, co, g, xdt, ci + t)
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(kern(x, qt), plain(x, qt)) <= tol


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,t", [("k1", 4), ("k1", 100), ("b6", 8),
                                    ("b6", 40)])
def test_a16_tile_offset_only_group(dev, kind, t, xdt):
    """Group 0 with zero point -15000 (past bf16's exact integers): the tile
    keeps the zero in f32 and never rounds (code - zero) to 16 bits."""
    x, qt, kern, plain = _a16_case(dev, kind, t, 512, 256, 128, xdt, 5 + t)
    zeros = qt.zeros.clone()
    zeros[..., 0, :] = -15000.0
    qt = dataclasses.replace(qt, zeros=zeros)
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(kern(x, qt), plain(x, qt)) <= tol


@pytest.mark.parametrize("kind,t,ci,co", [("k1", 4, 4096, 4096),
                                          ("k1", 64, 4096, 1024),
                                          ("b6", 8, 1024, 512)])
def test_a16_tile_split_k_bitwise_repeatable(dev, kind, t, ci, co):
    """Shapes that split the groups over blocks: the partials are summed in
    a fixed order, so two calls agree bit for bit."""
    x, qt, kern, plain = _a16_case(dev, kind, t, ci, co, 128, torch.float32,
                                   7, e=32)
    rows = x.shape[-2]
    assert W4._plan("k", x, qt, rows, x.numel() // (rows * ci))[1] > 1
    y1, y2 = kern(x, qt), kern(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert _rel_err(y1, plain(x, qt)) <= 1e-5


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,ci,co", [(16, 6, 256, 192), (8, 70, 128, 96)])
def test_b6_rows_skip_idle_experts(dev, e, c, ci, co, xdt):
    """``rows``: idle experts (rows 0) have NaN scales and come out exactly
    zero, so their weights were never read; rows past rows[e] of a live
    expert come out zero even where x is not zero there."""
    x, qt, kern, plain = _a16_case(dev, "b6", c, ci, co, 32, xdt, e + c, e=e)
    rows = torch.tensor([0, c, 1, 0, c // 2, 3] + [0, c] * ((e - 6) // 2),
                        dtype=torch.int32, device=dev)
    idle = rows == 0
    scales = qt.scales.clone()
    scales[idle] = float("nan")
    qt = dataclasses.replace(qt, scales=scales)
    before = kern.launches
    y = kern(x, qt, rows)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    for i, n in enumerate(rows.tolist()):
        assert not y[i, n:].any()
    assert bool(torch.isfinite(y).all())
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(y, plain(x, qt, rows)) <= tol
    y_ops = ops.w4a16_grouped_matmul(x, qt, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(y_ops, y)


@pytest.mark.parametrize("xdt,sdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("kind,t,ci,co,g", [("b5", 64, 4096, 4096, 128),
                                            ("b5", 64, 4096, 1024, 256),
                                            ("b7", 40, 1024, 512, 128)])
def test_a8_tile_split_k_bitwise_repeatable(dev, kind, t, ci, co, g, xdt,
                                            sdt):
    """B5/B7 at shapes whose tiles leave the SMs idle (a T = 64 chunk of
    codellama's 4096x4096, a small grouped call): the groups are split over
    blocks, the partials summed in split order and then scaled by xs, so
    two calls agree bit for bit and match the plain version."""
    gen = torch.Generator(device=dev).manual_seed(t + ci + g)
    lead = () if kind == "b5" else (2,)
    w = torch.randn(*lead, ci, co, generator=gen, device=dev) * ci ** -0.5
    qt = quantize(w, group_size=g, dtype=sdt)
    x = torch.randn(*lead, t, ci, generator=gen, device=dev).to(xdt)
    experts = lead[0] if lead else 1
    assert W4._plan("k", x, qt, t, experts, a8=True)[1] > 1
    kern, plain = ((W4.w4a8_matmul_cuda, W4.w4a8_matmul_plain)
                   if kind == "b5" else
                   (W4G.w4a8_grouped_cuda, W4G.w4a8_grouped_plain))
    y1, y2 = kern(x, qt), kern(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(y1, plain(x, qt)) <= tol


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,ci,co,g", [(16, 70, 256, 192, 32),
                                         (8, 40, 512, 256, 256)])
def test_b7_rows_skip_idle_experts(dev, e, c, ci, co, g, xdt):
    """B7 with ``rows``: idle experts (rows 0) have NaN scales and come out
    exactly zero, so their weights were never read; rows past rows[e] of a
    live expert come out exactly zero even where x is not zero there; a
    clip group in expert 1."""
    gen = torch.Generator(device=dev).manual_seed(e + c + g)
    w = torch.randn(e, ci, co, generator=gen, device=dev) * ci ** -0.5
    qt = quantize(w, group_size=g, dtype=xdt)
    zeros = qt.zeros.clone()
    zeros[1, 0, :4] = torch.tensor([140.0, 130.0, -150.0, -114.0])
    x = torch.randn(e, c, ci, generator=gen, device=dev).to(xdt)
    rows = torch.tensor([0, c, 1, 0, c // 2, 3, 17, 0] + [c, 0] * ((e - 8) // 2),
                        dtype=torch.int32, device=dev)
    scales = qt.scales.clone()
    scales[rows == 0] = float("nan")
    qt = dataclasses.replace(qt, scales=scales, zeros=zeros)
    before = W4G.w4a8_grouped_cuda.launches
    y = W4G.w4a8_grouped_cuda(x, qt, rows)
    torch.cuda.synchronize()
    assert W4G.w4a8_grouped_cuda.launches == before + 1
    for i, n in enumerate(rows.tolist()):
        assert not y[i, n:].any()
    assert bool(torch.isfinite(y).all())
    tol = 1e-5 if xdt == torch.float32 else 1e-2
    assert _rel_err(y, W4G.w4a8_grouped_plain(x, qt, rows)) <= tol
    y_ops = ops.w4a16_grouped_matmul(x, qt, act="a8", rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(y_ops, y)


def test_grouped_gate_on_the_card(dev):
    w = torch.randn(4, 256, 64, device=dev) * 256 ** -0.5
    qt = quantize(w, group_size=32)
    x = torch.randn(4, 16, 256, device=dev)
    K.reset_launch_counts()
    ops.w4a16_grouped_matmul(x[:, :15].contiguous(), qt, act="a8")
    ops.w4a16_grouped_matmul(x, dataclasses.replace(qt, a8=False), act="a8")
    ops.w4a16_grouped_matmul(x, qt, act="a8")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["w4a16_grouped"], counts["w4a8_grouped"]) == (2, 1)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,causal", [
    (2, 37, 4, 2, 16, True), (1, 64, 16, 8, 64, True),
    (1, 300, 32, 32, 128, True), (2, 129, 6, 2, 32, True),
    (1, 1, 4, 1, 64, True), (1, 128, 16, 8, 64, False),
    (1, 1024, 8, 4, 64, False)])
def test_flash_kernel_matches_plain(dev, dt, b, t, h, hkv, d, causal):
    gen = torch.Generator(device=dev).manual_seed(t + h)
    q = torch.randn(b, t, h, d, generator=gen, device=dev).to(dt)
    k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dt)
    v = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dt)
    before = FA.flash_attention_cuda.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention_cuda.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert _rel_err(out, FA.flash_attention_plain(q, k, v, causal=causal)) \
        <= tol


def _flash_case(dev, dt, shape, seed):
    b, t, s, h, hkv, d, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, n, hh, d, generator=gen, device=dev).to(dt)
            for n, hh in ((t, h), (s, hkv), (s, hkv))]


def _flash_check(q, k, v, causal):
    before = FA.flash_attention_cuda.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention_cuda.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = 1e-5 if q.dtype == torch.float32 else 1e-2
    assert _rel_err(out, FA.flash_attention_plain(q, k, v, causal=causal)) \
        <= tol
    return out


# (B, T, S, H, Hkv, D, causal): head widths 8 / 80 / 256 (padded to 16;
# 256 in two value slices), causal S > T, non-causal T = 128 against S =
# 1024, T*grp not a multiple of 64 (grp 3, 111 rows), grp 1 / 2 / 4 / 8
FLASH_TC_SHAPES = {
    "D=8": (2, 70, 70, 8, 2, 8, True),
    "D=80": (1, 100, 100, 8, 4, 80, True),
    "D=256": (1, 150, 150, 4, 2, 256, True),
    "S>T": (2, 45, 100, 6, 2, 64, True),
    "non-causal": (1, 128, 1024, 16, 8, 64, False),
    "ragged": (1, 37, 37, 24, 8, 48, True),
    "grp=1": (1, 200, 200, 8, 8, 64, True),
    "grp=2": (1, 200, 200, 16, 8, 64, True),
    "grp=4": (2, 99, 99, 16, 4, 32, True),
    "grp=8": (1, 77, 77, 64, 8, 128, True),
}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(FLASH_TC_SHAPES))
def test_flash_tc_shapes_match_plain(dev, shape, dt):
    sh = FLASH_TC_SHAPES[shape]
    assert FA.flash_route(dt, sh[5]) == "tile"
    _flash_check(*_flash_case(dev, dt, sh, sum(sh[:6])), causal=sh[6])


def test_flash_routes_by_shape(dev):
    """Every width up to one ring stage's fit takes the tensor-core tile
    (f32 D <= 384, bf16 D <= 832, exactly a block's shared memory at the
    edge); wider rows the CUDA-core kernel; rows past its shared memory
    are refused."""
    for dt, edge in ((torch.float32, 384), (torch.bfloat16, 832)):
        for d in (8, 16, 48, 64, 80, 128, 256, edge):
            assert FA.flash_route(dt, d) == "tile"
        assert FA.flash_route(dt, edge + 16) == "general"
        with pytest.raises(ValueError, match="too wide"):
            FA.flash_route(dt, 30000)


@pytest.mark.parametrize("dt,d,causal,s", [
    (torch.float32, 512, True, 20), (torch.float32, 400, True, 50),
    (torch.bfloat16, 1024, False, 20), (torch.bfloat16, 850, True, 20)])
def test_flash_general_route_matches_plain(dev, dt, d, causal, s):
    sh = (2, 20, s, 4, 2, d, causal)
    assert FA.flash_route(dt, d) == "general"
    _flash_check(*_flash_case(dev, dt, sh, d), causal=causal)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_bitwise_repeatable(dev, dt):
    """Two calls give the same bits (no atomics, a fixed order)."""
    q, k, v = _flash_case(dev, dt, FLASH_TC_SHAPES["grp=2"], 3)
    a, b = (ops.flash_attention(q, k, v) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_replay_after_in_place_updates(dev, dt):
    """B4 in a CUDA graph: q, k, v overwritten in place, the replay equals
    the eager call on the new values, bit for bit."""
    q, k, v = _flash_case(dev, dt, FLASH_TC_SHAPES["S>T"], 4)
    graph, out = _captured(lambda: ops.flash_attention(q, k, v))
    for a, new in zip((q, k, v),
                      _flash_case(dev, dt, FLASH_TC_SHAPES["S>T"], 5)):
        a.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _flash_check(q, k, v, causal=True))


# (heads, r, dr, page size): full width, smoke width
MLA_WIDTHS = [(128, 512, 64, 16), (4, 16, 8, 8)]


def _mla_paged(dev, kind, b, lengths, r, dr, ps=16, pages=6, seed=0):
    """Latent pools of ``kind`` (f32, bf16, or int8 codes with f32 row
    scales) for ``lengths``: the plain version's clean copy, the kernel's
    copy with the trash page 0 poisoned (NaN; int8: codes -128 and NaN
    scales), and the table (shuffled live pages, dead entries 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * pages
    if kind == torch.int8:
        clean = [torch.randint(-127, 128, (n_pages, ps, d), generator=gen,
                               device=dev, dtype=torch.int8)
                 for d in (r, dr)]
        clean += [torch.rand(n_pages, ps, generator=gen, device=dev) * 0.03
                  + 1e-3 for _ in range(2)]
    else:
        clean = [torch.randn(n_pages, ps, d, generator=gen, device=dev).to(
            kind) for d in (r, dr)] + [None, None]
    bad = [None if t is None else t.clone() for t in clean]
    for t in bad:
        if t is not None:
            t[0] = -128 if t.dtype == torch.int8 else float("nan")
    table = torch.zeros(b, pages, dtype=torch.int32)
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    k = 0
    for i, n in enumerate(lengths):
        live = -(-int(n) // ps)
        table[i, :live] = torch.from_numpy(perm[k:k + live].astype(np.int32))
        k += live
    return clean, bad, table.to(dev)


@pytest.mark.parametrize("kind", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("h,r,dr,ps", MLA_WIDTHS)
def test_mla_decode_kernel_matches_plain(dev, kind, h, r, dr, ps):
    lengths = [1, 17, 96, 0, 40]                  # 0: an empty slot
    b = len(lengths)
    clean, bad, table = _mla_paged(dev, kind, b, lengths, r, dr, ps=ps,
                                   pages=96 // ps, seed=h + r)
    gen = torch.Generator(device=dev).manual_seed(3)
    q_lat = torch.randn(b, h, r, generator=gen, device=dev)
    q_pe = torch.randn(b, h, dr, generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sc = (128 + 64) ** -0.5
    quant = kind == torch.int8
    counter = (PA.mla_paged_attention_int8_cuda if quant
               else PA.mla_paged_attention_cuda)
    before = counter.launches
    out = ops.mla_paged_attention(q_lat, q_pe, bad[0], bad[1], table, lens,
                                  bad[2], bad[3], sm_scale=sc)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, h, r)
    assert bool(torch.isfinite(out).all())        # the trash page never read
    ref = PA.mla_paged_attention_plain(q_lat, q_pe, clean[0], clean[1],
                                       table, lens, clean[2], clean[3],
                                       sm_scale=sc)
    assert _rel_err(out, ref) <= 1e-5
    assert not out[3].any()


@pytest.mark.parametrize("kind,sdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.int8, torch.float32),
                                      (torch.int8, torch.bfloat16)])
@pytest.mark.parametrize("h,r,dr,ps", MLA_WIDTHS)
@pytest.mark.parametrize("t", [8, 33])
def test_mla_prefill_kernel_matches_plain(dev, kind, sdt, h, r, dr, ps, t):
    prefix = [0, 5, 32, 19, 0]
    chunk = [t, t - 3, t // 2, 1, 0]              # padding rows; an empty row
    b = len(prefix)
    clean, bad, table = _mla_paged(
        dev, kind, b, [p + c for p, c in zip(prefix, chunk)], r, dr, ps=ps,
        pages=96 // ps, seed=t + h)
    gen = torch.Generator(device=dev).manual_seed(t)
    q_lat = torch.randn(b, t, h, r, generator=gen, device=dev)
    q_pe = torch.randn(b, t, h, dr, generator=gen, device=dev)
    c_suf = torch.randn(b, t, r, generator=gen, device=dev).to(sdt)
    k_suf = torch.randn(b, t, dr, generator=gen, device=dev).to(sdt)
    pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
    cl = torch.tensor(chunk, dtype=torch.int32, device=dev)
    sc = (128 + 64) ** -0.5
    quant = kind == torch.int8
    counter = (PA.mla_paged_prefill_int8_cuda if quant
               else PA.mla_paged_prefill_cuda)
    before = counter.launches
    out = ops.mla_paged_prefill(q_lat, q_pe, c_suf, k_suf, bad[0], bad[1],
                                table, pl, cl, bad[2], bad[3], sm_scale=sc)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert tuple(out.shape) == (b, t, h, r)
    assert bool(torch.isfinite(out).all())
    ref = PA.mla_paged_prefill_plain(q_lat, q_pe, c_suf, k_suf, clean[0],
                                     clean[1], table, pl, cl, clean[2],
                                     clean[3], sm_scale=sc)
    assert _rel_err(out, ref) <= 1e-5
    assert not out[4].any()                       # no prefix, no chunk


# B8/B9 on the tensor-core tile (csrc/mla_tile.cuh) at every shape class:
# path 4's decode lengths and chunks, slots that need several splits, empty
# slots, lengths off page multiples, PS 8, heads not a multiple of 64, odd
# fp widths (zero-padded, copied in 4- or 2-byte pieces), and r > 512,
# where one tile stage does not fit and the CUDA-core path runs.
_MLA_KINDS = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "int8_f32": (torch.int8, torch.float32),
              "int8_bf16": (torch.int8, torch.bfloat16)}
# (heads, r, dr, page size, lengths)
MLA_DECODE_SHAPES = {
    "path4": (128, 512, 64, 16, [216, 150, 90, 33]),
    "long": (128, 512, 64, 16, [1000, 0, 517, 31]),
    "ps8": (4, 16, 8, 8, [77, 1, 0]),
    "h200": (200, 64, 32, 16, [50, 7]),
    "odd": (3, 33, 6, 16, [40, 17]),
    "wide": (4, 640, 64, 16, [40, 0, 17]),
}
# (heads, r, dr, page size, T, prefix, chunk)
MLA_PREFILL_SHAPES = {
    "path4": (128, 512, 64, 16, 128, [128], [128]),
    "ragged": (128, 512, 64, 16, 32, [96, 50, 0, 0], [32, 29, 16, 1]),
    "ps8": (4, 16, 8, 8, 40, [45, 0, 13], [40, 33, 1]),
    "h200": (200, 64, 32, 16, 9, [20, 0], [9, 5]),
    "odd": (3, 33, 6, 16, 21, [30, 0], [21, 9]),
    "wide": (4, 640, 64, 16, 24, [40], [24]),
}


def _mla_decode_case(dev, kind, shape, seed=0):
    h, r, dr, ps, lengths = shape
    b = len(lengths)
    clean, bad, table = _mla_paged(dev, kind, b, lengths, r, dr, ps=ps,
                                   pages=max(-(-max(lengths) // ps), 1),
                                   seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    q_lat = torch.randn(b, h, r, generator=gen, device=dev)
    q_pe = torch.randn(b, h, dr, generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q_lat, q_pe, clean, bad, table, lens, (128 + 64) ** -0.5


def _mla_decode_check(q_lat, q_pe, clean, bad, table, lens, sc):
    out = ops.mla_paged_attention(q_lat, q_pe, bad[0], bad[1], table, lens,
                                  bad[2], bad[3], sm_scale=sc)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())        # the trash page never read
    ref = PA.mla_paged_attention_plain(q_lat, q_pe, clean[0], clean[1],
                                       table, lens, clean[2], clean[3],
                                       sm_scale=sc)
    assert _rel_err(out, ref) <= 1e-5
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            assert not out[i].any()
    return out


def _mla_cases(shapes, kinds):
    """(shape, kind) pairs; int8 rows are read 4 codes at a time, so the
    odd widths run fp pools only."""
    return [(s, k) for s in shapes for k in kinds
            if not (s == "odd" and k.startswith("int8"))]


@pytest.mark.parametrize("shape,kind", _mla_cases(
    MLA_DECODE_SHAPES, ["f32", "bf16", "int8_f32"]))
def test_mla_decode_shapes_match_plain(dev, shape, kind):
    case = _mla_decode_case(dev, _MLA_KINDS[kind][0],
                            MLA_DECODE_SHAPES[shape])
    h, _, _, _, lengths = MLA_DECODE_SHAPES[shape]
    if shape in ("long", "path4"):            # several splits per slot
        splits, pps = PA.mla_decode_splits(
            len(lengths), h, case[4].shape[1], MLA_DECODE_SHAPES[shape][3],
            torch.cuda.get_device_properties(dev).multi_processor_count)
        assert splits > 1 and (shape == "path4" or pps > 1)
    _mla_decode_check(*case)


@pytest.mark.parametrize("shape,kind", _mla_cases(MLA_PREFILL_SHAPES,
                                                 _MLA_KINDS))
def test_mla_prefill_shapes_match_plain(dev, shape, kind):
    _mla_prefill_check(*_mla_prefill_case(dev, *_MLA_KINDS[kind],
                                          MLA_PREFILL_SHAPES[shape]))


def _mla_prefill_case(dev, kind, sdt, shape, seed=0):
    h, r, dr, ps, t, prefix, chunk = shape
    b = len(prefix)
    rows = [p + c for p, c in zip(prefix, chunk)]
    clean, bad, table = _mla_paged(dev, kind, b, rows, r, dr, ps=ps,
                                   pages=max(-(-max(rows) // ps), 1),
                                   seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    q_lat = torch.randn(b, t, h, r, generator=gen, device=dev)
    q_pe = torch.randn(b, t, h, dr, generator=gen, device=dev)
    c_suf = torch.randn(b, t, r, generator=gen, device=dev).to(sdt)
    k_suf = torch.randn(b, t, dr, generator=gen, device=dev).to(sdt)
    pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
    cl = torch.tensor(chunk, dtype=torch.int32, device=dev)
    return (q_lat, q_pe, c_suf, k_suf, clean, bad, table, pl, cl,
            (128 + 64) ** -0.5)


def _mla_prefill_check(q_lat, q_pe, c_suf, k_suf, clean, bad, table, pl, cl,
                       sc):
    out = ops.mla_paged_prefill(q_lat, q_pe, c_suf, k_suf, bad[0], bad[1],
                                table, pl, cl, bad[2], bad[3], sm_scale=sc)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    ref = PA.mla_paged_prefill_plain(q_lat, q_pe, c_suf, k_suf, clean[0],
                                     clean[1], table, pl, cl, clean[2],
                                     clean[3], sm_scale=sc)
    assert _rel_err(out, ref) <= 1e-5
    return out


# C.3: long key ranges with peaked scores (q scaled by 4), the cases of
# launch/mla_shares.py: f32 pools, bf16 pools and suffix, int8 pools with
# an f32 suffix, their codes uniform or written as the engine writes them
MLA_LONG_KINDS = {"f32": (torch.float32, torch.float32, False),
                  "bf16": (torch.bfloat16, torch.bfloat16, False),
                  "int8": (torch.int8, torch.float32, False),
                  "int8_rows": (torch.int8, torch.float32, True)}


@pytest.mark.parametrize("pfx", [2048, 8192])
@pytest.mark.parametrize("kind", list(MLA_LONG_KINDS))
def test_b9_long_prefix_peaked_scores(dev, kind, pfx):
    """A 128-token chunk of 128 heads behind a 2048- or 8192-token prefix:
    the tile sums each 32-key tile's P V in a fresh accumulator and holds
    the 1e-5 tolerance where one accumulator carried over the whole key
    range drifts past it (``tests/test_torch_mla_tc.py`` models both)."""
    from repro_torch.launch import mla_shares as MS

    pool, suf, rows = MLA_LONG_KINDS[kind]
    before = PA.mla_paged_prefill_cuda.launches \
        + PA.mla_paged_prefill_int8_cuda.launches
    assert MS.b9_share(pfx, 5, pool, suf, rows, dev)[1] <= 1.0
    assert PA.mla_paged_prefill_cuda.launches \
        + PA.mla_paged_prefill_int8_cuda.launches == before + 1


@pytest.mark.parametrize("kind", list(MLA_LONG_KINDS))
def test_b8_long_split_peaked_scores(dev, kind):
    """One slot of 128 heads at 65,536 positions: 32 splits of 2048 keys,
    each summed in fresh per-tile accumulators, within the tolerance."""
    from repro_torch.launch import mla_shares as MS

    pool, _, rows = MLA_LONG_KINDS[kind]
    splits, pps = PA.mla_decode_splits(1, 128, 65536 // 16, 16,
                                       K._build.sm_count(dev))
    assert splits * pps * 16 == 65536 and pps * 16 >= 2048
    assert MS.b8_share(65536, 3, pool, rows, dev)[1] <= 1.0


def test_mla_routes_by_shape(dev):
    """Path 4's widths (and the smoke widths) take the tensor-core tile in
    every instance; r > 512 takes the CUDA-core path."""
    for pool, suf in _MLA_KINDS.values():
        for r, dr in ((512, 64), (16, 8), (33, 6)):
            if pool == torch.int8 and r % 4:
                continue
            assert PA.mla_decode_route(pool, r, dr) == "tile"
            assert PA.mla_prefill_route(suf, pool, r, dr) == "tile"
        assert PA.mla_decode_route(pool, 640, 64) == "general"
        assert PA.mla_prefill_route(suf, pool, 640, 64) == "general"


@pytest.mark.parametrize("kind", ["f32", "int8_f32"])
def test_mla_bitwise_repeatable(dev, kind):
    """Two calls give the same bits: B8's split-order combine and B9's
    tiles take no atomics."""
    pool, suf = _MLA_KINDS[kind]
    q_lat, q_pe, clean, bad, table, lens, sc = _mla_decode_case(
        dev, pool, MLA_DECODE_SHAPES["long"], 5)
    a, b = (ops.mla_paged_attention(q_lat, q_pe, clean[0], clean[1], table,
                                    lens, clean[2], clean[3], sm_scale=sc)
            for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    args = _mla_prefill_case(dev, pool, suf, MLA_PREFILL_SHAPES["ragged"], 6)
    q_lat, q_pe, c_suf, k_suf, clean, _, table, pl, cl, sc = args
    a, b = (ops.mla_paged_prefill(q_lat, q_pe, c_suf, k_suf, clean[0],
                                  clean[1], table, pl, cl, clean[2],
                                  clean[3], sm_scale=sc) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["f32", "int8_f32"])
def test_mla_replay_after_in_place_updates(dev, kind):
    """B8 and B9 in a CUDA graph (as a captured decode step would hold
    them): lengths, table, prefix and chunk lengths updated in place, the
    replay equals the eager call on the updated tensors, bit for bit."""
    pool, suf = _MLA_KINDS[kind]
    q_lat, q_pe, clean, bad, table, lens, sc = _mla_decode_case(
        dev, pool, MLA_DECODE_SHAPES["path4"], 11)
    table2 = table.flip(0).contiguous()            # other slots' pages
    lens2 = lens.flip(0).contiguous() - 5
    graph, out = _captured(lambda: ops.mla_paged_attention(
        q_lat, q_pe, bad[0], bad[1], table, lens, bad[2], bad[3],
        sm_scale=sc))
    table.copy_(table2)
    lens.copy_(lens2)
    graph.replay()
    torch.cuda.synchronize()
    eager = _mla_decode_check(q_lat, q_pe, clean, bad, table, lens, sc)
    assert torch.equal(out, eager)

    args = _mla_prefill_case(dev, pool, suf,
                             (16, 512, 64, 16, 40, [100, 13], [40, 21]), 12)
    q_lat, q_pe, c_suf, k_suf, clean, bad, table, pl, cl, sc = args
    graph, out = _captured(lambda: ops.mla_paged_prefill(
        q_lat, q_pe, c_suf, k_suf, bad[0], bad[1], table, pl, cl, bad[2],
        bad[3], sm_scale=sc))
    table.copy_(table.flip(0))
    pl.copy_(torch.tensor([3, 90], dtype=torch.int32, device=dev))
    cl.copy_(torch.tensor([21, 40], dtype=torch.int32, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    eager = _mla_prefill_check(*args)
    assert torch.equal(out, eager)


def test_launch_counters_reset(dev):
    K.reset_launch_counts()
    assert set(K.launch_counts().values()) == {0}
