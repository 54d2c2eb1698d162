"""Port parity: K2/K3 plain versions (paged GQA decode / chunked prefill) vs
the JAX Pallas kernels in interpret mode, on the same numpy inputs.

Ragged lengths, shuffled page tables whose dead entries point at the trash
page 0 (filled with garbage that must never leak in), grp 1 and 3, cold rows
(prefix 0) and padded rows (chunk_len 0, which give exact zeros with no
prefix).  Tolerance: f32 atol/rtol 2e-5 (softmax sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import gqa_paged_attention as j_decode
from repro.kernels.paged_attention import gqa_paged_prefill as j_prefill
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA

TOL = dict(rtol=2e-5, atol=2e-5)
PS, P, HKV, DH = 8, 4, 2, 16


def _pools(rng, n_pages, dtype=np.float32):
    shp = (n_pages, PS, HKV, DH)
    return (rng.standard_normal(shp).astype(dtype),
            rng.standard_normal(shp).astype(dtype))


def _table(rng, b, live_pages, n_pages):
    """Shuffled distinct pages for each slot's live prefix, trash beyond."""
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, P), np.int32)
    k = 0
    for i, n in enumerate(live_pages):
        table[i, :n] = perm[k:k + n]
        k += n
    return table


@pytest.mark.parametrize("grp", [1, 3])
def test_decode_plain_matches_pallas(grp):
    rng = np.random.default_rng(grp)
    lengths = np.array([1, 9, 16, 29, 0], np.int32)   # 0: empty slot
    b = len(lengths)
    n_pages = 1 + 4 * b
    kp, vp = _pools(rng, n_pages)
    table = _table(rng, b, [-(-n // PS) for n in lengths], n_pages)
    q = rng.standard_normal((b, HKV, grp, DH)).astype(np.float32)
    scale = DH ** -0.5
    ref = j_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(table), jnp.asarray(lengths), sm_scale=scale,
                   interpret=True)
    out = TOPS.gqa_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths), sm_scale=scale)
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, HKV, grp, DH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[-1].any()                # empty slot: exact zeros


@pytest.mark.parametrize("grp", [1, 3])
def test_prefill_plain_matches_pallas(grp):
    rng = np.random.default_rng(10 + grp)
    t = 8
    prefix = np.array([0, 5, 16, 11, 0], np.int32)
    chunk = np.array([8, 3, 8, 0, 0], np.int32)       # row 4: cold and empty
    b = len(prefix)
    n_pages = 1 + 4 * b
    kp, vp = _pools(rng, n_pages)
    table = _table(rng, b, [-(-(p + c) // PS) for p, c in zip(prefix, chunk)],
                   n_pages)
    q = rng.standard_normal((b, t, HKV, grp, DH)).astype(np.float32)
    ks = rng.standard_normal((b, t, HKV, DH)).astype(np.float32)
    vs = rng.standard_normal((b, t, HKV, DH)).astype(np.float32)
    scale = DH ** -0.5
    ref = j_prefill(*map(jnp.asarray, (q, ks, vs, kp, vp, table, prefix,
                                       chunk)), sm_scale=scale,
                    interpret=True)
    out = TOPS.gqa_paged_prefill(
        *map(torch.from_numpy, (q, ks, vs, kp, vp, table, prefix, chunk)),
        sm_scale=scale)
    assert tuple(out.shape) == (b, t, HKV, grp, DH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[4].any()                 # no prefix, no chunk: zeros


def test_plain_versions_ignore_trash_page_contents():
    """Dead table entries point at page 0; its contents must not matter."""
    rng = np.random.default_rng(5)
    lengths = np.array([3, 12], np.int32)
    kp, vp = _pools(rng, 9)
    table = _table(rng, 2, [1, 2], 9)
    q = torch.from_numpy(rng.standard_normal((2, HKV, 1, DH)).astype(
        np.float32))
    args = lambda k, v: (q, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(table), torch.from_numpy(lengths))
    a = TPA.gqa_paged_attention_plain(*args(kp, vp), sm_scale=0.25)
    kp[0], vp[0] = 1e6, -1e6
    b = TPA.gqa_paged_attention_plain(*args(kp, vp), sm_scale=0.25)
    assert torch.equal(a, b)


def test_cuda_wrappers_refuse_cpu_tensors():
    z = torch.zeros(1, HKV, 1, DH)
    pool = torch.zeros(2, PS, HKV, DH)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TPA.gqa_paged_attention_cuda(z, pool, pool, tbl, ln, sm_scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        TPA.gqa_paged_prefill_cuda(
            torch.zeros(1, 1, HKV, 1, DH), torch.zeros(1, 1, HKV, DH),
            torch.zeros(1, 1, HKV, DH), pool, pool, tbl, ln, ln, sm_scale=1.0)
