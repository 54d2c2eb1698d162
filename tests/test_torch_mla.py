"""Port parity for Multi-head Latent Attention on the CPU, against the JAX
package on the same numpy inputs (f32 deepseek-v2-236b smoke widths: r=16,
dr=8, 4 heads):

- B8 / B9 plain versions (absorbed paged MLA decode / chunked prefill) vs
  the Pallas kernels ``mla_paged_attention`` / ``mla_paged_prefill`` in
  interpret mode, fp and int8 latent pools, ragged lengths, an empty slot,
  empty prefixes, padding rows (``t >= chunk_len``), and a trash page 0
  full of garbage that must never leak in; rtol/atol 2e-5 (softmax sums in
  another order, as ``test_torch_paged_attention.py``);
- ``mla_decode_paged`` / ``mla_prefill_chunk`` vs the reference's with
  ``paged_attn_impl="pallas_interpret"`` on the same fp weights and pools:
  outputs rtol/atol 1e-4 (f32 summation order through five projections),
  latent pools written the same (fp rows 1e-5; int8 codes equal up to
  rare rounding ties, each off by one);
- the gather oracle of the port agrees with its kernel route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.paged_attention import mla_paged_attention as j_decode
from repro.kernels.paged_attention import mla_paged_prefill as j_prefill
from repro.models import attention as JA
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.models import attention as TA
from repro_torch.models import convert

TOL = dict(rtol=2e-5, atol=2e-5)
PS, P, H, R, DR = 8, 4, 4, 16, 8


def _table(rng, b, live_pages, n_pages):
    """Shuffled distinct pages for each slot's live prefix, trash beyond."""
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, P), np.int32)
    k = 0
    for i, n in enumerate(live_pages):
        table[i, :n] = perm[k:k + n]
        k += n
    return table


def _pools(rng, n_pages, quant):
    """(ckv, kpe, ckv_s, kpe_s) with a poisoned trash page 0 (scales None
    for fp pools)."""
    if quant:
        ckv = rng.integers(-127, 128, (n_pages, PS, R)).astype(np.int8)
        kpe = rng.integers(-127, 128, (n_pages, PS, DR)).astype(np.int8)
        cs = rng.uniform(0.002, 0.03, (n_pages, PS)).astype(np.float32)
        ps = rng.uniform(0.002, 0.03, (n_pages, PS)).astype(np.float32)
        ckv[0], kpe[0], cs[0], ps[0] = -128, -128, 1e6, 1e6
        return ckv, kpe, cs, ps
    ckv = rng.standard_normal((n_pages, PS, R)).astype(np.float32)
    kpe = rng.standard_normal((n_pages, PS, DR)).astype(np.float32)
    ckv[0], kpe[0] = 1e6, -1e6
    return ckv, kpe, None, None


def _scales(pools):
    return [a for a in pools[2:] if a is not None]


@pytest.mark.parametrize("quant", [False, True])
def test_mla_decode_plain_matches_pallas(quant):
    rng = np.random.default_rng(40 + quant)
    lengths = np.array([1, 9, 16, 29, 0], np.int32)   # 0: empty slot
    b = len(lengths)
    n_pages = 1 + 4 * b
    pools = _pools(rng, n_pages, quant)
    table = _table(rng, b, [-(-n // PS) for n in lengths], n_pages)
    q_lat = rng.standard_normal((b, H, R)).astype(np.float32)
    q_pe = rng.standard_normal((b, H, DR)).astype(np.float32)
    args = (q_lat, q_pe, *pools[:2], table, lengths, *_scales(pools))
    scale = 24 ** -0.5
    ref = j_decode(*map(jnp.asarray, args), sm_scale=scale, interpret=True)
    out = TOPS.mla_paged_attention(*map(torch.from_numpy, args),
                                   sm_scale=scale)
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, H, R)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[-1].any()                # empty slot: exact zeros


@pytest.mark.parametrize("quant", [False, True])
def test_mla_prefill_plain_matches_pallas(quant):
    rng = np.random.default_rng(50 + quant)
    t = 8
    prefix = np.array([0, 5, 16, 11, 0], np.int32)
    chunk = np.array([8, 3, 8, 0, 0], np.int32)       # row 4: cold and empty
    b = len(prefix)
    n_pages = 1 + 4 * b
    pools = _pools(rng, n_pages, quant)
    table = _table(rng, b, [-(-(p + c) // PS) for p, c in zip(prefix, chunk)],
                   n_pages)
    q_lat = rng.standard_normal((b, t, H, R)).astype(np.float32)
    q_pe = rng.standard_normal((b, t, H, DR)).astype(np.float32)
    c_suf = rng.standard_normal((b, t, R)).astype(np.float32)
    k_suf = rng.standard_normal((b, t, DR)).astype(np.float32)
    args = (q_lat, q_pe, c_suf, k_suf, *pools[:2], table, prefix, chunk,
            *_scales(pools))
    scale = 24 ** -0.5
    ref = j_prefill(*map(jnp.asarray, args), sm_scale=scale, interpret=True)
    out = TOPS.mla_paged_prefill(*map(torch.from_numpy, args),
                                 sm_scale=scale)
    assert tuple(out.shape) == (b, t, H, R)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert bool(torch.isfinite(out).all())  # padding rows included
    assert not out[4].any()                 # no prefix, no chunk: zeros


@pytest.mark.parametrize("quant", [False, True])
def test_mla_plain_versions_ignore_trash_page_contents(quant):
    rng = np.random.default_rng(7)
    lengths = np.array([3, 12], np.int32)
    pools = list(_pools(rng, 9, quant))
    table = _table(rng, 2, [1, 2], 9)
    q_lat = torch.from_numpy(rng.standard_normal((2, H, R)).astype(
        np.float32))
    q_pe = torch.from_numpy(rng.standard_normal((2, H, DR)).astype(
        np.float32))

    def run():
        return TPA.mla_paged_attention_plain(
            q_lat, q_pe, *map(torch.from_numpy, pools[:2]),
            torch.from_numpy(table), torch.from_numpy(lengths),
            *map(torch.from_numpy, _scales(pools)), sm_scale=0.25)

    a = run()
    for arr in pools:
        if arr is not None:
            arr[0] = 7 if arr.dtype == np.int8 else -3e5
    assert torch.equal(a, run())


# ------------------------------------------------- the attention functions --
def _to_port(tree):
    return {k: _to_port(v) if isinstance(v, dict) else
            convert.to_tensor(np.asarray(v)) for k, v in tree.items()}


def _setup(kv_quant):
    jcfg = j_get_config("deepseek-v2-236b", smoke=True).with_(
        dtype="float32", kv_quant=kv_quant)
    tcfg = get_config("deepseek-v2-236b", smoke=True).with_(
        dtype="float32", kv_quant=kv_quant)
    jp = JA.init_mla(jax.random.PRNGKey(0), jcfg)
    b, pages, n_pages = 3, 4, 13
    rng = np.random.default_rng(11 + kv_quant)
    table = np.stack([np.arange(1, 13)[i::3][:4] for i in range(b)]).astype(
        np.int32)
    pool = {k: np.asarray(v) for k, v in
            JA.init_mla_page_pool(jcfg, n_pages, PS).items()}
    for k, v in pool.items():               # random contents, trash included
        if v.dtype == np.int8:
            pool[k] = rng.integers(-127, 128, v.shape).astype(np.int8)
        elif k.endswith("_s"):
            pool[k] = rng.uniform(1e-3, 2e-2, v.shape).astype(np.float32)
        else:
            pool[k] = rng.standard_normal(v.shape).astype(np.float32)
    assert table.shape == (b, pages)
    return jcfg, tcfg, jp, _to_port(jp), table, pool, rng


def _check_pools(tpool, jpool, kv_quant):
    for k, v in jpool.items():
        got, want = tpool[k].numpy(), np.asarray(v)
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_mla_decode_paged_matches_jax(kv_quant):
    jcfg, tcfg, jp, tp, table, pool, rng = _setup(kv_quant)
    b = table.shape[0]
    wp = np.array([4, 15, 30], np.int32)
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    y_ref, jpool = JA.mla_decode_paged(
        jp, jnp.asarray(x), jnp.asarray(wp)[:, None],
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(table),
        jnp.asarray(wp), jcfg.with_(paged_attn_impl="pallas_interpret"),
        backend="xla")
    outs = []
    for impl in ("auto", "gather"):
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        y, tpool = TA.mla_decode_paged(
            tp, torch.from_numpy(x), torch.from_numpy(wp)[:, None], tpool,
            torch.from_numpy(table), torch.from_numpy(wp),
            tcfg.with_(paged_attn_impl=impl))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                                   atol=1e-4)
        _check_pools(tpool, jpool, kv_quant)
        outs.append(y)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_mla_prefill_chunk_matches_jax(kv_quant):
    jcfg, tcfg, jp, tp, table, pool, rng = _setup(kv_quant)
    b, t = table.shape[0], 8
    start = np.array([0, 8, 13], np.int32)   # cold, page-aligned, mid-page
    clen = np.array([8, 5, 0], np.int32)     # padding rows; an empty row
    x = rng.standard_normal((b, t, jcfg.d_model)).astype(np.float32)
    y_ref, jpool = JA.mla_prefill_chunk(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(table), jnp.asarray(start), jnp.asarray(clen),
        jcfg.with_(paged_attn_impl="pallas_interpret"), backend="xla")
    for impl in ("auto", "gather"):
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        y, tpool = TA.mla_prefill_chunk(
            tp, torch.from_numpy(x), tpool, torch.from_numpy(table),
            torch.from_numpy(start), torch.from_numpy(clen),
            tcfg.with_(paged_attn_impl=impl))
        assert bool(torch.isfinite(y).all())
        # rows past chunk_len are padding nothing reads
        for i, n in enumerate(clen):
            np.testing.assert_allclose(y[i, :n].numpy(),
                                       np.asarray(y_ref)[i, :n], rtol=1e-4,
                                       atol=1e-4)
        # the trash page takes the padding rows' writes: compare live pages
        jp_live = {k: np.asarray(v)[1:] for k, v in jpool.items()}
        _check_pools({k: v[1:] for k, v in tpool.items()}, jp_live, kv_quant)


def test_init_mla_page_pool_layout():
    for kv_quant in (False, True):
        cfg = get_config("deepseek-v2-236b", smoke=True).with_(
            dtype="float32", kv_quant=kv_quant)
        pool = TA.init_mla_page_pool(cfg, 5, PS, "cpu")
        jpool = JA.init_mla_page_pool(j_get_config(
            "deepseek-v2-236b", smoke=True).with_(dtype="float32",
                                                  kv_quant=kv_quant), 5, PS)
        assert set(pool) == set(jpool)
        for k, v in jpool.items():
            assert tuple(pool[k].shape) == v.shape
            assert str(pool[k].dtype)[6:] == str(v.dtype)


def test_mla_cuda_wrappers_refuse_cpu_tensors():
    ql, qp = torch.zeros(1, H, R), torch.zeros(1, H, DR)
    ckv, kpe = torch.zeros(2, PS, R), torch.zeros(2, PS, DR)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TPA.mla_paged_attention_cuda(ql, qp, ckv, kpe, tbl, ln, sm_scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        TPA.mla_paged_prefill_cuda(ql[:, None], qp[:, None], ckv[:1, :1],
                                   kpe[:1, :1], ckv, kpe, tbl, ln, ln,
                                   sm_scale=1.0)
    c8, k8 = ckv.to(torch.int8), kpe.to(torch.int8)
    scl = torch.ones(2, PS)
    with pytest.raises(ValueError, match="CUDA"):
        TPA.mla_paged_attention_int8_cuda(ql, qp, c8, k8, tbl, ln, scl, scl,
                                          sm_scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        TPA.mla_paged_prefill_int8_cuda(ql[:, None], qp[:, None],
                                        ckv[:1, :1], kpe[:1, :1], c8, k8,
                                        tbl, ln, ln, scl, scl, sm_scale=1.0)
