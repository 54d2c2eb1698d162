"""Port parity for int8 KV page pools (``kv_quant``) on the CPU, against the
JAX package on the same numpy inputs:

- ``kv_quantize_rows``: identical codes and scales;
- the int8 branches of the K2/K3 plain versions vs the Pallas kernels in
  interpret mode (rtol/atol 2e-5, as ``test_torch_paged_attention.py``:
  softmax sums in another order), with a trash page 0 full of garbage;
- one int8 prefill chunk + decode step of the model: pool codes equal up to
  rare rounding ties (at most 1e-3 of the codes, each off by one), scales
  and logits rtol 1e-4 — the K/V rows differ from the reference's by f32
  summation order before they are quantized;
- the port's CPU engine with ``kv_quant=True, act_quant="a8_prefill"`` is
  greedy-identical to ``JE.ServingEngine(backend="xla")`` on the same
  SmoothQuant+ params (f32 smoke config; no near-tie guard is needed);
- the engine rejects an unknown ``act_quant``.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import apply as JAP
from repro.core import calibration as JC
from repro.kernels.paged_attention import gqa_paged_attention as j_decode
from repro.kernels.paged_attention import gqa_paged_prefill as j_prefill
from repro.models import api as japi
from repro.models.attention import kv_quantize_rows as j_kvq
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import w4a16_matmul as TW4
from repro_torch.models import attention as TA
from repro_torch.models import convert
from repro_torch.models import lm as TLM
from repro_torch.serving import engine as TE

TOL = dict(rtol=2e-5, atol=2e-5)
PS, P, HKV, DH = 8, 4, 2, 16


def _int8_pools(rng, n_pages):
    shp = (n_pages, PS, HKV, DH)
    codes = [rng.integers(-127, 128, shp).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(0.002, 0.03, shp[:3]).astype(np.float32)
              for _ in range(2)]
    for c, s in zip(codes, scales):       # trash page: must never matter
        c[0], s[0] = -128, 1e6
    return codes, scales


def _table(rng, b, live_pages, n_pages):
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, P), np.int32)
    k = 0
    for i, n in enumerate(live_pages):
        table[i, :n] = perm[k:k + n]
        k += n
    return table


@pytest.mark.parametrize("scale", [1.0, 1e-3, 50.0])
def test_kv_quantize_rows_matches_jax(scale):
    rng = np.random.default_rng(int(scale * 1000))
    x = (rng.standard_normal((3, 5, HKV, DH)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0
    jc, js = j_kvq(jnp.asarray(x))
    tc, ts = TA.kv_quantize_rows(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and tuple(ts.shape) == x.shape[:3]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("grp", [1, 3])
def test_int8_decode_plain_matches_pallas(grp):
    rng = np.random.default_rng(20 + grp)
    lengths = np.array([1, 9, 16, 29, 0], np.int32)
    b = len(lengths)
    n_pages = 1 + 4 * b
    (kp, vp), (ks, vs) = _int8_pools(rng, n_pages)
    table = _table(rng, b, [-(-n // PS) for n in lengths], n_pages)
    q = rng.standard_normal((b, HKV, grp, DH)).astype(np.float32)
    scale = DH ** -0.5
    ref = j_decode(*map(jnp.asarray, (q, kp, vp, table, lengths, ks, vs)),
                   sm_scale=scale, interpret=True)
    out = TOPS.gqa_paged_attention(
        *map(torch.from_numpy, (q, kp, vp, table, lengths, ks, vs)),
        sm_scale=scale)
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, HKV, grp, DH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[-1].any()


@pytest.mark.parametrize("grp", [1, 3])
def test_int8_prefill_plain_matches_pallas(grp):
    rng = np.random.default_rng(30 + grp)
    t = 8
    prefix = np.array([0, 5, 16, 11, 0], np.int32)
    chunk = np.array([8, 3, 8, 0, 0], np.int32)
    b = len(prefix)
    n_pages = 1 + 4 * b
    (kp, vp), (ks, vs) = _int8_pools(rng, n_pages)
    table = _table(rng, b, [-(-(p + c) // PS) for p, c in zip(prefix, chunk)],
                   n_pages)
    q = rng.standard_normal((b, t, HKV, grp, DH)).astype(np.float32)
    k_suf = rng.standard_normal((b, t, HKV, DH)).astype(np.float32)
    v_suf = rng.standard_normal((b, t, HKV, DH)).astype(np.float32)
    args = (q, k_suf, v_suf, kp, vp, table, prefix, chunk, ks, vs)
    scale = DH ** -0.5
    ref = j_prefill(*map(jnp.asarray, args), sm_scale=scale, interpret=True)
    out = TOPS.gqa_paged_prefill(*map(torch.from_numpy, args),
                                 sm_scale=scale)
    assert tuple(out.shape) == (b, t, HKV, grp, DH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[4].any()


@pytest.fixture(scope="module")
def sq_outlier():
    """SmoothQuant+ params of the reference's outlier-injected smoke model
    (G=16, α=0.5): its A8 flags come out mixed."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks.common import outlier_model

    jcfg, jp = outlier_model("codellama-7b")
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, rep = JAP.smoothquant_plus(jp, jcfg, batches,
                                   JQuantConfig(group_size=16, alpha=0.5))
    assert any(rep.a8_eligibility.values())
    tcfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    return jcfg, tcfg, jq, convert.from_reference(jax.tree.map(np.asarray,
                                                               jq))


def test_int8_prefill_chunk_and_decode_match_jax(sq_outlier):
    jcfg, tcfg, jq, tp = sq_outlier
    kw = dict(kv_quant=True, act_quant="a8_prefill")
    jcfg, tcfg = jcfg.with_(**kw), tcfg.with_(**kw)
    rng = np.random.default_rng(3)
    b, t, n_pages = 2, 16, 9
    toks = rng.integers(2, jcfg.vocab_size, (b, t)).astype(np.int32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    start = np.array([0, 8], np.int32)          # row 1 continues a prefix
    clen = np.array([16, 11], np.int32)
    jcache = japi.init_paged_cache(jcfg, n_pages, 8)
    jlog, jcache = japi.prefill_chunk_fn(
        jq, {"tokens": jnp.asarray(toks)}, jcache, jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(clen), jcfg, backend="xla",
        last_idx=jnp.asarray(clen - 1))
    tcache = TLM.init_paged_cache(tcfg, n_pages, 8, "cpu")
    tlog, tcache = TLM.lm_prefill_chunk(
        tp, torch.from_numpy(toks), tcache, torch.from_numpy(start),
        torch.from_numpy(clen), torch.from_numpy(table), tcfg,
        last_idx=torch.from_numpy(clen - 1))
    pos = start + clen
    jdec, jcache = japi.decode_paged_fn(
        jq, {"token": jnp.asarray(toks[:, -1:]), "position": jnp.asarray(pos)},
        jcache, jnp.asarray(table), jcfg, backend="xla")
    tdec, tcache = TLM.lm_decode_paged(
        tp, torch.from_numpy(toks[:, -1:]), tcache, torch.from_numpy(pos),
        torch.from_numpy(table), tcfg)
    for a, r in ((tlog, jlog), (tdec, jdec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    for li, lp in enumerate(tcache["layers"]):
        assert lp["k"].dtype == torch.int8 and lp["k_s"].dtype == torch.float32
        for name in ("k", "v"):
            got = lp[name][1:].numpy().astype(np.int32)
            want = np.asarray(jcache["layers"][name][li][1:]).astype(np.int32)
            diff = np.abs(got - want)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            np.testing.assert_allclose(
                lp[name + "_s"][1:].numpy(),
                np.asarray(jcache["layers"][name + "_s"][li][1:]),
                rtol=1e-4, atol=1e-9)


def test_engine_int8_kv_a8_prefill_matches_jax_engine_greedy(sq_outlier,
                                                             monkeypatch):
    jcfg, tcfg, jq, tp = sq_outlier
    kw = dict(kv_quant=True, act_quant="a8_prefill")
    engine_kw = dict(batch_size=3, max_seq=48, page_size=8,
                     max_prefill_tokens=16)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 20, 9, 14, 3, 17)]
    jeng = JE.ServingEngine(jq, jcfg.with_(**kw), backend="xla", **engine_kw)
    jreqs = [JE.Request(uid=i, prompt=p, max_tokens=6)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()

    a8_calls = []
    plain = TW4.w4a8_matmul_plain
    monkeypatch.setattr(TW4, "w4a8_matmul_plain",
                        lambda x, qt: a8_calls.append(x.shape) or plain(x, qt))
    eng = TE.ServingEngine(tp, tcfg.with_(**kw), device="cpu", **engine_kw)
    reqs = [TE.Request(uid=i, prompt=p, max_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    # the run went through both new branches: A8 GEMMs on eligible layers
    # of chunks of >= 16 rows, and chunks that read int8 prefix pages
    assert a8_calls and all(s[0] * s[1] >= TOPS.A8_MIN_TOKENS
                            for s in a8_calls)
    assert any(start > 0 for _, start in eng.stats.chunk_rows)
    assert eng.pools["layers"][0]["k"].dtype == torch.int8


def test_engine_rejects_unknown_act_quant(sq_outlier):
    _, tcfg, _, tp = sq_outlier
    with pytest.raises(ValueError, match="act_quant"):
        TE.ServingEngine(tp, tcfg.with_(act_quant="a8"), device="cpu")


def test_int8_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, HKV, 1, DH)
    pool = torch.zeros(2, PS, HKV, DH, dtype=torch.int8)
    scl = torch.ones(2, PS, HKV)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    for scales in ((scl, scl), (None, None)):
        with pytest.raises(ValueError, match="CUDA"):
            TPA.gqa_paged_attention_int8_cuda(q, pool, pool, tbl, ln,
                                              *scales, sm_scale=1.0)
        with pytest.raises(ValueError, match="CUDA"):
            TPA.gqa_paged_prefill_int8_cuda(
                q[:, None], torch.zeros(1, 1, HKV, DH),
                torch.zeros(1, 1, HKV, DH), pool, pool, tbl, ln, ln, *scales,
                sm_scale=1.0)
