"""Port parity for the encoder-decoder's paged serving: the ``shared_ro``
state leaf (``models/api.py``), the pager's read-only group
(``serving/kv_cache.py``), the exact-match encoder-page index
(``serving/prefix_cache.py``), the scheduler's encoder charge, the engine
and its ``enc_evict`` fault site, on whisper-medium's f32 smoke config with
the JAX package's weights (every bias drawn nonzero), against the JAX
package on the CPU:

- the engine with encoder dedup (request 1 repeats request 0's frames) and
  a white-box mid-decode preemption: the JAX engine's greedy tokens, token
  for token, and its counters (encoder hits and encodes, preemptions,
  swapped bytes: KV rows only, no fixed rows, no encoder rows);
- ``enc_evict`` forcing a matched encoder page set out: the admission
  encodes afresh, as in the JAX engine;
- serve's ``--chaos`` plan, non-strict: the JAX engine's fault log,
  counters, outcomes and tokens;
- ``data_hashes`` byte for byte the reference's; the pager's detach /
  reattach / hold bookkeeping and the scheduler's encoder charge against
  the reference's pager and scheduler;
- refusals (missing or malformed frames, frames on a decoder-only config,
  the token prefix cache) and the registry (``NOT_PORTED`` empty, both
  whisper configs field for field);
- the serve entry's ``[note]`` and ``encoder pages`` lines.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro.serving import kv_cache as JKV
from repro.serving import prefix_cache as JPC
from repro.serving import scheduler as JS
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import convert
from repro_torch.serving import engine as TE
from repro_torch.serving import faults as TF
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving import prefix_cache as TPC
from repro_torch.serving import scheduler as TS

ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config(ARCH, smoke=True).with_(dtype="float32")
    tcfg = get_config(ARCH, smoke=True).with_(dtype="float32")
    rng = np.random.default_rng(3)

    def fill(node):
        if not isinstance(node, dict):
            return node
        return {k: (rng.normal(0.0, 0.1, v.shape).astype(v.dtype)
                    if k in ("b", "bias") and not isinstance(v, dict)
                    else fill(v)) for k, v in node.items()}
    fp = fill(jax.tree.map(np.asarray, japi.init_model(
        jax.random.PRNGKey(1), jcfg)))
    return jcfg, jax.tree.map(jax.numpy.asarray, fp), tcfg, \
        convert.from_reference(fp)


def _requests(mod, vocab, d, n=5, seed=7, max_tokens=6):
    rng = np.random.default_rng(seed)
    lens, elens = (13, 9, 7, 12), (6, 9, 11, 7)
    reqs = []
    for i in range(n):
        fr = (rng.standard_normal((elens[i % 4], d)) * 0.1).astype(
            np.float32)
        if i == 1:
            fr = reqs[0].frames.copy()      # the same audio: an enc hit
        reqs.append(mod.Request(uid=i, prompt=rng.integers(
            2, vocab, lens[i % 4]).astype(np.int32), max_tokens=max_tokens,
            frames=fr))
    return reqs


STATS = ("decoded_tokens", "prefilled_tokens", "steps", "completed",
         "prefill_batches", "preemptions", "resumes", "grown_pages",
         "swapped_out_bytes", "swapped_in_bytes", "swapped_fixed_bytes",
         "idle_steps", "admitted", "pages_shared", "failed", "retries",
         "faults_injected", "enc_hits", "enc_encodes")


def _engine(mod, params, cfg, **kw):
    extra = dict(backend="xla") if mod is JE else dict(device="cpu")
    return mod.ServingEngine(params, cfg, **kw, **extra)


def _preempt_run(mod, params, cfg):
    """test_state_leaves.py's case: batch 3, max_seq 20, 14 four-token
    pages, one mid-decode preemption forced white-box."""
    eng = _engine(mod, params, cfg, batch_size=3, max_seq=20, page_size=4,
                  num_pages=1 + 14, max_prefill_tokens=8)
    reqs = _requests(mod, cfg.vocab_size, cfg.d_model)
    for r in reqs:
        eng.submit(r)
    detached = None
    for _ in range(30):
        eng.step()
        dec = [i for i in eng._active_slots()
               if eng.pos[i] >= eng.pref_target[i]]
        if len(dec) >= 2:
            victim = dec[0]
            pages = eng.pager.slot_pages(victim, "enc")
            eng._preempt(victim)
            st = next(iter(eng._swapped.values()))
            detached = (pages, list(st.enc_pages), st.enc_len,
                        eng.pager.held()[pages].tolist())
            break
    stats = eng.run_until_drained(max_steps=600)
    eng.pager.check_invariants()
    return eng, reqs, stats, detached


def test_engine_matches_jax_with_dedup_and_preemption(models):
    jcfg, jp, tcfg, tp = models
    jeng, jreqs, jst, _ = _preempt_run(JE, jp, jcfg)
    teng, treqs, tst, detached = _preempt_run(TE, tp, tcfg)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for f in STATS:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.preemptions == tst.resumes == 1
    assert tst.enc_hits >= 1 and tst.enc_encodes >= 1
    assert tst.enc_hits + tst.enc_encodes == tst.admitted
    assert tst.swapped_fixed_bytes == 0
    # the image holds the victim's private KV rows only: its encoder pages
    # stayed on the device under one hold each
    pages, held_pages, enc_len, holds = detached
    assert pages and held_pages == pages and enc_len > 0
    assert all(h >= 1 for h in holds)
    kv_page = api.rows_nbytes(api.gather_pool_rows(teng.pools,
                                                   torch.tensor([1])))
    assert tst.swapped_out_bytes % kv_page == 0
    assert tst.swapped_out_bytes == tst.swapped_in_bytes > 0
    assert not teng._swapped
    # everything drained: only evictable encoder pages stay resident
    assert teng.pager.free_pages + teng.pager.evictable_pages() == \
        teng.pager.num_pages - 1
    assert int(teng.pager.held().sum()) == 0


def test_enc_evict_degrades_to_fresh_encode(models):
    jcfg, jp, tcfg, tp = models
    out = {}
    for mod, fmod, params, cfg in ((JE, JF, jp, jcfg), (TE, TF, tp, tcfg)):
        plan = fmod.FaultPlan([fmod.FaultSpec("enc_evict", op=0, times=1)],
                              seed=0)
        eng = _engine(mod, params, cfg, batch_size=2, max_seq=20,
                      page_size=4, fault_plan=plan)
        rng = np.random.default_rng(11)
        fr = (rng.standard_normal((6, cfg.d_model)) * 0.1).astype(np.float32)
        reqs = [mod.Request(uid=i, prompt=rng.integers(
            2, cfg.vocab_size, 7).astype(np.int32), max_tokens=3,
            frames=fr.copy()) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        st = eng.run_until_drained(max_steps=300)
        eng.pager.check_invariants()
        out[mod] = (plan.log, dict(plan.injected), st.completed, st.enc_hits,
                    st.enc_encodes, [r.output for r in reqs])
    assert out[TE] == out[JE]
    assert out[TE][1]["enc_evict"] == 1
    assert out[TE][2:5] == (2, 0, 2)


def test_chaos_plan_matches_jax_engine(models):
    """serve's ``--chaos`` plan, non-strict, 7 requests (every third with
    request 0's audio) on a pool of 24 four-token pages: the JAX engine's
    fault log (``enc_evict`` among the fires), counters, outcomes and
    tokens."""
    jcfg, jp, tcfg, tp = models
    specs = serve.chaos_plan(0).specs
    res = {}
    for mod, fmod, params, cfg in ((JE, JF, jp, jcfg), (TE, TF, tp, tcfg)):
        plan = fmod.FaultPlan([fmod.FaultSpec(**dataclasses.asdict(s))
                               for s in specs], seed=0)
        eng = _engine(mod, params, cfg, batch_size=3, max_seq=24,
                      page_size=4, num_pages=1 + 24, max_prefill_tokens=8,
                      strict=False, fault_plan=plan)
        rng = np.random.default_rng(5)
        reqs = [mod.Request(uid=i, prompt=rng.integers(
            2, cfg.vocab_size, 3 + 2 * (i % 4)).astype(np.int32),
            max_tokens=8, frames=serve.synthetic_frames(i, cfg.d_model))
            for i in range(7)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_steps=800)
        eng.pager.check_invariants()
        res[mod] = (plan, eng, reqs)
    (jplan, jeng, jreqs), (tplan, teng, treqs) = res[JE], res[TE]
    assert tplan.log == jplan.log
    assert tplan.injected == jplan.injected
    assert tplan.injected["enc_evict"] == 1
    assert [(r.uid, r.finish_reason, r.retries, r.reprefills, r.output)
            for r in treqs] == \
        [(r.uid, r.finish_reason, r.retries, r.reprefills, r.output)
         for r in jreqs]
    for f in STATS:
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    assert not teng._swapped


# ------------------------------------------------------- host-side pieces --
@pytest.mark.parametrize("shape,dtype", [((6, 64), np.float32),
                                         ((1500, 1024), np.float32),
                                         ((7, 64), np.float16)])
def test_data_hashes_match_reference(shape, dtype):
    fr = (np.random.default_rng(0).standard_normal(shape) * 0.1).astype(dtype)
    n = -(-shape[0] // 16)
    tpc = TPC.PrefixCache(TKV.PagePool(8, 16, 2, 4), 16, mode="enc")
    jpc = JPC.PrefixCache(JKV.PagePool(8, 16, 2, 4), 16, mode="enc")
    got = tpc.data_hashes(fr, n)
    assert got == jpc.data_hashes(fr, n)
    assert len(got) == n and len(set(got)) == n
    # a transposed view hashes its C-order bytes, as in the reference
    assert tpc.data_hashes(fr.T, 2) == jpc.data_hashes(fr.T, 2)
    # one changed element or one fewer row is a different key
    other = fr.copy()
    other[-1, -1] += 1
    assert tpc.data_hashes(other, n)[0] != got[0]
    assert tpc.data_hashes(fr[:-1], n)[0] != got[0]


def _pager_story(kv, pc):
    """Alloc kv + enc pages, index the enc pages, share them into a second
    slot, detach one slot's group under holds, reattach, detach again and
    drop the holds: (refs, holds, free, evictable) after each step."""
    pool = kv.PagePool(12, 4, 2, 3, groups=("kv", "enc"))
    cache = pc.PrefixCache(pool, 4, mode="enc")
    trace = []

    def snap():
        pool.check_invariants()
        trace.append((pool.refs().tolist(), pool.held().tolist(),
                      pool.free_pages, pool.evictable_pages()))
    pool.grow(0, 2)
    enc = pool.grow(0, 2, group="enc")
    hashes = cache.data_hashes(np.ones((7, 4), np.float32), 2)
    assert cache.insert_exact(hashes, enc) == 2
    snap()
    pool.grow(1, 1)
    assert cache.match_exact(hashes) == enc
    pool.attach(1, enc, group="enc")
    snap()
    pages = pool.detach_group(0, "enc")
    assert pages == enc and (pool.table("enc")[0] == kv.TRASH_PAGE).all()
    snap()
    pool.reattach_group(0, "enc", pages)
    snap()
    pool.free_slot(1)
    pages = pool.detach_group(0, "enc")
    pool.drop_group_holds(pages)
    snap()
    pool.free_slot(0)
    snap()
    return trace


def test_pager_detach_reattach_holds_match_reference():
    trace = _pager_story(TKV, TPC)
    assert trace == _pager_story(JKV, JPC)
    # the cached encoder pages end evictable, never freed
    assert trace[-1][3] == 2 and trace[-1][2] == 12 - 1 - 2
    pool = TKV.PagePool(6, 4, 1, 2, groups=("kv", "enc"))
    pool.grow(0, 1, group="enc")
    with pytest.raises(RuntimeError, match="already owns enc"):
        pool.reattach_group(0, "enc", [2])


def test_live_table_census_counts_encoder_tables():
    """The decode tripwire counts the read-only group's listings in the
    refcount census but not in the write-cursor check."""
    pool = TKV.PagePool(10, 4, 2, 3, groups=("kv", "enc"))
    pool.grow(0, 1)
    pool.grow(0, 2, group="enc")
    kw = dict(refs=pool.refs(), held=pool.held(), cached=pool.cached_mask())
    pos, act = np.array([2, 0]), [True, False]
    TKV.assert_live_tables(pool.table(), pos, 4, act,
                           aux_tables=(pool.table("enc"),), **kw)
    with pytest.raises(TKV.PagerInvariantError, match="refcount"):
        TKV.assert_live_tables(pool.table(), pos, 4, act, **kw)


class _Req:
    def __init__(self, n, frames=None):
        self.prompt = np.arange(2, 2 + n, dtype=np.int32)
        self.max_tokens = 4
        self.frames = frames


def test_scheduler_charges_encoder_pages():
    got = {}
    for kv, sch in ((TKV, TS), (JKV, JS)):
        pool = kv.PagePool(20, 4, 3, 5, groups=("kv", "enc"))
        s = sch.Scheduler(page_size=4, max_seq=20)
        reqs = [_Req(6, np.zeros((9, 8), np.float32)), _Req(3)]
        need = [s.pages_needed(r, pool) for r in reqs]
        from collections import deque
        q = deque([_Req(6, np.zeros((9, 8), np.float32)),
                   _Req(10, np.zeros((17, 8), np.float32))])
        bkts = s.plan(q, [0, 1, 2], pool, reserve=0)
        got[kv] = (need, [(b.slots, b.needs) for b in bkts],
                   [pool.slot_pages(i, "enc") for i in range(3)],
                   pool.free_pages, len(q))
    assert got[TKV] == got[JKV]
    assert got[TKV][0] == [2 + 3, 1]


# ---------------------------------------------------------- refusals etc --
def test_refusals_and_registry(models):
    jcfg, _, tcfg, tp = models
    eng = TE.ServingEngine(tp, tcfg, batch_size=2, max_seq=20, device="cpu")
    bad = [dict(),                                           # no frames
           dict(frames=np.zeros((4, tcfg.d_model + 1), np.float32)),
           dict(frames=np.zeros((0, tcfg.d_model), np.float32)),
           dict(frames=np.zeros((4,), np.float32)),
           dict(frames=np.zeros((33, tcfg.d_model), np.float32))]
    for i, kw in enumerate(bad):
        r = TE.Request(uid=i, prompt=np.asarray([3, 4], np.int32),
                       max_tokens=2, **kw)
        with pytest.raises(TE.RejectedRequest):
            eng.submit(r)
        assert r.finish_reason == "rejected"
    assert eng.stats.rejected == len(bad) and not eng.queue
    ccfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    ceng = TE.ServingEngine(api.init_model(ccfg, device="cpu"), ccfg,
                            batch_size=2, max_seq=20, device="cpu")
    with pytest.raises(TE.RejectedRequest, match="decoder-only"):
        ceng.submit(TE.Request(uid=9, prompt=np.asarray([3, 4], np.int32),
                               max_tokens=2,
                               frames=np.zeros((4, ccfg.d_model),
                                               np.float32)))
    with pytest.raises(ValueError, match="prefix") as port:
        TE.ServingEngine(tp, tcfg, batch_size=2, max_seq=24,
                         prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="prefix") as ref:
        JE.ServingEngine(models[1], jcfg, batch_size=2, max_seq=24,
                         prefix_cache=True, backend="xla")
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="cannot hold one max_seq"):
        TE.ServingEngine(tp, tcfg, batch_size=2, max_seq=20, page_size=4,
                         num_pages=1 + 9, device="cpu")
    assert api.state_leaves(tcfg) == (api.KV_PAGES, api.SHARED_RO)
    assert api.paged_supported(tcfg)[0]
    assert NOT_PORTED == ()
    for smoke in (False, True):
        j = j_get_config(ARCH, smoke=smoke)
        t = get_config(ARCH, smoke=smoke).check()
        for f in dataclasses.fields(j):
            assert repr(getattr(t, f.name)) == repr(getattr(j, f.name)), \
                (smoke, f.name)
    with pytest.raises(ValueError, match="disagree"):
        tcfg.with_(encdec=False).check()
    with pytest.raises(ValueError, match="disagree"):
        get_config("codellama-7b").with_(encdec=True, enc_layers=2).check()


def test_serve_whisper_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "7", "--batch-size", "3", "--max-seq",
                      "48", "--max-tokens", "6"])
    out = capsys.readouterr().out
    assert ("[note] token prefix cache disabled: audio slots carry state "
            "leaves ('kv_pages', 'shared_ro')") in out
    eng = res["engine"]
    st = eng.stats
    # requests 0, 3 and 6 carry the same audio: two of them hit, unless an
    # eviction intervened (none can here: the pool is the default)
    assert (st.enc_encodes, st.enc_hits) == (5, 2)
    assert f"encoder pages: {st.enc_encodes} encodes, {st.enc_hits} " \
        "exact-match hits" in out
    assert eng.cache is None
    assert all(r.finish_reason in ("completed", "length")
               for r in res["requests"])
    for i, r in enumerate(res["requests"]):
        np.testing.assert_array_equal(r.frames, serve.synthetic_frames(
            i, eng.cfg.d_model))
