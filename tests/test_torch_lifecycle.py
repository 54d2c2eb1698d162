"""Port parity for the request lifecycle (``serving/engine.py``): TTFT and
total deadlines, ``cancel`` in each phase, bounded-queue backpressure and
the non-strict quarantine, against the JAX engine (``backend="xla"``) on
codellama-7b smoke in f32, on the same weights.

Each engine runs on its own clock, which the test advances by one second
before every step, so deadlines fire at the same step in both.  The
workload is tight: 7 pages of 4 tokens for 3 slots, 4-token prefill chunks
and the prefix cache on, so requests pass through every phase (queued,
prefilling, decoding, swapped out).  Each case must give the JAX engine's
per-uid ``finish_reason`` and outputs, and its ``EngineStats``.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.serving import engine as TE

ENGINE = dict(batch_size=3, max_seq=24, page_size=4, num_pages=1 + 7,
              max_prefill_tokens=4, prefix_cache=True)
STATS = ("decoded_tokens", "prefilled_tokens", "steps", "completed",
         "prefill_batches", "preemptions", "resumes", "grown_pages",
         "swapped_out_bytes", "swapped_in_bytes", "idle_steps", "max_active",
         "active_slot_steps", "admitted", "prefix_hits",
         "prefix_matched_tokens", "pages_shared", "pages_inserted",
         "pages_evicted", "cow_copies", "rejected", "expired", "cancelled",
         "failed", "retries", "faults_injected")


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("codellama-7b", smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jp, get_config("codellama-7b", smoke=True).with_(
        dtype="float32"), tp


def _engines(models, **kw):
    jcfg, jp, tcfg, tp = models
    kw = {**ENGINE, **kw}
    return (_clocked(JE.ServingEngine(jp, jcfg, backend="xla", **kw)),
            _clocked(TE.ServingEngine(tp, tcfg, device="cpu", **kw)))


def _clocked(eng):
    """The engine's clock, advanced by one before each of its steps."""
    t = [0.0]
    eng._clock = lambda: t[0]
    step = eng.step

    def ticking():
        t[0] += 1.0
        return step()

    eng.step = ticking
    return eng


def _requests(mod, vocab, deadlines=None, n=6):
    """Six prompts of 7-18 tokens behind a shared 4-token stem;
    ``deadlines[uid] = (deadline_s, ttft_deadline_s)``."""
    deadlines = deadlines or {}
    rng = np.random.default_rng(5)
    stem = rng.integers(2, vocab, 4).astype(np.int32)
    lens = (3, 7, 10, 5, 14, 6)
    out = []
    for i in range(n):
        d, td = deadlines.get(i, (None, None))
        out.append(mod.Request(
            uid=i, prompt=np.concatenate(
                [stem, rng.integers(2, vocab, lens[i]).astype(np.int32)]),
            max_tokens=8, deadline_s=d, ttft_deadline_s=td))
    return out


def _same(jeng, teng, jreqs, treqs):
    assert [(r.uid, r.finish_reason, r.output) for r in treqs] == \
        [(r.uid, r.finish_reason, r.output) for r in jreqs]
    for f in STATS:
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    assert [r.error is None for r in treqs] == \
        [r.error is None for r in jreqs]
    teng.pager.check_invariants()
    assert not teng.queue and not teng._swapped
    assert teng.pager.free_pages + teng.pager.evictable_pages() \
        == teng.pager.num_pages - 1


def _phases(eng):
    return {p["uid"]: p["phase"] for p in eng.metrics_snapshot()["pending"]}


def test_deadlines_in_every_phase_match_jax_engine(models):
    """TTFT and total deadlines timed (one second per step) to expire one
    request queued, one prefilling, one decoding and one swapped out."""
    deadlines = {1: (7.5, None), 2: (12.5, None), 3: (None, 10.5),
                 4: (None, 3.0)}
    jeng, teng = _engines(models)
    vocab = teng.cfg.vocab_size
    jreqs = _requests(JE, vocab, deadlines)
    treqs = _requests(TE, vocab, deadlines)
    for j, t in zip(jreqs, treqs):
        jeng.submit(j)
        teng.submit(t)
    expired_in = {}
    while teng.queue or any(s is not None for s in teng.slots):
        before = _phases(teng)
        jeng.step()
        teng.step()
        assert _phases(teng) == _phases(jeng)
        for r in treqs:
            if r.finish_reason == "deadline" and r.uid not in expired_in:
                expired_in[r.uid] = before[r.uid]
    assert not jeng.queue and not any(jeng.slots)
    assert sorted(expired_in.values()) == ["decoding", "prefilling",
                                           "queued", "swapped"]
    assert all(t.first_token_t is None for t in treqs
               if t.ttft_deadline_s is not None
               and t.finish_reason == "deadline")
    _same(jeng, teng, jreqs, treqs)


def test_cancel_in_every_phase_matches_jax_engine(models):
    """In lockstep: the first request seen swapped out, then one queued,
    one prefilling and one decoding, are cancelled in both engines;
    cancelling one again (or an unknown uid) returns False."""
    jeng, teng = _engines(models)
    vocab = teng.cfg.vocab_size
    jreqs, treqs = _requests(JE, vocab), _requests(TE, vocab)
    for j, t in zip(jreqs, treqs):
        jeng.submit(j)
        teng.submit(t)
    todo = ["swapped", "queued", "prefilling", "decoding"]
    cancelled = {}
    while teng.queue or any(s is not None for s in teng.slots):
        jeng.step()
        teng.step()
        phases = _phases(teng)
        assert phases == _phases(jeng)
        uid = next((u for u, ph in phases.items()
                    if todo and ph == todo[0]), None)
        if uid is not None:
            assert teng.cancel(uid) and jeng.cancel(uid)
            cancelled[uid] = todo.pop(0)
    assert not todo, f"phases never seen: {todo}"
    assert not teng.cancel(next(iter(cancelled))) and not teng.cancel(999)
    tr = {r.uid: r for r in treqs}
    assert all(tr[u].finish_reason == "cancelled" for u in cancelled)
    assert len(tr[next(u for u, p in cancelled.items()
                       if p == "decoding")].output) > 0
    _same(jeng, teng, jreqs, treqs)


def test_bounded_queue_backpressure_matches_jax_engine(models):
    """``max_queue=2``: submits past two waiting requests return False
    (``rejected``, no raise); later submits enter once the queue drains."""
    jeng, teng = _engines(models, max_queue=2)
    vocab = teng.cfg.vocab_size
    jreqs, treqs = _requests(JE, vocab), _requests(TE, vocab)
    took = []
    for j, t in zip(jreqs[:4], treqs[:4]):
        took.append((jeng.submit(j), teng.submit(t)))
    assert took == [(True, True), (True, True), (False, False),
                    (False, False)]
    assert treqs[2].finish_reason == "rejected" and "queue full" in \
        treqs[2].error
    while teng.queue:           # admission empties the queue
        jeng.step()
        teng.step()
    for j, t in zip(jreqs[4:], treqs[4:]):
        assert jeng.submit(j) and teng.submit(t)
    jeng.run_until_drained()
    teng.run_until_drained()
    assert teng.stats.rejected == 2
    _same(jeng, teng, jreqs, treqs)


def _leak_pages(eng):
    """A page leak: all but one page disappear from the free list."""
    eng.pager._free = eng.pager._free[:1]


def test_nonstrict_quarantines_stalled_head_like_jax_engine(models):
    """With one page left and ``strict=False``, the head that needs two is
    failed with the stall report and the small request behind it served;
    strict engines raise the same report."""
    results = []
    for strict in (False, True):
        jeng, teng = _engines(models, batch_size=2, max_seq=16,
                              num_pages=9, prefix_cache=False,
                              max_prefill_tokens=None, strict=strict)
        pair = []
        for mod, eng in ((JE, jeng), (TE, teng)):
            _leak_pages(eng)
            reqs = [mod.Request(uid=42, prompt=np.arange(2, 9, dtype=np.int32),
                                max_tokens=2),
                    mod.Request(uid=43, prompt=np.arange(2, 4, dtype=np.int32),
                                max_tokens=2)]
            for r in reqs:
                eng.submit(r)
            pair.append(reqs)
        if strict:
            for eng in (jeng, teng):
                with pytest.raises(RuntimeError, match="admission stalled"):
                    eng.run_until_drained()
            continue
        jeng.run_until_drained()
        teng.run_until_drained()
        jreqs, treqs = pair
        assert [(r.finish_reason, r.output) for r in treqs] == \
            [(r.finish_reason, r.output) for r in jreqs]
        assert treqs[0].finish_reason == "failed"
        for needle in ("admission stalled", "uid=42", "phase=queued",
                       "pager: free="):
            assert needle in treqs[0].error
        assert treqs[1].finish_reason in ("completed", "length")
        for f in STATS:
            assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
        results.append(teng.stats.failed)
    assert results == [1]


def test_nonstrict_quarantines_write_hazard(models):
    """A page listed by a second slot under a live write cursor trips the
    tripwire: strict raises, ``strict=False`` fails that request only."""
    _, _, tcfg, tp = models
    for strict in (True, False):
        eng = TE.ServingEngine(tp, tcfg, device="cpu", batch_size=3,
                               max_seq=16, page_size=4, strict=strict)
        r1 = TE.Request(uid=1, prompt=np.arange(2, 8, dtype=np.int32),
                        max_tokens=6)
        r2 = TE.Request(uid=2, prompt=np.arange(2, 11, dtype=np.int32),
                        max_tokens=6)
        eng.submit(r1)
        eng.submit(r2)
        eng.step()
        pg = int(eng.pager.table()[0, int(eng.pos[0]) // eng.PS])
        eng.pager._table_g["kv"][2, 0] = pg
        eng.pager._slot_pages_g["kv"][2].append(pg)
        eng.pager._ref[pg] += 1
        if strict:
            with pytest.raises(TE.KV.PagerInvariantError, match="hazard"):
                eng.step()
            continue
        eng.step()
        assert r1.finish_reason == "failed" and "hazard" in r1.error
        eng.run_until_drained()
        assert r2.finish_reason in ("completed", "length")
        eng.pager.free_slot(2)
        eng.pager.check_invariants()
        assert eng.stats.failed == 1
