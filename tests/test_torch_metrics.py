"""Port parity for the engine's observability (``serving/metrics.py``,
``serving/trace.py`` and their observation points in
``serving/engine.py``), against the JAX package on the CPU:

- histogram bounds, buckets, percentiles, summaries and snapshot deltas
  equal the reference's on the same observations; counters, gauges and the
  registry's snapshot too;
- the reference test's golden recorder, rebuilt with the port's classes,
  exports ``tests/data/golden_trace.json`` byte for byte;
- on a clock advanced once per step, the engine's Chrome trace and its
  ``metrics_snapshot()`` (histograms, counters, gauges, scheduler and pager
  counters, the pending report) equal the JAX engine's event for event, on
  a tight pool (preemption, swap, prefix cache, chunked prefill);
- ``metrics=False`` leaves every token unchanged and records nothing.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serving import engine as JE
from repro.serving import metrics as JM
from repro.serving import trace as JT
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.serving import engine as TE
from repro_torch.serving import metrics as TM
from repro_torch.serving import trace as TT

DATA = os.path.join(os.path.dirname(__file__), "data")


# ------------------------------------------------------ metrics core (pure) --
@pytest.mark.parametrize("kw", [dict(), dict(per_decade=48),
                                dict(lo=1e-3, hi=1e3, per_decade=1),
                                dict(lo=1e-4, hi=10.0, per_decade=7)])
def test_histogram_matches_reference(kw):
    rng = np.random.default_rng(0)
    obs = np.concatenate([10 ** rng.uniform(-7, 4, 300), [0.0, -1.0, 1e-6,
                                                          1e-3, 5.0, 1e9]])
    th, jh = TM.Histogram("h", **kw), JM.Histogram("h", **kw)
    assert th.bounds == jh.bounds
    for i, v in enumerate(obs):
        th.observe(float(v), k=i % 2)
        jh.observe(float(v), k=i % 2)
        if i == 150:
            t0, j0 = th.counts(k=0), jh.counts(k=0)
    for lab in (dict(k=0), dict(k=1), dict(k=7)):
        assert dataclasses.astuple(th.counts(**lab)) == \
            dataclasses.astuple(jh.counts(**lab))
        assert th.summary(**lab) == jh.summary(**lab)
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert th.percentile(q, **lab) == jh.percentile(q, **lab)
    dt, dj = th.counts(k=0) - t0, jh.counts(k=0) - j0
    assert dt.buckets == dj.buckets and dt.count == dj.count
    assert [dt.percentile(q) for q in (0.5, 0.99)] == \
        [dj.percentile(q) for q in (0.5, 0.99)]
    assert th.snapshot() == jh.snapshot()
    assert TM.percentile_from_counts((1.0, 2.0), (0, 3, 1), 0.5) == \
        JM.percentile_from_counts((1.0, 2.0), (0, 3, 1), 0.5)


def test_registry_counters_gauges_match_reference():
    snaps = []
    for M in (TM, JM):
        reg = M.MetricsRegistry(clock=lambda: 42.0)
        c = reg.counter("faults")
        c.inc(site="page_alloc")
        c.inc(2, site="page_alloc")
        c.inc(site="swap_drain")
        g = reg.gauge("pool")
        g.set(7, group="kv")
        g.set(9, group="kv")
        reg.histogram("lat").observe(0.25)
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("faults")
        with pytest.raises(ValueError, match="< 0"):
            c.inc(-1)
        snaps.append((reg.now(), c.total(), reg.snapshot()))
    assert snaps[0] == snaps[1]


def _golden_recorder(T):
    """The reference test's golden recorder (``tests/test_metrics.py``),
    built with the classes of module ``T``."""
    t = [0.0]
    rec = T.TraceRecorder(lambda: t[0])
    tl = rec.timeline(7)
    tl.add(0.0, "submit", prompt=5)
    rec.begin_step(0)
    rec.note_chunk(0, 7, 5)
    tl.add(0.0005, "admit", slot=0, cached_tokens=0)
    rec.note_fault("page_alloc")
    t[0] = 0.001
    rec.end_step([], pages_used=2, pages_free=6, pages_grown=2,
                 pages_cow=0, pages_evicted=0)
    tl.add(0.001, "first_token", slot=0)
    rec.begin_step(1)
    tl.add(0.0015, "preempt", slot=0, bytes=1024)
    rec.note_preempt(7, 0)
    tl.add(0.0018, "swap_in", slot=1)
    rec.note_resume(7, 1)
    t[0] = 0.002
    rec.end_step([1], pages_used=3, pages_free=5, pages_grown=1,
                 pages_cow=0, pages_evicted=0)
    tl.add(0.002, "finish", reason="completed")
    tl.finish_t = 0.002
    rec.finish(7)
    return rec


def test_chrome_trace_golden(tmp_path):
    obj = TT.to_chrome_trace(_golden_recorder(TT), base=0.0, n_slots=2)
    with open(os.path.join(DATA, "golden_trace.json")) as f:
        want = f.read()
    assert json.dumps(obj, indent=1) + "\n" == want
    path = tmp_path / "trace.json"
    TT.write_chrome_trace(str(path), _golden_recorder(TT), base=0.0,
                          n_slots=2)
    assert path.read_text() == want


def test_trace_ring_buffers_and_disabled_recorder():
    out = []
    for T in (TT, JT):
        t = [0.0]
        rec = T.TraceRecorder(lambda: t[0], journal_len=4, keep_finished=2)
        for step in range(10):
            rec.begin_step(step)
            t[0] += 0.001
            rec.end_step([0], pages_used=1, pages_free=7, pages_grown=0,
                         pages_cow=0, pages_evicted=0)
        for uid in range(5):
            rec.event(uid, "submit")
            rec.finish(uid)
        off = T.TraceRecorder(lambda: 5.0, enabled=False)
        off.begin_step(0)
        off.note_chunk(0, 1, 8)
        out.append(([s.step for s in rec.journal],
                    [tl.uid for tl in rec.finished], off.event(1, "x"),
                    len(off.journal), len(off.live)))
    assert out[0] == out[1] == ([6, 7, 8, 9], [3, 4], 5.0, 0, 0)


# ------------------------------------------------------ engine, step clock --
@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("codellama-7b", smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jp, get_config("codellama-7b", smoke=True).with_(
        dtype="float32"), tp


def _serve(mod, params, cfg, metrics=True):
    """Six prompts behind a 4-token stem on a tight pool (3 slots, 7 pages
    of 4 tokens, 4-token chunks, the prefix cache on), one engine step per
    clock second; the cancel of uid 5 after step 3 and a deadline on uid 4
    put those events in the trace too."""
    extra = dict(backend="xla") if mod is JE else dict(device="cpu")
    eng = mod.ServingEngine(params, cfg, batch_size=3, max_seq=24,
                            page_size=4, num_pages=1 + 7,
                            max_prefill_tokens=4, prefix_cache=True,
                            metrics=metrics, **extra)
    t = [0.0]
    eng._clock = lambda: t[0]
    rng = np.random.default_rng(5)
    stem = rng.integers(2, cfg.vocab_size, 4).astype(np.int32)
    reqs = [mod.Request(uid=i, prompt=np.concatenate(
                [stem, rng.integers(2, cfg.vocab_size, n).astype(np.int32)]),
                max_tokens=8, deadline_s=20.5 if i == 4 else None)
            for i, n in enumerate((3, 7, 10, 5, 14, 6))]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots):
        t[0] += 1.0
        eng.step()
        steps += 1
        if steps == 3:
            assert eng.cancel(5)
    return eng, reqs


def test_engine_trace_and_snapshot_match_jax_engine(models):
    jcfg, jp, tcfg, tp = models
    jeng, jreqs = _serve(JE, jp, jcfg)
    teng, treqs = _serve(TE, tp, tcfg)
    assert [(r.finish_reason, r.output) for r in treqs] == \
        [(r.finish_reason, r.output) for r in jreqs]
    tobj = TT.to_chrome_trace(teng.trace, n_slots=teng.B)
    jobj = JT.to_chrome_trace(jeng.trace, n_slots=jeng.B)
    assert tobj == jobj
    names = {e["name"] for e in tobj["traceEvents"]}
    assert {"decode", "prefill_chunk", "pool_pages", "preempt", "swap_in",
            "swap", "admit", "first_token", "finish"} <= names
    ts, js = teng.metrics_snapshot(), jeng.metrics_snapshot()
    for key in ("step", "latency", "counters", "gauges", "scheduler",
                "pager", "pending"):
        assert ts[key] == js[key], key
    for f, v in js["engine"].items():
        if f in ts["engine"]:
            assert ts["engine"][f] == v, f
    lat = ts["latency"]
    assert [r.finish_reason for r in treqs].count("cancelled") == 1
    assert [r.finish_reason for r in treqs].count("deadline") == 1
    assert lat["ttft_s"]["count"] == sum(r.first_token_t is not None
                                         for r in treqs) == 4
    assert lat["e2e_s"]["count"] == 6
    assert lat["queue_wait_s"]["count"] == teng.stats.admitted
    assert lat["swap_stall_s"]["count"] == teng.stats.resumes > 0
    assert lat["itl_s"]["count"] == teng.stats.decoded_tokens
    # the journal holds one record per step, decode slots as launched
    assert len(teng.trace.journal) == ts["step"]
    assert [(s.step, s.decode_slots, s.chunks, s.preempts, s.resumes,
             s.pages_used, s.pages_grown, s.pages_cow, s.pages_evicted)
            for s in teng.trace.journal] == \
        [(s.step, s.decode_slots, s.chunks, s.preempts, s.resumes,
          s.pages_used, s.pages_grown, s.pages_cow, s.pages_evicted)
         for s in jeng.trace.journal]
    assert teng._pending_report() == TM.format_pending(ts)


def test_metrics_off_same_tokens_nothing_recorded(models):
    _, _, tcfg, tp = models
    on, on_reqs = _serve(TE, tp, tcfg, metrics=True)
    off, off_reqs = _serve(TE, tp, tcfg, metrics=False)
    assert [(r.finish_reason, r.output) for r in off_reqs] == \
        [(r.finish_reason, r.output) for r in on_reqs]
    assert off.stats.preemptions == on.stats.preemptions > 0
    assert not off.trace.journal and not off.trace.finished \
        and not off.trace.live
    snap = off.metrics_snapshot()
    assert all(h["count"] == 0 for h in snap["latency"].values())
    assert snap["engine"]["completed"] == on.stats.completed
    assert snap["gauges"] == {}
