"""Port parity for fault injection (``serving/faults.py`` and its sites in
the pager, the prefix cache, the scheduler and the engine step), against
the JAX package on the CPU:

- a :class:`FaultPlan` of each spec kind (``step``, ``op``, ``every``,
  ``prob``, ``times``, ``pool_pressure`` windows) fires at the same probes
  as the reference's, with the same log, tallies and pressure;
- ``corrupt_host_image`` flips byte 0 of a copy, never the image it got;
- each attention-relevant site alone, and serve's whole ``--chaos`` plan, on
  codellama-7b smoke in f32 with the prefix cache on and a tight pool, give
  the JAX engine's fault log, ``faults_fired_total`` counters, per-uid
  ``finish_reason``, ``retries``, ``reprefills`` and outputs, and its
  ``EngineStats``;
- a grow fault that never stops fails its request on the retry budget.
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
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.serving import engine as TE
from repro_torch.serving import faults as TF

STATS = ("decoded_tokens", "prefilled_tokens", "steps", "completed",
         "prefill_batches", "preemptions", "resumes", "grown_pages",
         "swapped_out_bytes", "swapped_in_bytes", "idle_steps", "admitted",
         "prefix_hits", "prefix_matched_tokens", "pages_shared",
         "pages_inserted", "pages_evicted", "cow_copies", "expired",
         "failed", "retries", "faults_injected")


# ------------------------------------------------------------ plan (pure) --
def test_sites_and_spec_validation_match_reference():
    assert TF.SITES == JF.SITES
    for kw, msg in ((dict(site="bogus", step=1), "unknown fault site"),
                    (dict(site="page_alloc"), "no firing"),
                    (dict(site="page_alloc", every=0), "every")):
        for mod in (TF, JF):
            with pytest.raises(ValueError, match=msg):
                mod.FaultSpec(**kw)


SPECS = {
    "step": [dict(site="decode_launch", step=3, times=2)],
    "op": [dict(site="page_grow", op=4), dict(site="page_grow", op=7)],
    "every": [dict(site="page_alloc", every=3, times=None)],
    "prob": [dict(site="page_alloc", prob=0.3, times=5),
             dict(site="prefix_evict", prob=0.5, times=None)],
    "times": [dict(site="swap_drain", every=1, times=2),
              dict(site="swap_drain", op=5, times=1)],
    "pressure": [dict(site="pool_pressure", step=2, value=3, duration=3),
                 dict(site="pool_pressure", step=3, value=1)],
    "mixed": [dict(site="page_alloc", every=4, times=3),
              dict(site="page_grow", prob=0.2, times=2, step=5),
              dict(site="pool_pressure", step=4, value=2, duration=2),
              dict(site="swap_corrupt", op=1)],
}


def _probe(mod, specs, seed):
    """A fixed probe sequence: 12 steps, each polling the pressure and
    probing a seeded mix of sites; returns every answer and the plan."""
    plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs], seed=seed)
    rng = np.random.default_rng(99)
    answers = []
    for step in range(1, 13):
        plan.begin_step(step)
        answers.append(("pressure", plan.pressure_pages(),
                        plan.pressure_active()))
        for site in rng.choice(mod.SITES, size=9):
            answers.append((str(site), plan.fires(str(site))))
    return answers, plan


@pytest.mark.parametrize("kind", list(SPECS))
def test_plan_fires_like_reference(kind):
    for seed in (0, 3):
        ta, tp = _probe(TF, SPECS[kind], seed)
        ja, jp = _probe(JF, SPECS[kind], seed)
        assert ta == ja
        assert tp.log == jp.log and tp.injected == jp.injected
        assert tp.pressure_hits == jp.pressure_hits
        assert tp.total_injected == jp.total_injected
        if kind == "pressure":
            assert tp.pressure_hits > 0
        else:
            assert tp.total_injected > 0


def test_corrupt_host_image_flips_a_copy():
    g = torch.Generator().manual_seed(0)
    rows = {"layers": [{"v": torch.randn(2, 4, generator=g),
                        "k": torch.randn(2, 4, generator=g)}
                       for _ in range(2)]}
    keep = {"layers": [{k: t.clone() for k, t in lr.items()}
                       for lr in rows["layers"]]}
    bad = TF.corrupt_host_image(rows)
    for lr, lk in zip(rows["layers"], keep["layers"]):
        for k in lr:
            assert torch.equal(lr[k], lk[k])           # input untouched
    flipped = bad["layers"][0]["k"]                    # first in name order
    assert (flipped.view(-1).view(torch.uint8)[0]
            == keep["layers"][0]["k"].view(-1).view(torch.uint8)[0] ^ 0xFF)
    assert torch.equal(flipped.view(-1)[1:],
                       keep["layers"][0]["k"].view(-1)[1:])
    assert bad["layers"][0]["v"] is rows["layers"][0]["v"]
    assert bad["layers"][1] is rows["layers"][1]


# ---------------------------------------------------------------- engines --
@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("codellama-7b", smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    return jcfg, jp, get_config("codellama-7b", smoke=True).with_(
        dtype="float32"), tp


def _requests(mod, vocab, n=6, max_tokens=8, seed=5):
    """The reference's fault workload: prompts of 7-14 tokens behind a
    shared one-page stem, so the cache hits and ``prefix_evict`` has
    matches to fire on."""
    rng = np.random.default_rng(seed)
    lens = (3, 7, 10, 5)
    stem = rng.integers(2, vocab, 4).astype(np.int32)
    return [mod.Request(uid=i, prompt=np.concatenate(
                [stem, rng.integers(2, vocab, lens[i % 4]).astype(np.int32)]),
                max_tokens=max_tokens) for i in range(n)]


FAULTS = {JE: JF, TE: TF}


def _drive(mod, params, cfg, specs, seed, **kw):
    F = FAULTS[mod]
    plan = F.FaultPlan([F.FaultSpec(**dataclasses.asdict(s)) for s in specs],
                       seed=seed)
    defaults = dict(batch_size=3, max_seq=24, page_size=4, num_pages=1 + 7,
                    max_prefill_tokens=8, prefix_cache=True)
    defaults.update(kw)
    extra = dict(backend="xla") if mod is JE else dict(device="cpu")
    eng = mod.ServingEngine(params, cfg, fault_plan=plan, **defaults,
                            **extra)
    reqs = _requests(mod, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=600)
    return eng, reqs, plan


def _assert_same(models, specs, seed=1, **kw):
    jcfg, jp, tcfg, tp = models
    jeng, jreqs, jplan = _drive(JE, jp, jcfg, specs, seed, **kw)
    teng, treqs, tplan = _drive(TE, tp, tcfg, specs, seed, **kw)
    assert tplan.log == jplan.log
    assert tplan.injected == jplan.injected
    assert tplan.pressure_hits == jplan.pressure_hits
    ctr = "faults_fired_total"
    assert teng.metrics.counter(ctr).snapshot() == \
        jeng.metrics.counter(ctr).snapshot()
    assert teng.metrics.counter(ctr).total() == tplan.total_injected
    assert [(r.uid, r.finish_reason, r.retries, r.reprefills, r.output)
            for r in treqs] == \
        [(r.uid, r.finish_reason, r.retries, r.reprefills, r.output)
         for r in jreqs]
    for f in STATS:
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    teng.pager.check_invariants()
    assert not teng._swapped
    assert teng.pager.free_pages + teng.pager.evictable_pages() \
        == teng.pager.num_pages - 1
    return teng, treqs, tplan


@pytest.mark.parametrize("spec", [
    TF.FaultSpec("page_alloc", every=3, times=4),
    TF.FaultSpec("page_grow", op=1, times=2),
    TF.FaultSpec("pool_pressure", step=2, value=2, duration=2),
    TF.FaultSpec("swap_drain", op=0, times=2),
    TF.FaultSpec("swap_corrupt", op=0, times=1),
    TF.FaultSpec("prefix_evict", op=0, times=2),
    TF.FaultSpec("decode_launch", step=3, times=2),
    TF.FaultSpec("prefill_launch", op=1, times=1),
], ids=lambda s: s.site)
def test_site_alone_matches_jax_engine(models, spec):
    teng, treqs, plan = _assert_same(models, [spec])
    if spec.site == "pool_pressure":
        assert plan.pressure_hits > 0
    else:
        assert plan.injected[spec.site] > 0, f"{spec.site} never fired"
    assert all(r.finish_reason in ("completed", "length") for r in treqs)
    if spec.site == "swap_corrupt":
        assert sum(r.reprefills for r in treqs) == 1


def test_serve_chaos_plan_matches_jax_engine(models):
    """serve's ``--chaos`` plan (the JAX CLI's, spec for spec), non-strict,
    on the tight pool with the prefix cache on."""
    plan = serve.chaos_plan(0)
    assert [dataclasses.asdict(s) for s in plan.specs] == [
        dataclasses.asdict(JF.FaultSpec(**kw)) for kw in (
            dict(site="page_alloc", every=11, times=3),
            dict(site="page_grow", prob=0.05, times=3),
            dict(site="pool_pressure", step=4, value=2, duration=3),
            dict(site="swap_drain", op=0, times=1),
            dict(site="swap_corrupt", op=1, times=1),
            dict(site="prefix_evict", every=5, times=2),
            dict(site="decode_launch", step=6, times=2),
            dict(site="prefill_launch", op=2, times=1),
            dict(site="fixed_drain", op=0, times=1),
            dict(site="enc_evict", op=1, times=1))]
    teng, treqs, tplan = _assert_same(models, plan.specs, seed=0,
                                      strict=False)
    assert tplan.total_injected >= 5
    assert teng.stats.faults_injected == tplan.total_injected
    assert all(r.finish_reason in TE.FINISH_REASONS for r in treqs)


def test_grow_retry_exhaustion_fails_like_jax_engine(models):
    """Op 0 is the admission grow; every decode growth after it faults, so
    the request fails on its budget (2) after three charged retries."""
    jcfg, jp, tcfg, tp = models
    out = []
    for mod, params, cfg in ((JE, jp, jcfg), (TE, tp, tcfg)):
        F = FAULTS[mod]
        plan = F.FaultPlan([F.FaultSpec("page_grow", op=i, times=1)
                            for i in range(1, 9)])
        extra = dict(backend="xla") if mod is JE else dict(device="cpu")
        eng = mod.ServingEngine(params, cfg, batch_size=1, max_seq=32,
                                page_size=4, fault_plan=plan, retry_budget=2,
                                **extra)
        r = mod.Request(uid=5, prompt=np.arange(2, 6, dtype=np.int32),
                        max_tokens=20)
        eng.submit(r)
        st = eng.run_until_drained(max_steps=100)
        out.append((r.finish_reason, r.retries, r.output, st.retries,
                    st.failed, plan.log, eng.pager.free_pages))
        eng.pager.check_invariants()
    assert out[0] == out[1]
    assert out[1][0] == "failed" and out[1][1] == 3
