"""The engine's host phases and spans (``serving/trace.py:span``), on the
CPU with a counting engine clock, for a dense config on a tight pool
(preemption and swap-in) and the Granite MoE with the prefix cache (a
copy-on-write):

- the phases' self seconds sum exactly to the steps' wall time, and the
  phase counts follow the engine's own counters;
- every ``sync.<site>`` is counted once each time the run passes it, and
  no other site is;
- under ``torch.profiler`` the spans are exported as ``user_annotation``
  events, nested as the engine nests them (``model.attn`` inside
  ``engine.prefill.launch`` inside ``engine.prefill``);
- with no profiler running no span opens a ``record_function``;
- a profiler changes no token and no other ``EngineStats`` field.
"""
import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.serving import engine as TE
from repro_torch.serving import trace as TT

# name → (arch, engine kwargs, prompt lengths, max_tokens, repeats: the
# prompt at index i is the one at index j)
CASES = {
    # 7 pages of 4 tokens for 3 slots: the pool preempts and swaps back in
    "dense": ("codellama-7b",
              dict(batch_size=3, max_seq=24, page_size=4, num_pages=1 + 7,
                   max_prefill_tokens=8), (3, 7, 10, 5, 9, 6), 8, {}),
    # the third prompt repeats the first, whole pages: its last full page
    # is copied on write
    "moe": ("granite-moe-1b-a400m",
            dict(batch_size=2, max_seq=32, page_size=4, prefix_cache=True),
            (8, 11, 8), 5, {2: 0}),
}


class Run:
    """One drained engine: its requests, its stats, the clock's readings
    by step and the ``record_function`` calls it made."""


def _serve(arch, kw, lens, max_tokens, repeats, profile=None):
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    params = api.init_model(cfg, seed=0, device="cpu")
    eng = TE.ServingEngine(params, cfg, device="cpu", seed=3, **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    for i, j in repeats.items():
        prompts[i] = prompts[j]
    run = Run()
    run.reqs = [TE.Request(uid=i, prompt=p, max_tokens=max_tokens)
                for i, p in enumerate(prompts)]
    for r in run.reqs:
        eng.submit(r)
    # a clock that advances by one at every reading: each phase's self
    # time is a whole number of readings, summed exactly
    readings = []

    def clock():
        readings.append(float(len(readings) + 1))
        return readings[-1]

    eng._clock = clock
    run.walls, run.samples, run.cows = [], [0], [0]
    sample, copy_page = eng._sample, api.copy_pool_page

    def counted_sample(logits, reqs):
        run.samples[0] += 1
        return sample(logits, reqs)

    def counted_copy(*a, **k):
        run.cows[0] += 1
        return copy_page(*a, **k)

    eng._sample = counted_sample
    opened = [0]
    real_rf = torch.profiler.record_function

    def counted_rf(*a, **k):
        opened[0] += 1
        return real_rf(*a, **k)

    with mock.patch.object(api, "copy_pool_page", counted_copy), \
            mock.patch.object(torch.profiler, "record_function", counted_rf):
        prof = None
        if profile is not None:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            prof.start()
        while eng.queue or any(s is not None for s in eng.slots):
            i = len(readings)
            eng.step()
            run.walls.append(readings[-1] - readings[i])
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(str(profile))
    run.eng, run.stats, run.opened = eng, eng.stats, opened[0]
    return run


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    """The case served with no profiler and again under one (its Chrome
    trace exported)."""
    case = CASES[request.param]
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    off = _serve(*case)
    on = _serve(*case, profile=path)
    events = json.loads(path.read_text())["traceEvents"]
    on.spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("cat") == "user_annotation"]
    return request.param, off, on


def test_self_times_tile_the_steps(runs):
    _, off, _ = runs
    hs, hn = off.stats.host_s, off.stats.host_n
    assert sum(hs.values()) == sum(off.walls) > 0
    assert hn["step"] == len(off.walls)
    assert min(hs.values()) >= 0
    # only small gaps between the phases fall to step's own time
    assert hs["step"] < 0.5 * sum(off.walls)


def test_phase_counts_follow_the_engine(runs):
    name, off, _ = runs
    st, hn = off.stats, off.stats.host_n
    assert hn["prefill.launch"] == hn["prefill.stage"] == \
        st.prefill_batches > 0
    assert hn["decode.launch"] == hn["decode.stage"] == hn["sample"] == \
        hn["emit"] == st.steps > 0
    assert hn["sample"] + hn["prefill.sample"] == off.samples[0]
    for phase in ("admit", "grow", "prefill", "drain", "observe"):
        assert hn[phase] == hn["step"], phase
    if name == "dense":
        assert st.preemptions > 0 and st.resumes > 0
    else:
        assert st.cow_copies > 0 and hn["prefill.cache"] > 0


def test_sync_sites_counted_where_passed(runs):
    name, off, _ = runs
    st = off.stats
    want = {f"sync.prefill.{k}": st.prefill_batches
            for k in ("tokens", "table", "starts", "lens", "last_idx")}
    want.update({f"sync.sample.{k}": off.samples[0]
                 for k in ("temps", "any", "cpu")})
    # on the CPU the swap-out copy needs no event and the decode step no
    # graph, so sync.drain.copied and sync.decode.copied are never passed
    want.update({"sync.preempt.pages": st.preemptions,
                 "sync.resume.pages": st.resumes,
                 "sync.cow.src": off.cows[0], "sync.cow.dst": off.cows[0]})
    want = {k: v for k, v in want.items() if v}
    got = {k: v for k, v in st.host_n.items() if k.startswith("sync.")}
    assert got == want
    assert set(st.host_s) == set(st.host_n)


def _inside(inner, outer):
    return outer[1] - 1e-3 <= inner[1] and inner[2] <= outer[2] + 1e-3


def test_spans_exported_and_nested(runs):
    name, _, on = runs
    by = {}
    for s in on.spans:
        by.setdefault(s[0], []).append(s)
    phases = {"engine." + k for k in on.stats.host_n if not
              k.startswith("sync.")}
    syncs = {k for k in on.stats.host_n if k.startswith("sync.")}
    model = {"model.embed", "model.attn", "model.ffn", "model.head"}
    if name == "moe":
        model.add("model.moe.dispatch")
    assert phases | syncs | model <= set(by)
    assert len(by["engine.step"]) == on.stats.host_n["step"]
    for launch in by["engine.prefill.launch"]:
        assert any(_inside(launch, p) for p in by["engine.prefill"])
    for s in by["model.attn"] + by["model.ffn"] + by["model.head"]:
        assert any(_inside(s, p) for p in by["engine.prefill.launch"])
    # the decode step (a graph on a card) runs the MoE with no ffn span
    for s in by.get("model.moe.dispatch", []):
        assert any(_inside(s, p) for p in by["model.ffn"]
                   + by["engine.decode.launch"])
    for s in by["sync.sample.any"]:
        assert any(_inside(s, p) for p in by["engine.sample"]
                   + by["engine.prefill.sample"])


def test_no_record_function_without_profiler(runs):
    _, off, on = runs
    assert off.opened == 0
    assert on.opened == len(on.spans) > 0


def test_profiler_changes_no_token_and_no_counter(runs):
    _, off, on = runs
    assert [r.output for r in on.reqs] == [r.output for r in off.reqs]
    assert all(r.finish_reason == "length" for r in off.reqs)
    a, b = dataclasses.asdict(off.stats), dataclasses.asdict(on.stats)
    for d in (a, b):
        d.pop("host_s")
        d["host_n"] = set(d["host_n"])
    assert a == b


class _Stats:
    def __init__(self):
        self.host_s, self.host_n = {}, {}


@pytest.mark.parametrize("nested", ["counted", "enclosing", "span_only"])
def test_span_self_time(nested):
    """An outer counted span's self time excludes a counted span nested
    in it (given its stats or ENCLOSING), not a span with no counter."""
    st, t = _Stats(), [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    inner = {"counted": dict(into=st, clock=clock),
             "enclosing": dict(into=TT.ENCLOSING),
             "span_only": {}}[nested]
    with TT.span("outer", st, clock):
        with TT.span("inner", **inner):
            clock()
    total = 5.0 if nested != "span_only" else 3.0
    assert sum(st.host_s.values()) == total - 1.0
    if nested == "span_only":
        assert st.host_s == {"outer": 2.0} and st.host_n == {"outer": 1}
    else:
        assert st.host_s == {"outer": 2.0, "inner": 2.0}
        assert st.host_n == {"outer": 1, "inner": 1}
    # ENCLOSING outside every counted span counts nothing
    with TT.span("alone", TT.ENCLOSING):
        pass
    assert "alone" not in st.host_n
