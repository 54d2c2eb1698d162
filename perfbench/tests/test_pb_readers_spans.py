"""The readers of the engine's host phases and spans on synthetic records:
their arithmetic on known counters and spans, None where the program has
neither (the parent commit's engine, a trace without program spans), and
the prefill idle share against a hand-built gap list."""
import pytest

from perfbench.harness import cell as C
from perfbench.harness.profile import Trace
from perfbench.harness.readers import Record

NAMES = ("prefill_host_ms.tput", "step_host_ms.tput", "syncs_per_step.tput",
         "prefill_idle_pct.tput")


def reader(name):
    return C.reader(name)


def record(stats0, stats1, trace=None):
    return Record(config={}, mix={}, t0=0.0, t1=10.0, steps=[], requests=[],
                  stats0=stats0, stats1=stats1, trace=trace)


# the window opened after 2 steps and closed after 12
STATS0 = {"steps": 2, "host_s": {"step": 0.001, "prefill.launch": 0.5,
                                 "sync.sample.cpu": 0.2, "emit": 0.002},
          "host_n": {"step": 2, "prefill.launch": 1, "sync.sample.cpu": 2,
                     "emit": 2}}
STATS1 = {"steps": 12, "host_s": {"step": 0.011, "prefill.launch": 2.0,
                                  "prefill.stage": 0.03,
                                  "sync.sample.cpu": 1.2,
                                  "sync.prefill.tokens": 0.4, "emit": 0.022},
          "host_n": {"step": 12, "prefill.launch": 4, "prefill.stage": 3,
                     "sync.sample.cpu": 12, "sync.prefill.tokens": 3,
                     "emit": 12}}


def test_counter_readers_arithmetic():
    rec = record(STATS0, STATS1)
    # (2.0 - 0.5) s over 3 launches
    assert reader("prefill_host_ms.tput")(rec) == pytest.approx(500.0)
    # step 0.010 + prefill.stage 0.03 + emit 0.020 over 10 steps
    assert reader("step_host_ms.tput")(rec) == pytest.approx(6.0)
    # (12 - 2) + 3 syncs over 10 steps
    assert reader("syncs_per_step.tput")(rec) == pytest.approx(1.3)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_programs_phases(name):
    """The parent commit's engine has no host_s / host_n and no program
    spans: every reader returns None and raises nothing."""
    bare = {"steps": 2, "active_slot_steps": 10}
    tr = Trace(window_s=3.0, busy_s=1.0,
               kernels=[("k", 0.5, 1.5)],
               spans=[("serving.engine.ServingEngine.step", 0.0, 2.0),
                      ("models.api.prefill_chunk_fn", 0.1, 1.0)], t0=0.0)
    assert reader(name)(record(bare, dict(bare, steps=5), tr)) is None
    assert reader(name)(record(bare, dict(bare, steps=5), None)) is None


@pytest.mark.parametrize("name", NAMES[:3])
def test_none_without_steps_or_launches(name):
    same = record(STATS1, STATS1)
    assert reader(name)(same) is None


def test_prefill_idle_pct_against_hand_built_gaps():
    # slice [10, 20): kernels leave the gaps [10, 11), [12, 13), [14, 16),
    # [17, 20); engine.prefill is open over [10.5, 13.5) and [16.5, 18)
    kernels = [("a", 11.0, 12.0), ("b", 13.0, 14.0), ("c", 13.5, 13.8),
               ("d", 16.0, 17.0)]
    spans = [("engine.step", 10.0, 20.0), ("engine.prefill", 16.5, 18.0),
             ("engine.prefill", 10.5, 13.5),
             ("engine.prefill.launch", 11.0, 13.0),
             ("sync.prefill.tokens", 10.5, 11.0)]
    tr = Trace(window_s=10.0, busy_s=3.0, kernels=kernels, spans=spans,
               t0=10.0)
    # [10, 11) starts outside every prefill span, [12, 13) inside the
    # first, [14, 16) outside, [17, 20) inside the second: 1 + 3 of 10 s
    assert reader("prefill_idle_pct.tput")(record({}, {}, tr)) == \
        pytest.approx(40.0)
    # a gap starting exactly where a span ends is outside it
    tr.spans = [("engine.prefill", 10.0, 12.0)]
    assert reader("prefill_idle_pct.tput")(record({}, {}, tr)) == \
        pytest.approx(10.0)
