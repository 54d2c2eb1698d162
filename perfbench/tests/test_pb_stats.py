"""The exact tails: nearest-rank percentiles, and TPOT with unfinished
requests counted as the harness defines them."""
import pytest

from perfbench.harness.stats import Rec, percentile, tpot, tpots


def rec(**k):
    base = dict(uid=0, prompt_len=10, max_tokens=5, due=1.0, submit_t=1.0)
    base.update(k)
    return Rec(**base)


def test_percentile_nearest_rank():
    assert percentile(list(range(1, 11)), 0.9) == 9
    assert percentile(list(range(1, 21)), 0.9) == 18
    assert percentile(list(range(1, 101)), 0.9) == 90
    assert percentile([5.0], 0.9) == 5.0
    assert percentile([3, 1, 2], 0.5) == 2
    with pytest.raises(ValueError):
        percentile([], 0.9)


def test_tpot():
    t_end = 10.0
    done = rec(first_t=1.0, done_t=3.0, n_out=5, finish="length")
    assert tpot(done, t_end) == pytest.approx(0.5)
    # still decoding at the window's end: counts up to the end
    live = rec(first_t=6.0, n_out=9)
    assert tpot(live, t_end) == pytest.approx(0.5)
    assert tpot(rec(first_t=6.0, n_out=1), t_end) is None
    assert tpot(rec(n_out=0), t_end) is None
    assert tpot(rec(first_t=11.0, n_out=3), t_end) is None
    assert tpots([done, live, rec(n_out=0)], t_end) == \
        pytest.approx([0.5, 0.5])


def test_tpot_p90_counts_every_request_decoding_in_the_window():
    from perfbench.harness.bench import _e2e

    t0, t1 = 10.0, 20.0
    ended = [rec(uid=i, first_t=8.0, done_t=12.0, n_out=41, finish="length")
             for i in range(4)]                      # 0.1 s a token
    live = rec(uid=98, first_t=18.0, n_out=3)        # (20 - 18) / 2
    before = rec(uid=97, first_t=1.0, done_t=9.0, n_out=3, finish="length")
    v = _e2e("tpot_p90_ms", ended + [live, before], t0, t1, 0, 0.0)
    # nearest rank of 5: the largest, the request still decoding; the one
    # that ended before the window opened is not counted
    assert v == pytest.approx(1000.0)
    assert _e2e("tpot_p90_ms", ended + [before], t0, t1, 0, 0.0) == \
        pytest.approx(100.0)
