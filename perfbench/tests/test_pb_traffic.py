"""The generator's schedule: repeatable by seed, the same sample of the
mix's distributions for every seed, in another order."""
import math
import statistics

import numpy as np
import pytest

from perfbench.harness import cell as C
from perfbench.harness import traffic

MIX = {"loop": "backlog", "block": 64, "max_total": 2048,
       "prompt_len": {"dist": "lognormal", "median": 300, "sigma": 0.8,
                      "min": 16, "max": 1900},
       "output_len": {"dist": "lognormal", "mean": 200, "sigma": 1.0,
                      "min": 2, "max": 1000}}
SEED = 2 ** 31 + 12345


def take(seed, n, mix=MIX, vocab=1000):
    it = traffic.stream(mix, seed, vocab)
    return [next(it) for _ in range(n)]


def test_repeatable_by_seed():
    a, b, c = take(SEED, 200), take(SEED, 200), take(SEED + 1, 200)
    assert all(np.array_equal(x.prompt, y.prompt) and
               x.max_tokens == y.max_tokens for x, y in zip(a, b))
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in c]


def test_every_seed_serves_the_same_requests():
    for s1, s2 in ((SEED, SEED + 7), (3, 2 ** 33 + 1)):
        a, b = take(s1, 128), take(s2, 128)
        for blk in (slice(0, 64), slice(64, 128)):
            # the same (prompt, output) pairs in every block, in another
            # order
            pa = sorted((len(x.prompt), x.max_tokens) for x in a[blk])
            assert pa == sorted((len(x.prompt), x.max_tokens)
                                for x in b[blk])
            assert pa == sorted((len(x.prompt), x.max_tokens)
                                for x in a[slice(0, 64)])
        assert [len(x.prompt) for x in a[:64]] != \
            [len(x.prompt) for x in b[:64]]


def test_lognormal_quantiles():
    p, o = traffic.block(MIX)
    # the block's median is the distribution's: 300 for the prompts, and
    # for the outputs mean * exp(-sigma^2 / 2)
    assert abs(np.median(p) / 300 - 1) < 0.03
    assert abs(np.median(traffic.quantiles(MIX["output_len"], 64))
               / (200 * math.exp(-0.5)) - 1) < 0.03
    # sigma: the log lengths' spread between the quartiles is 1.349 sigma
    lp = np.log(np.sort(p).astype(float))
    iqr = lp[47] - lp[16]
    want = 0.8 * (statistics.NormalDist().inv_cdf(47.5 / 64)
                  - statistics.NormalDist().inv_cdf(16.5 / 64))
    assert abs(iqr - want) < 0.02
    assert p.min() >= 16 and p.max() <= 1900
    assert o.min() >= 2 and (p + o).max() <= 2048


def test_ids():
    ids = np.concatenate([x.prompt for x in take(SEED, 256)])
    assert ids.min() >= 2 and ids.max() < 1000 and ids.dtype == np.int32


@pytest.mark.parametrize("name", ["code-backlog", "chat-backlog"])
def test_the_cells_mixes_follow_their_sources(name):
    m = C.mix(name)
    p, o = traffic.block(m)
    assert (p + o).max() <= m["max_total"] <= m["engine"]["max_seq"]
    assert o.min() >= 2
    for spec, got in ((m["prompt_len"], p), (m["output_len"], o)):
        q = traffic.quantiles(spec, m["block"])
        if "median" in spec:          # the source's median, where clipping
            assert abs(np.median(q) / spec["median"] - 1) < 0.1
        else:                         # the source's mean, before clipping
            assert abs(q.mean() / spec["mean"] - 1) < 0.15


def test_unknown_distribution_is_refused():
    with pytest.raises(ValueError):
        traffic.quantiles({"dist": "uniform", "min": 1, "max": 2}, 4)
