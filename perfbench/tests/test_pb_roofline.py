"""The roofline arithmetic of one decode step of each configuration,
against numbers worked out by hand from the published sizes."""
import json
from pathlib import Path

import pytest

from perfbench.roofline import count

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_starcoder2_decode_step():
    c = cfg("starcoder2-15b")
    rows, keys, L = 64, 700, 40
    work = count.Work(decode=[keys] * rows)
    d, f, v = 6144, 24576, 49152
    # (Ci, Co) of wq, wk, wv, wo, up, down
    lin = [(d, d), (d, 512), (d, 512), (d, d), (d, f), (f, d)]
    cico = sum(a * b for a, b in lin)
    assert cico == 383_778_816
    wbytes = cico / 2 + sum((a // 128) * b * 2 * 4 for a, b in lin)
    assert wbytes == 215_875_584
    act = rows * sum(a + b for a, b in lin) * 4
    kv_row = 2 * 4 * 128 * 4                         # K and V, 4 heads, f32
    attn_f = 4 * 48 * 128 * rows * keys
    attn_b = rows * keys * kv_row + 2 * rows * 48 * 128 * 4
    head_f = 2 * rows * d * v
    head_b = d * v * 4 + rows * (d + v) * 4
    flops = L * (2 * rows * cico + attn_f) + head_f
    byts = (L * (wbytes + act + attn_b + rows * kv_row) + rows * d * 4
            + head_b)
    got = count.step_cost(c, work)
    assert got.flops == pytest.approx(flops, rel=1e-12)
    assert got.bytes == pytest.approx(byts, rel=1e-12)
    # ~16.7 GB: bytes bound the step, at ~5 ms on the data sheet's 3.35 TB/s
    assert got.bound_s() == pytest.approx(byts / 3.35e12)
    w4 = count.w4_calls(c, work)
    assert len(w4) == 6 and all(n == L for _, n in w4)
    assert sum(x.bytes for x, _ in w4) == pytest.approx(wbytes + act)
    attn = count.attn_calls(c, work)
    assert attn[0][0].flops == attn_f and attn[0][0].bytes == attn_b


def test_granite_decode_step():
    c = cfg("granite-moe-1b-a400m")
    rows, keys, L = 128, 500, 24
    work = count.Work(decode=[keys] * rows)
    d, fe, e, k, v = 1024, 512, 32, 8, 49155
    lin = [(d, d), (d, 512), (d, 512), (d, d)]       # wq, wk, wv, wo
    exp = [(d, fe), (d, fe), (fe, d)]                # gate, up, down
    wb = lambda a, b: a * b / 2 + (a // 128) * b * 2 * 4   # noqa: E731
    live = e * (1 - (1 - k / e) ** rows)
    assert live == pytest.approx(32.0)
    n = rows * k                                     # routed token rows
    flops = L * (2 * rows * sum(a * b for a, b in lin)
                 + 2 * n * sum(a * b for a, b in exp)
                 + 2 * rows * d * e                  # the f32 router
                 + 4 * 16 * 64 * rows * keys) + 2 * rows * d * v
    kv_row = 2 * 8 * 64 * 4
    byts = (L * (sum(wb(a, b) for a, b in lin)
                 + rows * sum(a + b for a, b in lin) * 4
                 + live * sum(wb(a, b) for a, b in exp)
                 + n * sum(a + b for a, b in exp) * 4
                 + d * e * 4 + rows * (d + e) * 4
                 + rows * keys * kv_row + 2 * rows * 16 * 64 * 4
                 + rows * kv_row)
            + rows * d * 4 + d * v * 4 + rows * (d + v) * 4)
    got = count.step_cost(c, work)
    assert got.flops == pytest.approx(flops, rel=1e-12)
    assert got.bytes == pytest.approx(byts, rel=1e-12)


def test_prefill_bucket_and_weights_once():
    c = cfg("starcoder2-15b")
    # one bucket of two rows: 100 tokens behind 300 cached, 50 from 0
    work = count.Work(decode=[10, 20], chunks=[[(300, 100), (0, 50)]])
    (a, n), = [x for x in count.attn_calls(c, work)][1:]
    causal = 100 * 300 + 100 * 101 / 2 + 50 * 51 / 2
    assert a.flops == pytest.approx(4 * 48 * 128 * causal)
    # a step with a chunk and a decode reads each weight once
    both = count.step_cost(c, work)
    w_once = 40 * 215_875_584
    parts = count.step_cost(c, count.Work(decode=[10, 20])).bytes + \
        count.step_cost(c, count.Work(chunks=[[(300, 100), (0, 50)]])).bytes
    head = 6144 * 49152 * 4
    # the two halves each read the weights and the head; together once
    assert parts - both.bytes == pytest.approx(w_once + head)
    assert count.Work(chunks=[[(0, 5), (3, 4)]]).head_rows == 2
    assert count.Work(decode=[1]).rows == 1 and count.Work().rows == 0
    assert count.step_cost(c, count.Work()).flops == 0
