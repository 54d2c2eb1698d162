"""Port parity for the grouped expert GEMMs B6 (W4A16) and B7 (W4A8): their
plain versions against the JAX package's oracles ``ref.w4a16_grouped_ref``
and ``ref.w4a8_grouped_ref`` on the same stacked weights (quantized by the
JAX package, carried over with ``models/convert.py``), and the
``kernels.ops`` gate.

Tolerance: 1e-5·max(1, |ref|) in f32 (sums in another order; B7's integer
group sums are exact in both).  Capacity rows no token was dispatched to
are zero rows and must give exact zero output rows.  B7 is held against the
oracle, not against the JAX package's Pallas A8 kernel in interpret mode,
which is off from the oracle at ``(3, 21, 96, 48, 48)`` (ROADMAP.md queue
C).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels import ref as jref
from repro_torch.core.quantize import QuantizedTensor, quantize
from repro_torch.kernels import ops
from repro_torch.kernels import w4a16_grouped as G
from repro_torch.models import convert

CASES = [(1, 8, 128, 128, 128), (8, 16, 128, 128, 128), (8, 24, 256, 128, 64),
         (3, 21, 96, 48, 48), (4, 40, 64, 96, 32)]


def _mk(e, c, d, f, g, seed=0, filled=None):
    """numpy x[E, C, D] (rows past ``filled[e]`` zero) and a stacked weight
    quantized by the JAX package → (x numpy, JAX qt, port qt)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    if filled is not None:
        x[np.arange(c)[None, :] >= np.asarray(filled)[:, None]] = 0.0
    w = rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5
    jqt = jq.quantize(jnp.asarray(w), group_size=g)
    tqt = convert._convert(jqt, "cpu")
    return x, jqt, tqt


def _close(got, want):
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("e,c,d,f,g", CASES)
def test_b6_plain_matches_oracle(e, c, d, f, g):
    x, jqt, tqt = _mk(e, c, d, f, g)
    _close(G.w4a16_grouped_plain(torch.from_numpy(x), tqt),
           jref.w4a16_grouped_ref(jnp.asarray(x), jqt))


@pytest.mark.parametrize("e,c,d,f,g", CASES)
def test_b7_plain_matches_oracle(e, c, d, f, g):
    x, jqt, tqt = _mk(e, c, d, f, g, seed=1)
    _close(G.w4a8_grouped_plain(torch.from_numpy(x), tqt),
           jref.w4a8_grouped_ref(jnp.asarray(x), jqt))


@pytest.mark.parametrize("a8", [False, True])
def test_ragged_capacity_rows_are_zero(a8):
    """Zero capacity rows give exact zero output rows, whatever the
    zero-points; the ragged (3, 21, 96, 48, 48) A8 case included."""
    filled = [21, 5, 0]
    x, jqt, tqt = _mk(3, 21, 96, 48, 48, seed=3, filled=filled)
    fn, oracle = ((G.w4a8_grouped_plain, jref.w4a8_grouped_ref) if a8
                  else (G.w4a16_grouped_plain, jref.w4a16_grouped_ref))
    got = fn(torch.from_numpy(x), tqt)
    _close(got, oracle(jnp.asarray(x), jqt))
    for e, n in enumerate(filled):
        assert bool((got[e, n:] == 0).all())


def test_stacked_quantize_bit_identical():
    """The port's stacked [E, Ci, Co] quantization gives the reference's
    bytes exactly."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((3, 128, 64)).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(w), group_size=64)
    tqt = quantize(torch.from_numpy(w), group_size=64)
    assert tqt.shape == (3, 128, 64) and tqt.group_size == 64
    np.testing.assert_array_equal(tqt.packed.numpy(), np.asarray(jqt.packed))
    np.testing.assert_array_equal(tqt.scales.numpy(), np.asarray(jqt.scales))
    np.testing.assert_array_equal(tqt.zeros.numpy(), np.asarray(jqt.zeros))
    for e in range(3):
        one = quantize(torch.from_numpy(w[e]), group_size=64)
        assert torch.equal(tqt[e].packed, one.packed)


@pytest.mark.parametrize("c,flag,want_a8", [(8, True, False),
                                            (16, True, True),
                                            (16, False, False)])
def test_ops_gate_uses_per_expert_rows(c, flag, want_a8):
    """``act="a8"`` takes B7 only when the stack's ``a8`` flag is set and
    the per-expert row count C reaches 16 (decode's capacity stays A16)."""
    x, _, tqt = _mk(4, c, 64, 32, 32, seed=5)
    tqt = QuantizedTensor(tqt.packed, tqt.scales, tqt.zeros, a8=flag)
    xt = torch.from_numpy(x)
    got = ops.w4a16_grouped_matmul(xt, tqt, act="a8")
    want = (G.w4a8_grouped_plain if want_a8 else G.w4a16_grouped_plain)(
        xt, tqt)
    assert torch.equal(got, want)
    assert torch.equal(ops.w4a16_grouped_matmul(xt, tqt),
                       G.w4a16_grouped_plain(xt, tqt))


def test_ops_rejects_2d_weight():
    qt = quantize(torch.randn(64, 32), group_size=32)
    with pytest.raises(ValueError, match="stacked"):
        ops.w4a16_grouped_matmul(torch.randn(2, 8, 64), qt)
