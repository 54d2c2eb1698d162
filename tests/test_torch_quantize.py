"""Port parity: group-wise int4 quantization (repro_torch.core.quantize) vs
the JAX reference (repro.core.quantize), on the same numpy inputs.

Codes, packed bytes, scales and zeros must be *equal* (both round half to
even); dequantize / fake_quantize are elementwise f32 arithmetic in the same
order and must be equal too (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as JQ
from repro_torch.core import quantize as TQ


def _weight(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    # an outlier row and a constant group exercise the scale edge cases
    w[..., 3, :] *= 20.0
    w[..., -8:, 0] = 0.5
    return w


SHAPES = [(128, 96), (256, 48), (3, 128, 40)]


@pytest.mark.parametrize("group", [16, 32, 128])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_reference(shape, group):
    w = _weight(shape, seed=group + len(shape))
    jq = JQ.quantize(jnp.asarray(w), group_size=group)
    tq = TQ.quantize(torch.from_numpy(w), group_size=group)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.zeros.numpy(), np.asarray(jq.zeros))
    assert tq.shape == tuple(jq.shape) and tq.group_size == jq.group_size
    np.testing.assert_array_equal(
        TQ.dequantize(tq).numpy(), np.asarray(JQ.dequantize(jq)))
    np.testing.assert_array_equal(
        TQ.fake_quantize(torch.from_numpy(w), group).numpy(),
        np.asarray(JQ.fake_quantize(jnp.asarray(w), group)))


@pytest.mark.parametrize("group", [16, 128])
def test_pack_unpack_roundtrip_and_layout(group):
    rng = np.random.default_rng(group)
    q = rng.integers(0, 16, size=(2 * group, 24)).astype(np.uint8)
    packed = TQ.pack_codes(torch.from_numpy(q), group)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JQ.pack_codes(jnp.asarray(q),
                                                           group)))
    # group-split: low nibble = row r, high nibble = row r + G/2 of a group
    h = group // 2
    assert int(packed[1, 5]) == int(q[1, 5]) | (int(q[h + 1, 5]) << 4)
    np.testing.assert_array_equal(TQ.unpack_codes(packed, group).numpy(), q)


def test_stacked_getitem_slices_all_arrays():
    w = _weight((3, 128, 40), seed=0)
    tq = TQ.quantize(torch.from_numpy(w), group_size=32)
    one = tq[1]
    ref = TQ.quantize(torch.from_numpy(w[1]), group_size=32)
    for a, b in ((one.packed, ref.packed), (one.scales, ref.scales),
                 (one.zeros, ref.zeros)):
        assert torch.equal(a, b)
    with pytest.raises(IndexError):
        ref[0]
