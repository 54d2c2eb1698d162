"""Port parity: K1's plain version (repro_torch W4A16) vs the JAX Pallas
kernel in interpret mode and its oracle ``ref.w4a16_matmul_ref``.

Tolerances: f32 rtol 1e-5 (atol 1e-5 for near-zero outputs) — the sums run
in another order; bf16 outputs are compared at one bf16 ulp of the output
magnitude (rtol/atol 1e-2), since a 1e-7 f32 difference can flip the final
bf16 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as JQ
from repro.kernels import ref as JREF
from repro.kernels.w4a16_matmul import w4a16_matmul as pallas_w4a16
from repro_torch.core import quantize as TQ
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import w4a16_matmul as TW4

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}


def _case(t, ci, co, group, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, ci)).astype(np.float32)
    w = (rng.standard_normal((ci, co)) * ci ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,ci,co,group", [
    (1, 128, 96, 32), (3, 256, 48, 16), (21, 128, 96, 128)])
def test_plain_matches_pallas_interpret_and_oracle(t, ci, co, group, dtype):
    x, w = _case(t, ci, co, group, seed=t * 7 + co)
    jqt = JQ.quantize(jnp.asarray(w), group_size=group,
                      dtype=getattr(jnp, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    y_pallas = pallas_w4a16(jx, jqt, interpret=True, block_co=32)
    y_oracle = JREF.w4a16_matmul_ref(jx, jqt)

    tqt = TQ.quantize(torch.from_numpy(w), group_size=group,
                      dtype=getattr(torch, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y = TW4.w4a16_matmul_plain(tx, tqt)
    assert y.dtype == tx.dtype and tuple(y.shape) == (t, co)
    # the dispatcher routes CPU tensors to the plain version
    assert torch.equal(TOPS.w4a16_matmul(tx, tqt), y)
    rtol, atol = TOL[dtype]
    y_np = y.to(torch.float32).numpy()
    for ref in (y_pallas, y_oracle):
        np.testing.assert_allclose(y_np, np.asarray(ref, np.float32),
                                   rtol=rtol, atol=atol)


def test_batched_leading_dims_and_a8_gate():
    x, w = _case(6, 128, 48, 32, seed=1)
    tqt = TQ.quantize(torch.from_numpy(w), group_size=32)
    tx = torch.from_numpy(x).reshape(2, 3, 128)
    y = TOPS.w4a16_matmul(tx, tqt)
    assert tuple(y.shape) == (2, 3, 48)
    np.testing.assert_allclose(
        y.reshape(6, 48).numpy(),
        TW4.w4a16_matmul_plain(torch.from_numpy(x), tqt).numpy(), rtol=1e-6,
        atol=1e-6)
    # decode-sized A8 requests stay A16; prefill-sized ones take B5's
    # function (per-token int8 activations)
    assert torch.equal(TOPS.w4a16_matmul(tx, tqt, act="a8"), y)
    big = torch.from_numpy(np.tile(x, (3, 1)))[:TOPS.A8_MIN_TOKENS]
    assert torch.equal(TOPS.w4a16_matmul(big, tqt, act="a8"),
                       TW4.w4a8_matmul_plain(big, tqt))
    assert not torch.equal(TOPS.w4a16_matmul(big, tqt, act="a8"),
                           TW4.w4a16_matmul_plain(big, tqt))


def test_cuda_wrapper_refuses_cpu_tensors():
    x, w = _case(2, 128, 48, 32, seed=2)
    tqt = TQ.quantize(torch.from_numpy(w), group_size=32)
    with pytest.raises(ValueError, match="CUDA"):
        TW4.w4a16_matmul_cuda(torch.from_numpy(x), tqt)
