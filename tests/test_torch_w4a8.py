"""Port parity for W4A8 prefill on the CPU: the per-token int8 activation
quantizer, B5's plain version, the ops gate, and the PTQ eligibility pass,
each against the JAX package on the same numpy inputs.

Tolerances: activation codes identical and scales within 1 ulp (the same
f32 operations in the same order); the round-trip error rtol 1e-6;
``w4a8_matmul_plain`` vs ``ref.w4a8_matmul_ref`` rtol/atol 1e-5 in f32 (the
integer sums are exact in both, only the sum over groups runs in another
order), 1e-2 with bf16 activations (one bf16 ulp of the output); the
eligibility errors rtol 1e-5 (post-smoothing activations differ from the
reference's by f32 summation order only)."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import apply as JAP
from repro.core import calibration as JC
from repro.core import quantize as JQ
from repro.kernels import ref as JREF
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import apply as TAP
from repro_torch.core import calibration as TC
from repro_torch.core import quantize as TQ
from repro_torch.core import smoothing as TSM
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import w4a16_matmul as TW4
from repro_torch.models import convert

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}


@pytest.mark.parametrize("shape,scale", [((5, 96), 1.0), ((2, 3, 128), 30.0),
                                         ((7, 40), 1e-3)])
def test_act_quantizer_matches_jax(shape, scale):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0                 # an all-zero token
    x.reshape(-1, shape[-1])[-1, 3] *= 200.0          # an outlier channel
    jc, js = JQ.quantize_acts_per_token(jnp.asarray(x))
    tc, ts = TQ.quantize_acts_per_token(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and tuple(ts.shape) == (*shape[:-1], 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    err = float(TQ.a8_roundtrip_error(torch.from_numpy(x)))
    np.testing.assert_allclose(err, float(JQ.a8_roundtrip_error(
        jnp.asarray(x))), rtol=1e-6)


def _qt_pair(ci, co, g, seed, clip_group=None):
    """The same int4 weight as a JAX and a port QuantizedTensor; with
    ``clip_group``, that group's zeros are pushed out of the int8 fold range
    on some columns (the fold's clip to [-128, 127] then decides)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((ci, co)) * ci ** -0.5).astype(np.float32)
    tqt = TQ.quantize(torch.from_numpy(w), group_size=g)
    zeros = tqt.zeros.clone()
    if clip_group is not None:
        zeros[clip_group, 0:3] = torch.tensor([140.0, 130.0, -150.0])
        zeros[clip_group, 3:5] = torch.tensor([-114.0, 128.0])
    tqt = dataclasses.replace(tqt, zeros=zeros)
    jqt = JQ.QuantizedTensor(packed=jnp.asarray(tqt.packed.numpy()),
                             scales=jnp.asarray(tqt.scales.numpy()),
                             zeros=jnp.asarray(zeros.numpy()))
    return jqt, tqt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,ci,co,g,clip", [
    (16, 128, 128, 128, None), (33, 96, 112, 16, 1), (17, 48, 40, 48, 0),
    (64, 256, 72, 64, 3), (5, 64, 24, 8, None)])
def test_w4a8_plain_matches_exact_oracle(t, ci, co, g, clip, dtype):
    jqt, tqt = _qt_pair(ci, co, g, seed=t + co, clip_group=clip)
    x = np.random.default_rng(t).standard_normal((t, ci)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JREF.w4a8_matmul_ref(jx, jqt)
    got = TW4.w4a8_matmul_plain(tx, tqt)
    assert got.dtype == tx.dtype and tuple(got.shape) == (t, co)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)
    if clip is not None:       # the clip really changes the folded codes
        folded = TW4._folded_int_codes(tqt)[clip, :, :5]
        assert float(folded.min()) == -128.0 and float(folded.max()) == 127.0


def test_resolve_act_gating():
    _, tqt = _qt_pair(128, 48, 32, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (TOPS.A8_MIN_TOKENS, 128)).astype(np.float32))
    a16 = TW4.w4a16_matmul_plain(x, tqt)
    # below the token gate: bit-identical to A16
    small = x[:TOPS.A8_MIN_TOKENS - 1].reshape(3, 5, 128)
    assert torch.equal(TOPS.w4a16_matmul(small, tqt, act="a8"),
                       TOPS.w4a16_matmul(small, tqt))
    # an ineligible weight: bit-identical to A16 at any size
    off = dataclasses.replace(tqt, a8=False)
    assert torch.equal(TOPS.w4a16_matmul(x, off, act="a8"), a16)
    assert TOPS._resolve_act("a8", off, 10 ** 6) == "a16"
    # eligible and large enough: B5's function
    assert TOPS._resolve_act("a8", tqt, TOPS.A8_MIN_TOKENS) == "a8"
    assert torch.equal(TOPS.w4a16_matmul(x, tqt, act="a8"),
                       TW4.w4a8_matmul_plain(x, tqt))
    with pytest.raises(ValueError, match="act"):
        TOPS.w4a16_matmul(x, tqt, act="a4")
    # the flag survives indexing and map
    stacked = TQ.QuantizedTensor(tqt.packed[None], tqt.scales[None],
                                 tqt.zeros[None], a8=False)
    assert stacked[0].a8 is False and stacked.map(torch.clone).a8 is False


@pytest.fixture(scope="module")
def outlier_ptq():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks.common import outlier_model

    jcfg, jp = outlier_model("codellama-7b")
    np_params = jax.tree.map(np.asarray, jp)
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, jrep = JAP.smoothquant_plus(jp, jcfg, batches,
                                    JQuantConfig(group_size=16, alpha=0.5))
    return jcfg, np_params, jq, jrep


def test_smoothquant_plus_a8_eligibility_matches_jax(outlier_ptq):
    _, np_params, jq, jrep = outlier_ptq
    tcfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    qcfg = QuantConfig(group_size=16, alpha=0.5)
    tb = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    tq, trep = TAP.smoothquant_plus(convert.from_reference(np_params), tcfg,
                                    tb, qcfg)
    flags = trep.a8_eligibility
    assert flags == jrep.a8_eligibility
    assert any(flags.values()) and not all(flags.values()), flags
    assert set(trep.a8_errors) == set(jrep.a8_errors)
    for key, err in jrep.a8_errors.items():
        np.testing.assert_allclose(trep.a8_errors[key], err, rtol=1e-5)
        assert flags[key] == (trep.a8_errors[key] <= qcfg.a8_threshold)
    # the flag is stamped on the path in every layer, and converting the
    # reference's quantized tree keeps its (per-stack) flags
    tconv = convert.from_reference(jax.tree.map(np.asarray, jq))
    for tree in (tq, tconv):
        for wp in TAP.quantizable_paths(tcfg):
            key = "layers/" + "/".join(wp)
            assert [TSM.tget(lp, wp).a8 for lp in tree["layers"]] \
                == [flags[key]] * tcfg.num_layers


def test_w4a8_cuda_wrapper_refuses_cpu_tensors():
    _, tqt = _qt_pair(128, 48, 32, seed=5)
    with pytest.raises(ValueError, match="CUDA"):
        TW4.w4a8_matmul_cuda(torch.zeros(TOPS.A8_MIN_TOKENS, 128), tqt)
