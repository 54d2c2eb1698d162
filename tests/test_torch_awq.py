"""Port parity for the AWQ baseline (``repro_torch/core/awq.py``) on the f32
codellama and granite smoke configs: the mean |x| calibration statistic
(rtol 1e-5: f32 summation order), ``quantization_loss`` (rtol 1e-5), and
``awq_quantize`` at G=16, step 0.25: the α of every group equal to the
reference's, int4 codes equal except where a rounding tie lands the other
way on statistics that differ by ~1e-7 (under 1e-3 of the codes, each off
by at most 1), and forward logits within 1e-4 relative L2 of the
reference's on the quantized model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import awq as JAWQ
from repro.core import calibration as JC
from repro.core import quantize as JQ
from repro.core import smoothing as JSM
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import awq as TAWQ
from repro_torch.core import calibration as TC
from repro_torch.core import quantize as TQ
from repro_torch.core import smoothing as TSM
from repro_torch.core.apply import quantizable_paths
from repro_torch.models import convert
from repro_torch.models import lm as TLM

GROUP, STEP = 16, 0.25
ARCHS = ["codellama-7b", "granite-moe-1b-a400m"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    arch = request.param
    jcfg = j_get_config(arch, smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    col = JC.collect_stats(jp, jcfg, batches)
    jq, alphas = JAWQ.awq_quantize(jp, jcfg, batches,
                                   JQuantConfig(group_size=GROUP), step=STEP)
    toks = np.random.default_rng(3).integers(2, jcfg.vocab_size, (2, 16))
    logits = np.asarray(japi.forward_fn(
        jq, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg))
    return dict(arch=arch, np_params=jax.tree.map(np.asarray, jp), col=col,
                jq=jq, alphas=alphas, toks=toks, logits=logits)


def _port(ref):
    tcfg = get_config(ref["arch"], smoke=True).with_(dtype="float32")
    return (tcfg, convert.from_reference(ref["np_params"]),
            TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24))


def test_mean_stats_match_reference(ref):
    """Sums and row counts per linear input (apply_linear's taps); the MoE
    expert taps record no sums in either package."""
    tcfg, tp, batches = _port(ref)
    col = TC.collect_stats(tp, tcfg, batches)
    jcol = ref["col"]
    assert set(col.sums) == set(jcol.sums)
    assert col.counts == jcol.counts
    for key in jcol.sums:
        np.testing.assert_allclose(col.mean_stats(key), jcol.mean_stats(key),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape,g", [((64, 48), 16), ((128, 40), 32),
                                     ((3, 64, 24), 16), ((256, 8), 128)])
def test_quantization_loss_matches_reference(shape, g):
    rng = np.random.default_rng(sum(shape) + g)
    w = rng.standard_normal(shape).astype(np.float32)
    x = np.abs(rng.standard_normal(shape[:-1])).astype(np.float32) * 3
    want = float(JQ.quantization_loss(jnp.asarray(w), jnp.asarray(x), g))
    got = float(TQ.quantization_loss(torch.from_numpy(w),
                                     torch.from_numpy(x), g))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_awq_matches_reference(ref):
    tcfg, tp, batches = _port(ref)
    tq, alphas = TAWQ.awq_quantize(tp, tcfg, batches,
                                   QuantConfig(group_size=GROUP), step=STEP)
    assert tq is tp                                  # in place
    assert alphas == ref["alphas"]
    total = differ = 0
    for i, layer in enumerate(tq["layers"]):
        for wp in quantizable_paths(tcfg):
            qt = TSM.tget(layer, wp)
            jqt = JSM.tget(ref["jq"]["layers"], wp)
            a = TQ.unpack_codes(qt.packed, GROUP).numpy().astype(np.int16)
            b = np.asarray(JQ.unpack_codes(jqt.packed[i], GROUP)).astype(
                np.int16)
            assert np.abs(a - b).max() <= 1
            total += a.size
            differ += int((a != b).sum())
    assert differ < 1e-3 * total, (differ, total)
    got = TLM.lm_forward(tq, torch.from_numpy(ref["toks"]), tcfg).numpy()
    want = ref["logits"]
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
