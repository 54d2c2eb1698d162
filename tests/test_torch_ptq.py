"""Port parity for SmoothQuant+ PTQ on the f32 codellama-7b smoke config:
calibration statistics (rtol 1e-5), the searched α (equal) and its loss
curve (rtol 1e-4), the smoothing scales (rtol 1e-5), and the packed int4
codes (equal except where a float rounding tie lands differently: at most
1e-4 of the codes, each off by at most 1).  The statistics differ from the
reference only by f32 summation order in the calibration forward."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import apply as JAP
from repro.core import calibration as JC
from repro.core import smoothing as JSM
from repro.core.quantize import unpack_codes as j_unpack
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import apply as TAP
from repro_torch.core import calibration as TC
from repro_torch.core import search as TS
from repro_torch.core import smoothing as TSM
from repro_torch.core.quantize import QuantizedTensor, unpack_codes
from repro_torch.models import convert
from repro_torch.models import lm as TLM

GROUP = 16


@pytest.fixture(scope="module")
def ref():
    jcfg = j_get_config("codellama-7b", smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, rep = JAP.smoothquant_plus(jp, jcfg, batches,
                                   JQuantConfig(group_size=GROUP))
    col = JC.collect_stats(jp, jcfg, batches)
    _, s_map = JSM.smooth_model(jp, jcfg, col, rep.alpha)
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, np_params, batches, jq, rep, col, s_map


def _port(ref_np):
    tcfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    return tcfg, convert.from_reference(ref_np)


def test_calibration_set_and_stats_match(ref):
    jcfg, np_params, jbatches, _, _, jcol, _ = ref
    tcfg, tp = _port(np_params)
    tbatches = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    for jb, tb in zip(jbatches, tbatches):
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
    tcol = TC.collect_stats(tp, tcfg, tbatches)
    assert set(tcol.stats) == set(jcol.stats)
    for key, v in jcol.stats.items():
        np.testing.assert_allclose(tcol.stats[key], v, rtol=1e-5, atol=1e-7)


def test_alpha_scales_and_codes_match(ref):
    jcfg, np_params, _, jq, rep, _, s_map = ref
    tcfg, tp = _port(np_params)
    batches = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    col = TC.collect_stats(tp, tcfg, batches)
    res = TS.search_alpha(tp, tcfg, col, group_size=GROUP)
    assert res.alpha == rep.alpha
    for a in rep.loss_curve:
        np.testing.assert_allclose(res.losses[a], rep.loss_curve[a],
                                   rtol=1e-4)
    _, t_smap = TSM.smooth_model(tp, tcfg, col, res.alpha)
    assert set(t_smap) == set(s_map)
    for name, s in s_map.items():
        np.testing.assert_allclose(t_smap[name], s, rtol=1e-5)
    tq, paths, _, _ = TAP.quantize_params(tp, tcfg, QuantConfig(
        group_size=GROUP))
    assert len(paths) == 7 * tcfg.num_layers
    total = differ = 0
    for i, layer in enumerate(tq["layers"]):
        for wp in TAP.quantizable_paths(tcfg):
            qt = TSM.tget(layer, wp)
            assert isinstance(qt, QuantizedTensor)
            jqt = TSM.tget(jq["layers"], wp)
            a = unpack_codes(qt.packed, GROUP).numpy().astype(np.int16)
            b = np.asarray(j_unpack(jqt.packed[i], GROUP)).astype(np.int16)
            assert np.abs(a - b).max() <= 1
            total += a.size
            differ += int((a != b).sum())
            np.testing.assert_allclose(qt.scales.numpy(),
                                       np.asarray(jqt.scales[i]), rtol=1e-5)
    assert differ <= 1e-4 * total, (differ, total)


def test_smoothquant_plus_end_to_end(ref):
    """The one-call recipe gives the stepwise result, quantizes in place and
    leaves the model's function unchanged by smoothing (α fixed here)."""
    jcfg, np_params, _, _, rep, _, _ = ref
    tcfg, tp = _port(np_params)
    batches = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    tq, trep = TAP.smoothquant_plus(tp, tcfg, batches,
                                    QuantConfig(group_size=GROUP))
    assert trep.alpha == rep.alpha and tq is tp
    assert trep.fp_bytes == rep.fp_bytes and trep.quant_bytes == rep.quant_bytes
    # smoothing alone is an exact transform of the fp model
    _, fp = _port(np_params)
    _, sm = _port(np_params)
    col = TC.collect_stats(sm, tcfg, batches)
    TSM.smooth_model(sm, tcfg, col, 0.5)
    toks = batches[0]["tokens"]
    np.testing.assert_allclose(TLM.lm_forward(sm, toks, tcfg).numpy(),
                               TLM.lm_forward(fp, toks, tcfg).numpy(),
                               atol=1e-4, rtol=0)


# ------------------------------------------------- granite MoE (smoke) -----
@pytest.fixture(scope="module")
def granite_ref():
    jcfg = j_get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jp)
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, rep = JAP.smoothquant_plus(jp, jcfg, batches,
                                   JQuantConfig(group_size=GROUP))
    col = JC.collect_stats(jp, jcfg, batches)
    _, s_map = JSM.smooth_model(jp, jcfg, col, rep.alpha)
    return jcfg, np_params, jq, rep, s_map


def test_granite_smoothquant_plus_matches(granite_ref):
    """The MoE groups: moe.in (router stat, router rows compensated, never
    quantized) and moe.down (per-expert s [E, F]) give the reference's α,
    smoothing scales, A8 flags and int4 expert stacks."""
    jcfg, np_params, jq, rep, s_map = granite_ref
    tcfg = get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32")
    batches = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    tp = convert.from_reference(np_params)
    col = TC.collect_stats(tp, tcfg, batches)
    res = TS.search_alpha(tp, tcfg, col, group_size=GROUP)
    assert res.alpha == rep.alpha
    for a in rep.loss_curve:
        np.testing.assert_allclose(res.losses[a], rep.loss_curve[a],
                                   rtol=1e-4)
    _, t_smap = TSM.smooth_model(convert.from_reference(np_params), tcfg,
                                 col, res.alpha)
    assert set(t_smap) == set(s_map) >= {"moe.in", "moe.down"}
    assert t_smap["moe.down"].shape == (jcfg.num_layers, jcfg.moe.num_experts,
                                        jcfg.moe.d_expert)
    for name, s in s_map.items():
        np.testing.assert_allclose(t_smap[name], s, rtol=1e-5)

    tq, trep = TAP.smoothquant_plus(tp, tcfg, batches,
                                    QuantConfig(group_size=GROUP))
    assert trep.alpha == rep.alpha
    assert trep.a8_eligibility == rep.a8_eligibility
    for k, v in rep.a8_errors.items():
        np.testing.assert_allclose(trep.a8_errors[k], v, rtol=1e-4)
    assert trep.fp_bytes == rep.fp_bytes and trep.quant_bytes == rep.quant_bytes
    for i, layer in enumerate(tq["layers"]):
        router = layer["mlp"]["router"]["w"]
        assert not isinstance(router, QuantizedTensor)
        np.testing.assert_allclose(
            router.numpy(), np.asarray(jq["layers"]["mlp"]["router"]["w"][i]),
            rtol=1e-5, atol=1e-6)
        for name in ("gate", "up", "down"):
            qt = layer["mlp"]["experts"][name]
            jqt = jq["layers"]["mlp"]["experts"][name]
            assert isinstance(qt, QuantizedTensor) and qt.ndim == 3
            a = unpack_codes(qt.packed, GROUP).numpy().astype(np.int16)
            b = np.asarray(j_unpack(jqt.packed[i], GROUP)).astype(np.int16)
            assert np.abs(a - b).max() <= 1
            assert (a != b).mean() <= 1e-3
            np.testing.assert_allclose(qt.scales.numpy(),
                                       np.asarray(jqt.scales[i]), rtol=1e-5)
