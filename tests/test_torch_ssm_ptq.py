"""Port parity for SmoothQuant+ on the SSM stacks (``core/calibration.py``'s
hybrid pass, ``core/smoothing.py``'s Mamba2, RWKV6 and hybrid groups,
``core/apply.py``, ``core/awq.py``, the PTQ artifact), here on the f32
smoke config of zamba2-7b (2 groups of 2 Mamba2 layers, a tail of 1, one
weight-shared attention block) with the JAX package's weights, against the
JAX package on the CPU; ``test_torch_rwkv_ptq.py`` runs the same checks on
rwkv6-7b (one file each: the reference's PTQ of this model alone takes
about a minute here):

- the statistics, keyed ``("groups", (gi, ki))``, ``("tail", (ti,))``,
  ``("shared", ())`` (one key over the shared block's call sites: their
  channel max) and ``("layers", (i,))``, within rtol 1e-5;
- smoothing at the searched α: every group's ``s`` and the whole smoothed
  fp tree (the ``linear_out_sqrt`` columns of RWKV6's channel-mix ``wk``,
  the ``w_lora_a`` row compensation, norm scales and shifts) within rtol
  1e-5;
- SmoothQuant+ end to end: the same α and A8 flags (one per ``[g, k]``
  stack), the loss curve within rtol 1e-4, the reference's quantized paths
  and byte counts, every packed int4 code equal;
- the artifact saved by either package loads in the other bitwise;
- AWQ (G=16, step 0.25): the same α per group and int4 codes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JCK
from repro.configs import get_config as j_get_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import apply as JAP
from repro.core import awq as JAWQ
from repro.core import calibration as JC
from repro.core import smoothing as JSM
from repro.core.quantize import QuantizedTensor as JQT
from repro.core.quantize import unpack_codes as j_unpack
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import apply as TAP
from repro_torch.core import awq as TAWQ
from repro_torch.core import calibration as TC
from repro_torch.core import smoothing as TSM
from repro_torch.core.quantize import QuantizedTensor, unpack_codes
from repro_torch.models import convert

GROUP, STEP = 16, 0.25


def _cfgs(arch):
    return (j_get_config(arch, smoke=True).with_(dtype="float32"),
            get_config(arch, smoke=True).with_(dtype="float32"))


def _fp(arch):
    jcfg, _ = _cfgs(arch)
    tree = jax.tree.map(np.asarray,
                        japi.init_model(jax.random.PRNGKey(0), jcfg))
    if arch == "rwkv6-7b":
        rng = np.random.default_rng(7)
        u = tree["layers"]["mixer"]["u_bonus"]
        tree["layers"]["mixer"]["u_bonus"] = rng.normal(
            0, 0.5, u.shape).astype(u.dtype)
    return tree


def reference_ptq(arch):
    """The JAX package's SmoothQuant+ (α searched) and AWQ of one smoke
    model, its statistics and its smoothed fp tree at the searched α."""
    jcfg, _ = _cfgs(arch)
    fp = _fp(arch)
    jp = jax.tree.map(jnp.asarray, fp)
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, rep = JAP.smoothquant_plus(jp, jcfg, batches,
                                   JQuantConfig(group_size=GROUP))
    col = JC.collect_stats(jp, jcfg, batches)
    smoothed, s_map = JSM.smooth_model(jp, jcfg, col, rep.alpha)
    awq, alphas = JAWQ.awq_quantize(jp, jcfg, batches,
                                    JQuantConfig(group_size=GROUP), step=STEP)
    return dict(arch=arch, fp=fp, jq=jq, rep=rep, col=col, s_map=s_map,
                smoothed=jax.tree.map(np.asarray, smoothed), awq=awq,
                alphas=alphas)


def _port(ref):
    _, tcfg = _cfgs(ref["arch"])
    return (tcfg, convert.from_reference(ref["fp"]),
            TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24))


def _same_fp(got, want, path=()):
    """A reference-layout host tree (``to_reference``) against a JAX one:
    fp leaves within rtol 1e-5, quantized codes equal, flags equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_fp(got[k], want[k], path + (k,))
    elif isinstance(want, JQT):
        assert isinstance(got, QuantizedTensor) and got.a8 == want.a8, path
        g = want.group_size
        lead = want.packed.shape[:-2]
        a = unpack_codes(got.packed.reshape(-1, *got.packed.shape[-2:]), g)
        b = j_unpack(jnp.asarray(want.packed).reshape(
            -1, *want.packed.shape[-2:]), g)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=str(path))
        assert tuple(got.packed.shape[:-2]) == tuple(lead), path
        np.testing.assert_allclose(got.scales.numpy(),
                                   np.asarray(want.scales), rtol=1e-5,
                                   err_msg=str(path))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=str(path))


@pytest.fixture(scope="module")
def ref():
    return reference_ptq("zamba2-7b")


def check_stats_and_smoothing(ref):
    tcfg, tp, batches = _port(ref)
    col = TC.collect_stats(tp, tcfg, batches)
    jcol = ref["col"]
    assert set(col.stats) == set(jcol.stats)
    for key in jcol.stats:
        np.testing.assert_allclose(col.stats[key], jcol.stats[key],
                                   rtol=1e-5, err_msg=str(key))
    if ref["arch"] == "zamba2-7b":
        assert {k[:2] for k in col.stats} == {
            (("groups",), (g, k)) for g in range(2) for k in range(2)} | {
            (("tail",), (0,)), (("shared",), ())}
    _, s_map = TSM.smooth_model(tp, tcfg, col, ref["rep"].alpha)
    assert set(s_map) == set(ref["s_map"])
    for name, s in ref["s_map"].items():
        np.testing.assert_allclose(s_map[name], s, rtol=1e-5, err_msg=name)
    _same_fp(convert.to_reference(tp), ref["smoothed"])


def check_smoothquant_plus(ref):
    tcfg, tp, batches = _port(ref)
    rep = ref["rep"]
    tq, trep = TAP.smoothquant_plus(tp, tcfg, batches,
                                    QuantConfig(group_size=GROUP))
    assert trep.alpha == rep.alpha
    for a in rep.loss_curve:
        np.testing.assert_allclose(trep.loss_curve[a], rep.loss_curve[a],
                                   rtol=1e-4)
    assert trep.a8_eligibility == rep.a8_eligibility
    assert (trep.fp_bytes, trep.quant_bytes) == (rep.fp_bytes,
                                                 rep.quant_bytes)
    assert TAP._reference_paths(trep.quantized_paths) == [
        tuple(p) for p in rep.quantized_paths]
    _same_fp(convert.to_reference(tq), ref["jq"])


def _assert_port_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_port_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_port_equal(x, y)
    elif isinstance(a, QuantizedTensor):
        assert isinstance(b, QuantizedTensor) and a.a8 == b.a8
        for f in ("packed", "scales", "zeros"):
            _assert_port_equal(getattr(a, f), getattr(b, f))
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _assert_jax_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_jax_equal(a[k], b[k])
    elif isinstance(a, JQT):
        assert isinstance(b, JQT) and a.a8 == b.a8
        for f in ("packed", "scales", "zeros"):
            _assert_jax_equal(getattr(a, f), getattr(b, f))
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def check_artifact(ref, tmp_path):
    """The JAX package's quantized tree saved by it loads in the port
    bitwise, and the port's loads in the JAX package bitwise, reports
    equal."""
    jcfg, tcfg = _cfgs(ref["arch"])
    qcfg, jqcfg = QuantConfig(group_size=GROUP), JQuantConfig(
        group_size=GROUP)
    JAP.save_ptq(tmp_path / "jax", ref["jq"], ref["rep"], jcfg, jqcfg)
    tq, trep = TAP.load_ptq(tmp_path / "jax", tcfg, qcfg, device="cpu")
    _assert_port_equal(tq, convert.from_reference(
        jax.tree.map(np.asarray, ref["jq"])))
    assert trep.a8_eligibility == ref["rep"].a8_eligibility
    assert TAP._reference_paths(trep.quantized_paths) == [
        tuple(p) for p in ref["rep"].quantized_paths]
    TAP.save_ptq(tmp_path / "port", tq, trep, tcfg, qcfg)
    jq, jrep = JAP.load_ptq(tmp_path / "port", jcfg, jqcfg)
    _assert_jax_equal(jq, ref["jq"])
    assert jrep.a8_eligibility == ref["rep"].a8_eligibility
    assert [tuple(p) for p in jrep.quantized_paths] == [
        tuple(p) for p in ref["rep"].quantized_paths]
    assert JCK.has_ptq_artifact(tmp_path / "port")


def check_awq(ref):
    tcfg, tp, batches = _port(ref)
    tq, alphas = TAWQ.awq_quantize(tp, tcfg, batches,
                                   QuantConfig(group_size=GROUP), step=STEP)
    assert alphas == ref["alphas"]
    _same_fp(convert.to_reference(tq), ref["awq"])


def test_stats_and_smoothing_match_jax(ref):
    check_stats_and_smoothing(ref)


def test_smoothquant_plus_matches_jax(ref):
    check_smoothquant_plus(ref)
    # out_proj and the shared MLP's down stay A16 on this model: the flags
    # the artifact and the engine carry are not all the default
    assert not all(ref["rep"].a8_eligibility.values())


def test_artifact_loads_in_either_package(ref, tmp_path):
    check_artifact(ref, tmp_path)


def test_awq_matches_jax(ref):
    check_awq(ref)
