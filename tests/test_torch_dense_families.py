"""Port parity for the registry's other dense decoders on their f32 smoke
configs (llama3.2-3b, mistral-large-123b, chatglm3-6b with RoPE-2d,
starcoder2-15b with LayerNorm, GELU and biases, qwen2-vl-7b with M-RoPE,
q/k/v/o biases and the patch-embedding stub), against the JAX package on
the same weights.  Every bias and LayerNorm shift is drawn from a numpy
seed into the reference tree before conversion, so no bias path is tested
at zero:

- the layers against the reference's functions (LayerNorm, RMSNorm, GELU,
  RoPE ``standard`` / ``2d`` / ``mrope`` with shared and with distinct
  streams): within 1e-6;
- ``lm_forward`` logits (qwen2-vl with ``embeds``): within 1e-5 of the
  logits' largest magnitude;
- the calibration set, qwen2-vl's ``embeds`` included, number for number;
- SmoothQuant+ end to end: the same α and A8 flags, the loss curve within
  rtol 1e-4, every smoothing group's ``s`` and every fp leaf (biases, norm
  scales and shifts) within rtol 1e-5 (the statistics differ by f32
  summation order), every packed int4 code equal;
- AWQ (G=16, step 0.25) on the biased configs: the same α per group (the
  GELU MLP's ``mlp.down``, with no provider, gets none) and int4 codes;
- the reference-side finding on ``wv``'s bias: smoothing's ``linear_out``
  fusion does not scale it, and the port keeps that behaviour.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import apply as JAP
from repro.core import calibration as JC
from repro.core import smoothing as JSM
from repro.core.quantize import unpack_codes as j_unpack
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import apply as TAP
from repro_torch.core import calibration as TC
from repro_torch.core import smoothing as TSM
from repro_torch.core.quantize import unpack_codes
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import layers as TL

ARCHS = ["llama3.2-3b", "mistral-large-123b", "chatglm3-6b",
         "starcoder2-15b", "qwen2-vl-7b"]
GROUP = 16
BIAS_SD = 0.1


def fill_biases(tree, seed: int, sd: float):
    """A copy of a numpy param tree whose ``"b"`` and ``"bias"`` leaves are
    drawn from N(0, sd²)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.normal(0.0, sd, v.shape).astype(v.dtype)
                        if k in ("b", "bias") and not isinstance(v, dict)
                        else walk(v)) for k, v in node.items()}
        return node
    return walk(tree)


def _n_bias_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(1 if k in ("b", "bias") and not isinstance(v, dict)
                   else _n_bias_leaves(v) for k, v in tree.items())
    return 0


def _cfgs(arch):
    return (j_get_config(arch, smoke=True).with_(dtype="float32"),
            get_config(arch, smoke=True).with_(dtype="float32"))


@functools.lru_cache(maxsize=None)
def _fp(arch, sd=BIAS_SD):
    jcfg, _ = _cfgs(arch)
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    return fill_biases(jax.tree.map(np.asarray, jp), 3, sd)


@functools.lru_cache(maxsize=None)
def _ref_ptq(arch):
    """The JAX package's SmoothQuant+ of the bias-filled smoke model, its
    calibration statistics and its ``s`` per group at the searched α."""
    jcfg, _ = _cfgs(arch)
    jp = jax.tree.map(jnp.asarray, _fp(arch))
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, rep = JAP.smoothquant_plus(jp, jcfg, batches,
                                   JQuantConfig(group_size=GROUP))
    col = JC.collect_stats(jp, jcfg, batches)
    _, s_map = JSM.smooth_model(jp, jcfg, col, rep.alpha)
    return jq, rep, s_map


# ----------------------------------------------------------------- layers --
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(48).astype(np.float32)
    want = JL.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    init = TL.init_norm(48, torch.float32, "cpu", kind)
    assert set(init) == set(JL.init_norm(48, kind, jnp.float32))


def test_gelu_matches_reference():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    np.testing.assert_allclose(TL.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.gelu(jnp.asarray(x))), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dh", [16, 128])
@pytest.mark.parametrize("variant,streams", [
    ("standard", 1), ("2d", 1), ("mrope", 1), ("mrope", 3)])
def test_rope_matches_reference(variant, streams, dh):
    """``streams=3`` gives M-RoPE three distinct position streams
    ``[3, B, T]``; ``streams=1`` the text positions ``[B, T]``."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    shape = (3, 2, 7) if streams == 3 else (2, 7)
    pos = rng.integers(0, 300, shape).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4,
                         variant=variant)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        theta=1e4, variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if variant == "mrope" and streams == 1:
        # three equal streams are the standard rotation, bit for bit
        std = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta=1e4)
        assert torch.equal(got, std)
    if variant == "2d":
        assert torch.equal(got[..., dh // 2:], torch.from_numpy(x)[...,
                                                                   dh // 2:])


# ------------------------------------------------------------------ model --
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    tcfg.check()
    get_config(arch).check()
    fp = _fp(arch)
    assert _n_bias_leaves(fp) == {"starcoder2-15b": 9, "qwen2-vl-7b": 4}.get(
        arch, 0)
    rng = np.random.default_rng(1)
    toks = rng.integers(2, jcfg.vocab_size, (2, 20)).astype(np.int32)
    batch = {"tokens": toks}
    if jcfg.family == "vlm":
        batch["embeds"] = rng.standard_normal(
            (2, 4, jcfg.d_model)).astype(np.float32)
    want = np.asarray(japi.forward_fn(
        jax.tree.map(jnp.asarray, fp),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, backend="xla"))
    got = tapi.forward_fn(convert.from_reference(fp),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if jcfg.family == "vlm":     # the stub moves the logits
        plain = tapi.forward_fn(convert.from_reference(fp),
                                {"tokens": torch.from_numpy(toks)}, tcfg)
        assert np.abs(plain.numpy() - got).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_set_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jb = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    tb = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    assert [set(b) for b in tb] == [set(b) for b in jb]
    assert ("embeds" in tb[0]) == (arch == "qwen2-vl-7b")
    for j, t in zip(jb, tb):
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoothquant_plus_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jq, rep, s_map = _ref_ptq(arch)
    batches = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    col = TC.collect_stats(convert.from_reference(_fp(arch)), tcfg, batches)
    _, t_smap = TSM.smooth_model(convert.from_reference(_fp(arch)), tcfg,
                                 col, rep.alpha)
    assert set(t_smap) == set(s_map) == {"layers.qkv", "layers.wo",
                                         "mlp.in", "mlp.down"}
    for name, s in s_map.items():
        np.testing.assert_allclose(t_smap[name], s, rtol=1e-5)
    if tcfg.mlp == "gelu":          # no provider: s = 1
        assert (t_smap["mlp.down"] == 1).all()

    tq, trep = TAP.smoothquant_plus(convert.from_reference(_fp(arch)), tcfg,
                                    batches, QuantConfig(group_size=GROUP))
    assert trep.alpha == rep.alpha
    for a in rep.loss_curve:
        np.testing.assert_allclose(trep.loss_curve[a], rep.loss_curve[a],
                                   rtol=1e-4)
    assert trep.a8_eligibility == rep.a8_eligibility
    assert (trep.fp_bytes, trep.quant_bytes) == (rep.fp_bytes,
                                                 rep.quant_bytes)
    paths = TAP.quantizable_paths(tcfg)
    assert paths == [tuple(p[1:]) for p in JAP.quantizable_paths(jcfg)]
    if tcfg.mlp == "gelu":
        assert ("mlp", "up", "w") in paths and ("mlp", "down", "w") in paths
    for i, layer in enumerate(tq["layers"]):
        for wp in paths:
            qt, jqt = TSM.tget(layer, wp), TSM.tget(jq["layers"], wp)
            g = qt.group_size
            np.testing.assert_array_equal(
                unpack_codes(qt.packed, g).numpy(),
                np.asarray(j_unpack(jqt.packed[i], g)))
            np.testing.assert_allclose(qt.scales.numpy(),
                                       np.asarray(jqt.scales[i]), rtol=1e-5)
    # fp leaves: biases stay fp, norm scales and shifts carry 1/s
    back = convert.to_reference(tq)
    jnp_q = jax.tree.map(np.asarray, jq)

    def same(j, t, path=()):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                same(j[k], t[k], path + (k,))
        elif not hasattr(j, "packed"):
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-7,
                                       err_msg=str(path))
    same(jnp_q, back)
    assert _n_bias_leaves(back) == _n_bias_leaves(_fp(arch))


# ------------------------------------------------ wv bias (reference side) --
def _logit_gap(fwd, params_a, params_b, toks) -> float:
    a, b = fwd(params_a, toks), fwd(params_b, toks)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.mark.parametrize("arch", ["starcoder2-15b", "qwen2-vl-7b"])
def test_wv_bias_smoothing_gap_matches_reference(arch):
    """Reference-side finding, pinned, not fixed: the ``layers.wo`` group's
    provider is ``wv``, and smoothing divides ``wv``'s weight columns by s
    but not its bias, so with ``wv.b != 0`` the smoothed fp model is no
    longer the fp model.  The JAX package is the reference and is not
    edited, so the port copies this: with every bias drawn from N(0, 0.5²)
    and α = 0.5 both packages smooth to the same params (``wv.b``
    untouched) and show the same nonzero relative L2 logit gap; with only
    ``wv.b`` zeroed both gaps vanish."""
    jcfg, tcfg = _cfgs(arch)
    toks = np.random.default_rng(2).integers(
        2, jcfg.vocab_size, (2, 16)).astype(np.int32)

    def jfwd(p, t):
        return np.asarray(japi.forward_fn(p, {"tokens": jnp.asarray(t)},
                                          jcfg, backend="xla"))

    def tfwd(p, t):
        return tapi.forward_fn(p, {"tokens": torch.from_numpy(t)},
                               tcfg).numpy()

    gaps = {}
    for zero_wv in (False, True):
        fp = _fp(arch, 0.5)
        if zero_wv:
            fp = dict(fp, layers=dict(fp["layers"], mixer=dict(
                fp["layers"]["mixer"], wv=dict(
                    fp["layers"]["mixer"]["wv"],
                    b=np.zeros_like(fp["layers"]["mixer"]["wv"]["b"])))))
        jp = jax.tree.map(jnp.asarray, fp)
        jcol = JC.collect_stats(jp, jcfg, JC.synthetic_calibration_set(
            jcfg, n_seqs=2, seq_len=24))
        jsm, _ = JSM.smooth_model(jp, jcfg, jcol, 0.5)
        tcol = TC.collect_stats(convert.from_reference(fp), tcfg,
                                TC.synthetic_calibration_set(
                                    tcfg, n_seqs=2, seq_len=24))
        tsm, _ = TSM.smooth_model(convert.from_reference(fp), tcfg, tcol,
                                  0.5)
        back = convert.to_reference(tsm)
        for path in (("mixer", "wv", "w"), ("mixer", "wv", "b"),
                     ("mixer", "wo", "w"), ("norm1", "bias"),
                     ("norm1", "scale")):
            if path[-1] == "bias" and tcfg.norm != "layernorm":
                continue
            want = np.asarray(JSM.tget(jsm["layers"], path))
            np.testing.assert_allclose(TSM.tget(back["layers"], path).numpy(),
                                       want, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(back["layers"]["mixer"]["wv"]["b"],
                                      fp["layers"]["mixer"]["wv"]["b"])
        gaps[zero_wv] = (_logit_gap(jfwd, jp, jsm, toks),
                         _logit_gap(tfwd, convert.from_reference(fp), tsm,
                                    toks))
    (j_gap, t_gap), (j_zero, t_zero) = gaps[False], gaps[True]
    assert j_gap > 0.1 and t_gap > 0.1
    np.testing.assert_allclose(t_gap, j_gap, rtol=1e-3)
    assert j_zero < 1e-5 and t_zero < 1e-5


@pytest.mark.parametrize("arch", ["starcoder2-15b", "qwen2-vl-7b"])
def test_awq_matches_reference(arch):
    """AWQ's per-group α on the biased configs (G=16, step 0.25): the GELU
    MLP's ``mlp.down`` group has no provider and gets no α in either
    package; every α and every int4 code equal to the reference's."""
    from repro.core import awq as JAWQ
    from repro_torch.core import awq as TAWQ

    jcfg, tcfg = _cfgs(arch)
    jq, jalphas = JAWQ.awq_quantize(
        jax.tree.map(jnp.asarray, _fp(arch)), jcfg,
        JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24),
        JQuantConfig(group_size=GROUP), step=0.25)
    tq, talphas = TAWQ.awq_quantize(
        convert.from_reference(_fp(arch)), tcfg,
        TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24),
        QuantConfig(group_size=GROUP), step=0.25)
    assert talphas == jalphas
    assert ("mlp.down" in talphas) == (tcfg.mlp == "swiglu")
    for i, layer in enumerate(tq["layers"]):
        for wp in TAP.quantizable_paths(tcfg):
            qt, jqt = TSM.tget(layer, wp), TSM.tget(jq["layers"], wp)
            np.testing.assert_array_equal(
                unpack_codes(qt.packed, qt.group_size).numpy(),
                np.asarray(j_unpack(jqt.packed[i], qt.group_size)))
