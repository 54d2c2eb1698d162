"""Port parity for the encoder-decoder (``models/whisper.py`` and its
PTQ), on whisper-medium's f32 smoke config (2 encoder and 2 decoder
layers) with the JAX package's weights, every bias and LayerNorm shift
drawn from a numpy seed into the reference tree before conversion, against
the JAX package on the CPU:

- ``encode``, ``whisper_forward``, ``whisper_enc_kv``: within 1e-5 of the
  reference's largest magnitude;
- the paged path: two chunks of ``whisper_prefill_chunk`` (ragged
  ``start_len``, ``chunk_len``, ``enc_len``, ``last_idx``) and one
  ``whisper_decode_paged`` step with an idle row on the trash page and
  ``enc_len`` 0: logits and the self-attention pools within 1e-5, the
  encoder pool untouched;
- the contiguous ``prefill_fn`` / ``decode_fn``, three steps: within 1e-5;
- the calibration set (its ``frames``) number for number;
- SmoothQuant+ end to end: the same α and A8 flags, the loss curve within
  rtol 1e-4, every group's ``s`` within rtol 1e-5 (``dec.xkv`` one ``s``
  for both decoder layers), every smoothed tensor within rtol 1e-5 (so
  ``enc.final_norm`` was divided by that ``s`` once, not once a layer),
  every int4 code equal;
- AWQ (G=16, step 0.25): the same α per group, ``dec.xkv``'s
  ``layer_reduce`` branch included, and the same int4 codes;
- the PTQ artifact, saved by either package and loaded by the other,
  bitwise, with equal fingerprints; ``convert`` round trip;
- the reference-side ``wv``-bias finding on whisper's ``*.wo`` and
  ``dec.xo`` groups.
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
from repro.core import awq as JAWQ
from repro.core import calibration as JC
from repro.core import smoothing as JSM
from repro.core.quantize import QuantizedTensor as JQT
from repro.core.quantize import unpack_codes as j_unpack
from repro.models import api as japi
from repro.models import whisper as JW
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import apply as TAP
from repro_torch.core import awq as TAWQ
from repro_torch.core import calibration as TC
from repro_torch.core import smoothing as TSM
from repro_torch.core.quantize import QuantizedTensor, unpack_codes
from repro_torch.models import api
from repro_torch.models import convert
from repro_torch.models import whisper as TW

ARCH = "whisper-medium"
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


def _cfgs():
    return (j_get_config(ARCH, smoke=True).with_(dtype="float32"),
            get_config(ARCH, smoke=True).with_(dtype="float32"))


@functools.lru_cache(maxsize=None)
def _fp(sd=BIAS_SD):
    jcfg, _ = _cfgs()
    jp = japi.init_model(jax.random.PRNGKey(1), jcfg)
    return fill_biases(jax.tree.map(np.asarray, jp), 3, sd)


def _jp(sd=BIAS_SD):
    return jax.tree.map(jnp.asarray, _fp(sd))


def _tp(sd=BIAS_SD):
    return convert.from_reference(_fp(sd))


def _close(got, want, what, tol=1e-5):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                               err_msg=what)


def _frames(b, t, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, t, 64)) * 0.5
            ).astype(np.float32)


# ------------------------------------------------------------- the model --
def test_encode_forward_and_enc_kv_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _jp(), _tp()
    fr = _frames(2, 11)
    toks = np.random.default_rng(1).integers(2, 256, (2, 9)).astype(np.int32)
    _close(TW.encode(tp, torch.from_numpy(fr), tcfg),
           JW.encode(jp, jnp.asarray(fr), jcfg, backend="xla"), "encode")
    _close(api.forward_fn(tp, {"frames": torch.from_numpy(fr),
                               "tokens": torch.from_numpy(toks)}, tcfg),
           japi.forward_fn(jp, {"frames": jnp.asarray(fr),
                                "tokens": jnp.asarray(toks)}, jcfg,
                           backend="xla"), "forward logits")
    jkv = japi.encode_kv_fn(jp, jnp.asarray(fr), jcfg, backend="xla")
    tkv = api.encode_kv_fn(tp, torch.from_numpy(fr), tcfg)
    for k in ("xk", "xv"):
        assert tuple(tkv[k].shape) == (2, 2, 11, 4, 16)
        _close(tkv[k], jkv[k], k)
    with pytest.raises(NotImplementedError, match="enc-dec only"):
        api.encode_kv_fn(tp, torch.from_numpy(fr),
                         get_config("codellama-7b", smoke=True))


def test_sinusoids_match_reference():
    np.testing.assert_allclose(TW.sinusoid(7, 64, offset=3).numpy(),
                               np.asarray(JW.sinusoid(7, 64, offset=3)),
                               rtol=0, atol=2e-6)
    pos = np.array([[0, 5, 1499], [3, 4, 60000]], np.int32)
    np.testing.assert_allclose(TW.sinusoid_at(torch.from_numpy(pos),
                                              1024).numpy(),
                               np.asarray(JW.sinusoid_at(jnp.asarray(pos),
                                                         1024)),
                               rtol=0, atol=5e-3)


def _paged_inputs(n_pages, ps):
    """Encoder pages of two slots (5 and 9 frames) written from the
    reference's ``whisper_enc_kv``, in both packages' pools."""
    jcfg, tcfg = _cfgs()
    jpools = japi.init_paged_cache(jcfg, n_pages, ps)
    tpools = api.init_paged_cache(tcfg, n_pages, ps, "cpu")
    etable = np.zeros((3, 4), np.int32)
    etable[0, :2], etable[1, :3] = (9, 10), (11, 12, 13)
    elen = np.array([5, 9, 0], np.int32)
    jp = _jp()
    for slot, n in ((0, 5), (1, 9)):
        kv = JW.whisper_enc_kv(jp, jnp.asarray(_frames(1, n, 10 + slot)),
                               jcfg, backend="xla")
        npg = -(-n // ps)
        pages = etable[slot, :npg]
        for k in ("xk", "xv"):
            rows = np.pad(np.asarray(kv[k])[:, 0],
                          ((0, 0), (0, npg * ps - n), (0, 0), (0, 0)))
            rows = rows.reshape(rows.shape[0], npg, ps, *rows.shape[2:])
            jpools["enc"][k] = jpools["enc"][k].at[:, pages].set(rows)
            tpools["enc"][k][:, torch.from_numpy(pages).long()] = \
                torch.from_numpy(rows)
    return jpools, tpools, etable, elen


def test_prefill_chunk_and_decode_paged_match_jax():
    """Two ragged chunks for slots (0, 1) of 3 (the second from start_len
    6 / 3), then one decode step with slot 2 idle: its self-attention table
    and its encoder table on the trash page, ``enc_len`` 0."""
    jcfg, tcfg = _cfgs()
    jp, tp = _jp(), _tp()
    ps, n_pages = 4, 16
    jpools, tpools, etable, elen = _paged_inputs(n_pages, ps)
    enc_before = {k: v.clone() for k, v in tpools["enc"].items()}
    table = np.zeros((3, 4), np.int32)
    table[0], table[1] = (1, 2, 3, 4), (5, 6, 7, 8)
    rng = np.random.default_rng(4)
    starts = np.zeros(2, np.int32)
    for lens in (np.array([6, 3], np.int32), np.array([5, 7], np.int32)):
        toks = rng.integers(2, 256, (2, 8)).astype(np.int32)
        jl, jpools = japi.prefill_chunk_fn(
            jp, {"tokens": jnp.asarray(toks)}, jpools,
            jnp.asarray(table[:2]), jnp.asarray(starts), jnp.asarray(lens),
            jcfg, backend="xla", last_idx=jnp.asarray(lens - 1),
            enc_table=jnp.asarray(etable[:2]), enc_len=jnp.asarray(elen[:2]))
        tl, tpools = api.prefill_chunk_fn(
            tp, {"tokens": torch.from_numpy(toks)}, tpools,
            torch.from_numpy(table[:2]), torch.from_numpy(starts),
            torch.from_numpy(lens), tcfg,
            last_idx=torch.from_numpy(lens - 1),
            enc_table=torch.from_numpy(etable[:2]),
            enc_len=torch.from_numpy(elen[:2]))
        _close(tl, jl, f"prefill logits at start {starts}")
        starts = starts + lens
    tok = rng.integers(2, 256, (3, 1)).astype(np.int32)
    pos = np.array([starts[0], starts[1], 0], np.int32)
    jl, jpools = japi.decode_paged_fn(
        jp, {"token": jnp.asarray(tok), "position": jnp.asarray(pos)},
        jpools, jnp.asarray(table), jcfg, backend="xla",
        enc_table=jnp.asarray(etable), enc_len=jnp.asarray(elen))
    tl, tpools = api.decode_paged_fn(
        tp, {"token": torch.from_numpy(tok),
             "position": torch.from_numpy(pos)}, tpools,
        torch.from_numpy(table), tcfg, enc_table=torch.from_numpy(etable),
        enc_len=torch.from_numpy(elen))
    assert bool(torch.isfinite(tl).all())   # the idle row's softmax too
    _close(tl[:2], np.asarray(jl)[:2], "decode logits")
    for i, lp in enumerate(tpools["layers"]):
        for k in lp:
            _close(lp[k], jpools["layers"][k][i], f"pool {i} {k}")
    for k, v in tpools["enc"].items():
        assert torch.equal(v, enc_before[k]), k


def test_contiguous_prefill_and_decode_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _jp(), _tp()
    fr = _frames(2, 7, 5)
    toks = np.random.default_rng(6).integers(2, 256, (2, 6)).astype(np.int32)
    jl, jc = japi.prefill_fn(jp, {"frames": jnp.asarray(fr),
                                  "tokens": jnp.asarray(toks)}, jcfg, 12,
                             backend="xla")
    tl, tc = api.prefill_fn(tp, {"frames": torch.from_numpy(fr),
                                 "tokens": torch.from_numpy(toks)}, tcfg, 12)
    _close(tl, jl, "prefill logits")
    assert tuple(tc["layers"][0]["xk"].shape) == (2, 7, 4, 16)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        api.prefill_fn(tp, {"frames": torch.from_numpy(fr),
                            "tokens": torch.from_numpy(toks)}, tcfg, 12,
                       last_idx=torch.zeros(2, dtype=torch.int32))
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for step in range(3):
        pos = np.full(2, 6 + step, np.int32)
        jl, jc = japi.decode_fn(jp, {"token": jnp.asarray(nxt[:, None]),
                                     "position": jnp.asarray(pos)}, jc,
                                jcfg, backend="xla")
        tl, tc = api.decode_fn(tp, {"token": torch.from_numpy(nxt[:, None]),
                                    "position": torch.from_numpy(pos)}, tc,
                               tcfg)
        _close(tl, jl, f"decode step {step}")
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    empty = api.init_decode_cache(tcfg, 2, 12, device="cpu")
    assert tuple(empty["layers"][0]["xk"].shape) == (2, 12, 4, 16)


def test_convert_round_trip():
    fp = _fp()
    tp = convert.from_reference(fp)
    assert len(tp["enc"]["layers"]) == 2 and len(tp["dec"]["layers"]) == 2
    assert set(tp["dec"]["layers"][1]) == {"norm1", "self_attn", "norm2",
                                           "cross_attn", "norm3", "mlp"}
    back = convert.to_reference(tp)

    def same(a, b, path=()):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], path + (k,))
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))
    same(fp, back)
    # the port's own init builds the same tree shape
    init = api.init_model(_cfgs()[1], seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, convert.to_reference(
        init))) == jax.tree.structure(jax.tree.map(lambda a: 0, fp))


# ------------------------------------------------------------------- PTQ --
def test_calibration_set_matches_reference():
    jcfg, tcfg = _cfgs()
    jb = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    tb = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    for j, t in zip(jb, tb):
        assert set(t) == set(j) == {"tokens", "frames"}
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@functools.lru_cache(maxsize=None)
def _ref_ptq():
    """The JAX package's SmoothQuant+ of the bias-filled smoke model and
    its smoothing at the searched α: (quantized tree, report, s per group,
    smoothed fp tree)."""
    jcfg, _ = _cfgs()
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, rep = JAP.smoothquant_plus(_jp(), jcfg, batches,
                                   JQuantConfig(group_size=GROUP))
    col = JC.collect_stats(_jp(), jcfg, batches)
    smoothed, s_map = JSM.smooth_model(_jp(), jcfg, col, rep.alpha)
    return jq, rep, s_map, jax.tree.map(np.asarray, smoothed)


def _same_fp(j, t, path=()):
    """Every fp leaf of a reference tree against the port's, rtol 1e-5."""
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            _same_fp(j[k], t[k], path + (k,))
    elif not hasattr(j, "packed"):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7, err_msg=str(path))


def test_smoothquant_plus_matches_jax():
    jcfg, tcfg = _cfgs()
    jq, rep, s_map, jsmoothed = _ref_ptq()
    batches = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    col = TC.collect_stats(_tp(), tcfg, batches)
    assert {k[0] for k in col.stats} == {("enc",), ("dec",)}
    tsm, t_smap = TSM.smooth_model(_tp(), tcfg, col, rep.alpha)
    assert list(t_smap) == list(s_map) == [
        "enc.qkv", "enc.wo", "dec.qkv", "dec.wo", "dec.xq", "dec.xkv",
        "dec.xo", "enc.mlp.in", "enc.mlp.down", "dec.mlp.in",
        "dec.mlp.down"]
    for name, s in s_map.items():
        np.testing.assert_allclose(t_smap[name], s, rtol=1e-5, err_msg=name)
    xkv = t_smap["dec.xkv"]
    assert xkv.shape == (2, 64) and np.array_equal(xkv[0], xkv[1])
    assert (t_smap["enc.mlp.down"] == 1).all()
    # the smoothed fp model tensor by tensor: enc.final_norm carries 1/s
    # once, whatever the decoder's depth
    _same_fp(jsmoothed, convert.to_reference(tsm))
    fn = _fp()["enc"]["final_norm"]
    np.testing.assert_allclose(
        tsm["enc"]["final_norm"]["scale"].numpy(), fn["scale"] / xkv[0],
        rtol=1e-6)

    tq, trep = TAP.smoothquant_plus(_tp(), tcfg, batches,
                                    QuantConfig(group_size=GROUP))
    assert trep.alpha == rep.alpha
    for a in rep.loss_curve:
        np.testing.assert_allclose(trep.loss_curve[a], rep.loss_curve[a],
                                   rtol=1e-4)
    assert trep.a8_eligibility == rep.a8_eligibility
    assert list(trep.a8_eligibility) == [
        "/".join(p) for p in rep.quantized_paths]
    assert trep.a8_errors.keys() == rep.a8_errors.keys()
    assert (trep.fp_bytes, trep.quant_bytes) == (rep.fp_bytes,
                                                 rep.quant_bytes)
    assert set(TAP._reference_paths(trep.quantized_paths)) == {
        tuple(p) for p in rep.quantized_paths}
    back = convert.to_reference(tq)
    for p in rep.quantized_paths:
        qt, jqt = TSM.tget(back, p), TSM.tget(jq, p)
        assert qt.a8 == jqt.a8, p
        g = jqt.group_size
        for i in range(jqt.packed.shape[0]):
            np.testing.assert_array_equal(
                unpack_codes(qt.packed[i], g).numpy(),
                np.asarray(j_unpack(jqt.packed[i], g)), err_msg=str(p))
        np.testing.assert_allclose(qt.scales.numpy(), np.asarray(jqt.scales),
                                   rtol=1e-5, err_msg=str(p))
    _same_fp(jax.tree.map(np.asarray, jq), back)


def test_awq_matches_reference():
    """AWQ's α per group (G=16, step 0.25): ``dec.xkv`` takes one ``s``,
    the max over the decoder layers' ``s`` (the reference's
    ``layer_reduce`` branch); the groups with no provider get no α; every
    int4 code equals the reference's."""
    jcfg, tcfg = _cfgs()
    jq, jalphas = JAWQ.awq_quantize(
        _jp(), jcfg, JC.synthetic_calibration_set(jcfg, n_seqs=2,
                                                  seq_len=24),
        JQuantConfig(group_size=GROUP), step=0.25)
    tq, talphas = TAWQ.awq_quantize(
        _tp(), tcfg, TC.synthetic_calibration_set(tcfg, n_seqs=2,
                                                  seq_len=24),
        QuantConfig(group_size=GROUP), step=0.25)
    assert talphas == jalphas
    assert "dec.xkv" in talphas and "enc.mlp.down" not in talphas
    back = convert.to_reference(tq)
    for p in JAP.quantizable_paths(jcfg):
        qt, jqt = TSM.tget(back, p), TSM.tget(jq, p)
        for i in range(jqt.packed.shape[0]):
            np.testing.assert_array_equal(
                unpack_codes(qt.packed[i], jqt.group_size).numpy(),
                np.asarray(j_unpack(jqt.packed[i], jqt.group_size)))
    _same_fp(jax.tree.map(np.asarray, jq), back)


def _same_tree(j, t, path=()):
    """A reference-layout tree against the port's ``to_reference`` host
    tree, bit for bit (a8 flags too)."""
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            _same_tree(j[k], t[k], path + (k,))
    elif isinstance(j, JQT):
        assert isinstance(t, QuantizedTensor) and t.a8 == j.a8, path
        for f in ("packed", "scales", "zeros"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
    else:
        assert str(t.dtype) == f"torch.{np.asarray(j).dtype}", path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_artifact_cross_loads(direction, tmp_path):
    jcfg, tcfg = _cfgs()
    jq, rep, _, _ = _ref_ptq()
    jqcfg, tqcfg = JQuantConfig(group_size=GROUP), QuantConfig(
        group_size=GROUP)
    assert TAP.ptq_fingerprint(tcfg, tqcfg) == JAP.ptq_fingerprint(jcfg,
                                                                    jqcfg)
    art = tmp_path / "art"
    if direction == "jax_to_port":
        JAP.save_ptq(art, jq, rep, jcfg, jqcfg)
        assert TAP.ptq_matches(art, tcfg, tqcfg)
        got, trep = TAP.load_ptq(art, tcfg, tqcfg, device="cpu")
        _same_tree(jq, convert.to_reference(got))
        assert trep.a8_eligibility == rep.a8_eligibility
        assert set(TAP._reference_paths(trep.quantized_paths)) == {
            tuple(p) for p in rep.quantized_paths}
    else:
        tp = convert.from_reference(jax.tree.map(np.asarray, jq))
        n = {"enc": tcfg.enc_layers, "dec": tcfg.num_layers}
        trep = TAP.PTQReport(
            alpha=rep.alpha, search_loss=rep.search_loss,
            loss_curve=rep.loss_curve,
            quantized_paths=[(p[0], i) + tuple(p[2:])
                             for p in rep.quantized_paths
                             for i in range(n[p[0]])],
            fp_bytes=rep.fp_bytes, quant_bytes=rep.quant_bytes,
            a8_eligibility=rep.a8_eligibility, a8_errors=rep.a8_errors)
        TAP.save_ptq(art, tp, trep, tcfg, tqcfg)
        assert JAP.ptq_matches(art, jcfg, jqcfg)
        got, jrep = JAP.load_ptq(art, jcfg, jqcfg)
        _same_tree(got, convert.to_reference(tp))
        assert jrep.a8_eligibility == rep.a8_eligibility
        assert [tuple(p) for p in jrep.quantized_paths] == [
            tuple(p) for p in rep.quantized_paths]


# ------------------------------------------------ wv bias (reference side) --
def _logit_gap(fwd, params_a, params_b, fr, toks) -> float:
    a, b = fwd(params_a, fr, toks), fwd(params_b, fr, toks)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


WV_PATHS = (("enc", "layers", "self_attn", "wv", "b"),
            ("dec", "layers", "self_attn", "wv", "b"),
            ("dec", "layers", "cross_attn", "wv", "b"))


def test_wv_bias_smoothing_gap_matches_reference():
    """Reference-side finding on whisper, pinned, not fixed: the ``*.wo``
    and ``dec.xo`` groups' provider is a ``wv`` with a bias, and smoothing
    divides ``wv``'s weight columns by s but not its bias.  With every bias
    drawn from N(0, 0.5²) and α = 0.5 both packages smooth to the same
    params (each ``wv.b`` untouched) and show the same nonzero relative L2
    logit gap; with the three ``wv.b`` zeroed both gaps vanish."""
    jcfg, tcfg = _cfgs()
    fr = _frames(2, 10, 8)
    toks = np.random.default_rng(2).integers(2, 256, (2, 16)).astype(
        np.int32)

    def jfwd(p, f, t):
        return np.asarray(japi.forward_fn(
            p, {"frames": jnp.asarray(f), "tokens": jnp.asarray(t)}, jcfg,
            backend="xla"))

    def tfwd(p, f, t):
        return api.forward_fn(p, {"frames": torch.from_numpy(f),
                                  "tokens": torch.from_numpy(t)},
                              tcfg).numpy()

    gaps = {}
    for zero_wv in (False, True):
        fp = _fp(0.5)
        if zero_wv:
            fp = jax.tree.map(np.copy, fp)
            for p in WV_PATHS:
                node = TSM.tget(fp, p[:-1])
                node["b"] = np.zeros_like(node["b"])
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
        _same_fp(jax.tree.map(np.asarray, jsm), back)
        for p in WV_PATHS:
            np.testing.assert_array_equal(TSM.tget(back, p).numpy(),
                                          TSM.tget(fp, p))
        gaps[zero_wv] = (_logit_gap(jfwd, jp, jsm, fr, toks),
                         _logit_gap(tfwd, convert.from_reference(fp), tsm,
                                    fr, toks))
    (j_gap, t_gap), (j_zero, t_zero) = gaps[False], gaps[True]
    assert j_gap > 0.05 and t_gap > 0.05
    np.testing.assert_allclose(t_gap, j_gap, rtol=1e-3)
    assert j_zero < 1e-5 and t_zero < 1e-5
