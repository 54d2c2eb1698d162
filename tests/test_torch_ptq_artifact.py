"""The PTQ artifact across the two packages: the config fingerprint, an
artifact saved by the JAX package and loaded by the port (and the other way
round), bitwise (codes, scales, zeros, fp leaves, ``a8`` flags) with equal
reports, for codellama smoke, granite smoke (stacked experts, tied
embeddings) and deepseek smoke (the MLA absorbed pair); ``to_reference`` as
the inverse of ``from_reference``; stale, corrupt and refreshed artifacts in
``load_or_quantize``; the serve entry's ``--ptq-artifact``.

The JAX trees are quantized by its ``quantize_params`` with an ``a8`` map
that sets some paths and clears others (the absorbed pair among the
cleared), so the flags the artifact must carry are not all the default."""
import dataclasses
import json
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.checkpoint import manager as JCK
from repro.core import apply as JAP
from repro.core.quantize import QuantizedTensor as JQT
from repro.models import api as japi
from repro_torch.checkpoint import manager as TCK
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import apply as TAP
from repro_torch.core import calibration as TC
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.serving.engine import load_or_quantize

GROUP = 16
ARCHS = ["codellama-7b", "granite-moe-1b-a400m", "deepseek-v2-236b"]
QCFGS = {"default": {}, "g16": dict(group_size=16),
         "g256_alpha": dict(group_size=256, alpha=0.5),
         "a8_threshold": dict(a8_threshold=0.02),
         "disabled": dict(enabled=False)}


@pytest.mark.parametrize("act_quant", ["a16", "a8_prefill"])
@pytest.mark.parametrize("qname", list(QCFGS))
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fingerprint_matches_reference(arch, smoke, qname, act_quant):
    """Both packages hash the same string: the port renders the
    reference's ``repr`` with the fields it does not carry."""
    q = QCFGS[qname]
    want = JAP.ptq_fingerprint(
        j_get_config(arch, smoke=smoke).with_(act_quant=act_quant),
        JQuantConfig(**q))
    got = TAP.ptq_fingerprint(
        get_config(arch, smoke=smoke).with_(act_quant=act_quant),
        QuantConfig(**q))
    assert got == want


# ------------------------------------------------------------ fixtures ----
def _jax_quantized(arch):
    """A JAX quantized smoke tree, its report and the configs."""
    jcfg = j_get_config(arch, smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    qcfg = JQuantConfig(group_size=GROUP)
    wps = JAP.quantizable_paths(jcfg)
    a8_map = {wp: i % 2 == 0 for i, wp in enumerate(wps)}
    jq, paths, fpb, qb = JAP.quantize_params(jp, jcfg, qcfg, a8_map=a8_map)
    rep = JAP.PTQReport(
        alpha=0.45, search_loss=1.25, loss_curve={0.0: 2.5, 0.45: 1.25},
        quantized_paths=paths, fp_bytes=fpb, quant_bytes=qb,
        a8_eligibility=JAP._tree_a8_flags(jq, paths),
        a8_errors={"/".join(wp): 0.001 * (i + 1) for i, wp in enumerate(wps)})
    return jcfg, qcfg, jq, rep


@pytest.fixture(scope="module")
def ref():
    return {arch: _jax_quantized(arch) for arch in ARCHS}


def _tcfgs(arch):
    return (get_config(arch, smoke=True).with_(dtype="float32"),
            QuantConfig(group_size=GROUP))


def _port_report(rep, n_layers):
    """The JAX report in the port's form (per-layer quantized paths)."""
    return TAP.PTQReport(
        rep.alpha, rep.search_loss, dict(rep.loss_curve),
        [(p[0], i) + tuple(p[1:]) for i in range(n_layers)
         for p in rep.quantized_paths],
        rep.fp_bytes, rep.quant_bytes, dict(rep.a8_eligibility),
        dict(rep.a8_errors))


def _assert_port_equal(a, b):
    """Two port trees, bitwise: structure, dtypes, values, a8 flags."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
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
    """Two JAX trees, bitwise."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_jax_equal(a[k], b[k])
    elif isinstance(a, JQT):
        assert isinstance(b, JQT) and a.a8 == b.a8
        for f in ("packed", "scales", "zeros"):
            _assert_jax_equal(getattr(a, f), getattr(b, f))
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.astype(np.float32) if x.dtype.kind == "V"
                              else x, y.astype(np.float32)
                              if y.dtype.kind == "V" else y)


def _assert_report_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "quantized_paths":
            x, y = [tuple(map(str, p)) for p in x], [tuple(map(str, p))
                                                      for p in y]
        assert x == y, f.name


# -------------------------------------------------------- across packages -
@pytest.mark.parametrize("arch", ARCHS)
def test_jax_artifact_loads_in_port(ref, arch, tmp_path):
    jcfg, jqcfg, jq, rep = ref[arch]
    JAP.save_ptq(tmp_path / "art", jq, rep, jcfg, jqcfg)
    tcfg, tqcfg = _tcfgs(arch)
    assert TAP.ptq_matches(tmp_path / "art", tcfg, tqcfg)
    got, trep = TAP.load_ptq(tmp_path / "art", tcfg, tqcfg, device="cpu")
    want = convert.from_reference(jax.tree.map(np.asarray, jq))
    _assert_port_equal(got, want)
    assert not all(rep.a8_eligibility.values())     # some flags cleared
    _assert_report_equal(trep, _port_report(rep, tcfg.num_layers))
    assert trep.a8_eligibility == TAP._tree_a8_flags(got, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_artifact_loads_in_jax(ref, arch, tmp_path):
    jcfg, jqcfg, jq, rep = ref[arch]
    tcfg, tqcfg = _tcfgs(arch)
    tp = convert.from_reference(jax.tree.map(np.asarray, jq))
    TAP.save_ptq(tmp_path / "art", tp, _port_report(rep, tcfg.num_layers),
                 tcfg, tqcfg)
    assert JAP.ptq_matches(tmp_path / "art", jcfg, jqcfg)
    got, jrep = JAP.load_ptq(tmp_path / "art", jcfg, jqcfg)
    _assert_jax_equal(got, jq)
    _assert_report_equal(jrep, rep)
    if arch != "codellama-7b":
        return                            # the trees are equal bitwise
    toks = jnp.asarray(np.random.default_rng(1).integers(
        2, jcfg.vocab_size, (2, 8)), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(japi.forward_fn(got, {"tokens": toks}, jcfg)),
        np.asarray(japi.forward_fn(jq, {"tokens": toks}, jcfg)))


@pytest.mark.parametrize("arch", ARCHS)
def test_to_reference_inverts_from_reference(ref, arch):
    jq = jax.tree.map(np.asarray, ref[arch][2])
    tp = convert.from_reference(jq)
    back = convert.to_reference(tp)

    def same(j, t):
        if isinstance(j, dict):
            assert set(j) == set(t)
            for k in j:
                same(j[k], t[k])
        elif isinstance(j, JQT):
            assert isinstance(t, QuantizedTensor) and t.a8 == j.a8
            for f in ("packed", "scales", "zeros"):
                same(getattr(j, f), getattr(t, f))
        else:
            assert str(t.dtype) == f"torch.{j.dtype}"
            np.testing.assert_array_equal(t.numpy(), j)

    same(jq, back)
    _assert_port_equal(convert.from_reference(back), tp)


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bf16 is widened to f32 in the npz and narrowed back by its dtype
    name, in either package."""
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    JCK.save_ptq_artifact(tmp_path / "j", {"a": {"w": jnp.asarray(
        x, jnp.bfloat16)}})
    tree, meta = TCK.load_ptq_artifact(tmp_path / "j")
    assert meta["dtypes"] == {f"a{TCK.SEP}w": "bfloat16"}
    assert tree["a"]["w"].dtype == torch.bfloat16
    want = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(tree["a"]["w"], want)
    TCK.save_ptq_artifact(tmp_path / "t", {"a": {"w": want}})
    meta = json.loads((tmp_path / "t" / "meta.json").read_text())
    assert meta["dtypes"] == {f"a{TCK.SEP}w": "bfloat16"}
    jtree, _ = JCK.load_ptq_artifact(tmp_path / "t")
    assert jtree["a"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jtree["a"]["w"].astype(jnp.float32)),
        want.float().numpy())


# ------------------------------------------------------ load_or_quantize --
def _codellama():
    """codellama smoke with α given (no search: the recipe runs fast)."""
    tcfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    tqcfg = QuantConfig(group_size=GROUP, alpha=0.5)
    return (tcfg, tqcfg, lambda: tapi.init_model(tcfg, seed=0, device="cpu"),
            TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The port's own PTQ of codellama smoke, saved by load_or_quantize."""
    tcfg, tqcfg, init, calib = _codellama()
    d = tmp_path_factory.mktemp("ptq") / "art"
    qp, rep = load_or_quantize(init(), tcfg, calib, tqcfg, artifact_dir=d,
                               device="cpu")
    return d, qp, rep


def _boot(d, params_fp=None, **kw):
    """load_or_quantize from ``d``: (params, report, batches read)."""
    tcfg, tqcfg, _, calib = _codellama()
    seen = TC.collect_stats.batches
    qp, rep = load_or_quantize(params_fp, tcfg, calib, tqcfg, artifact_dir=d,
                               device="cpu", **kw)
    return qp, rep, TC.collect_stats.batches - seen


def test_matching_artifact_loads_without_calibration(saved):
    d, qp, rep = saved
    got, grep, read = _boot(d)
    assert read == 0
    _assert_port_equal(got, qp)
    _assert_report_equal(grep, rep)


def test_stale_hash_raises(saved, tmp_path):
    d, _, _ = saved
    tcfg, tqcfg, _, _ = _codellama()
    assert TAP.ptq_matches(d, tcfg, tqcfg)
    other = dataclasses.replace(tqcfg, group_size=2 * GROUP)
    assert not TAP.ptq_matches(d, tcfg, other)
    with pytest.raises(TAP.StalePTQArtifactError):
        TAP.load_ptq(d, tcfg, other, device="cpu")


def _spoil(d, how):
    meta = d / "meta.json"
    if how == "stale":
        m = json.loads(meta.read_text())
        m["config_hash"] = "0" * 16
        meta.write_text(json.dumps(m))
    elif how == "format":
        m = json.loads(meta.read_text())
        m["format_version"] = 99
        meta.write_text(json.dumps(m))
    elif how == "meta":
        meta.write_text(meta.read_text()[:40])
    else:
        npz = d / "arrays.npz"
        npz.write_bytes(npz.read_bytes()[:1000])


@pytest.mark.parametrize("how", ["stale", "format", "meta", "npz"])
def test_unusable_artifact_requantizes_and_resaves(saved, tmp_path, how):
    """A stale hash, an unknown format, a corrupt meta.json or arrays.npz:
    with fp params the recipe runs again and the artifact is saved anew;
    without them the load error is raised."""
    d = tmp_path / "art"
    shutil.copytree(saved[0], d)
    _spoil(d, how)
    tcfg, tqcfg, init, _ = _codellama()
    with pytest.raises((ValueError, KeyError, OSError, zipfile.BadZipFile)):
        _boot(d)
    got, _, read = _boot(d, init())
    assert read == 4                      # two passes of two batches
    _assert_port_equal(got, saved[1])
    assert TAP.ptq_matches(d, tcfg, tqcfg)
    assert _boot(d)[2] == 0


def test_save_is_atomic_and_refresh_requantizes(saved, tmp_path):
    """A save goes through ``<dir>.tmp`` (a stale one is cleared) and
    replaces the old artifact by rename, leaving neither behind;
    ``refresh=True`` re-quantizes over a matching artifact."""
    d = tmp_path / "art"
    shutil.copytree(saved[0], d)
    (tmp_path / "art.tmp").mkdir()
    (tmp_path / "art.tmp" / "junk").write_text("half a save")
    _, tqcfg, init, _ = _codellama()
    got, _, read = _boot(d, init(), refresh=True)
    assert read == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["art"]
    assert sorted(p.name for p in d.iterdir()) == ["arrays.npz", "meta.json"]
    _assert_port_equal(got, saved[1])
    assert _boot(d)[2] == 0


def test_serve_boots_from_artifact(tmp_path):
    """serve --ptq-artifact: the first boot quantizes and saves, the second
    loads with no calibration, and both serve the same tokens."""
    argv = ["--smoke", "--device", "cpu", "--requests", "4",
            "--batch-size", "2", "--max-seq", "48", "--ptq-artifact",
            str(tmp_path / "art")]
    first = tserve.main(argv)
    second = tserve.main(argv)
    assert first["ptq_mode"] == "quantize-on-load"
    assert first["calib_batches"] == 2
    assert second["ptq_mode"] == "artifact-load"
    assert second["calib_batches"] == 0
    assert second["ptq_artifact_bytes"] == first["ptq_artifact_bytes"] > 0
    assert [r.output for r in second["requests"]] == \
        [r.output for r in first["requests"]]
    third = tserve.main(argv + ["--ptq-refresh"])
    assert third["ptq_mode"] == "quantize-on-load"
