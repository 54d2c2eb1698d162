"""Port parity for DeepSeek-V2 (MLA + shared experts) on the f32
deepseek-v2-236b smoke config, against the JAX package on the same weights:

- the teacher-forced forward (expanded MLA through ``chunked_attention``,
  MoE with a shared expert): logits rtol/atol 1e-4;
- calibration statistics: the same keys (the MLA linears and the shared
  expert's), values rtol 1e-5;
- SmoothQuant+ end to end: the same α on a grid of step 0.25 (loss curve
  rtol 1e-4), the same ``s`` per smoothing group (``mla.wo`` through
  ``linear_out_mla_v``, ``moe.shared.down`` included; rtol 1e-5), the same
  A8 flags (the absorbed pair reports one flag, A16), the same byte counts,
  and int4 codes equal up to rare rounding ties (the statistics differ by
  f32 summation order);
- on the same smoothed weights, ``quantize_params`` gives the reference's
  packed bytes, scales and zeros exactly, ``wkv_b_absorbed`` included;
- the port's CPU engine, fp and int8 latent pools, on the reference's
  quantized weights, emits the JAX ``ServingEngine(backend="xla")``'s
  greedy tokens;
- ``launch/serve.py --arch deepseek-v2-236b --smoke --device cpu`` serves;
- MLA's contiguous latent cache: ``api.prefill_fn`` and five greedy
  ``api.decode_fn`` steps, fp and on the reference's quantized weights,
  against the JAX package's step by step (logits rtol/atol 1e-4, the
  reference's next tokens fed to both; cache rows rtol/atol 1e-5; the same
  greedy tokens), and ``init_decode_cache``'s leaves against the
  reference's ``[L, ...]`` stacks;
- ``kernels.ops.quantized_linear`` (K1 plus a bias) against the reference's
  ``backend="xla"`` at rtol/atol 1e-5 (f32, sums in another order).
"""
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
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import apply as TAP
from repro_torch.core import calibration as TC
from repro_torch.core import smoothing as TSM
from repro_torch.core.quantize import QuantizedTensor, unpack_codes
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import lm as TLM
from repro_torch.serving import engine as TE

GROUP = 16
ARCH = "deepseek-v2-236b"
# a coarser α grid than the default 0.05 keeps the reference's search short;
# both packages search the same grid
STEP = 0.25


@pytest.fixture(scope="module")
def ref():
    jcfg = j_get_config(ARCH, smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jp)
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, rep = JAP.smoothquant_plus(jp, jcfg, batches,
                                   JQuantConfig(group_size=GROUP), step=STEP)
    col = JC.collect_stats(jp, jcfg, batches)
    smoothed, s_map = JSM.smooth_model(jp, jcfg, col, rep.alpha)
    return dict(jcfg=jcfg, np_params=np_params, jq=jq, rep=rep, col=col,
                s_map=s_map, smoothed=jax.tree.map(np.asarray, smoothed))


def _tcfg():
    return get_config(ARCH, smoke=True).with_(dtype="float32")


def _calib(tcfg):
    return TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)


def test_deepseek_forward_matches_jax(ref):
    tcfg = _tcfg()
    toks = np.random.default_rng(1).integers(2, tcfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    want = japi.forward_fn(jax.tree.map(jnp.asarray, ref["np_params"]),
                           {"tokens": jnp.asarray(toks)}, ref["jcfg"],
                           backend="xla")
    got = TLM.lm_forward(convert.from_reference(ref["np_params"]),
                         torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_deepseek_calibration_stats_match(ref):
    tcfg = _tcfg()
    tcol = TC.collect_stats(convert.from_reference(ref["np_params"]), tcfg,
                            _calib(tcfg))
    jstats = ref["col"].stats
    assert set(tcol.stats) == set(jstats)
    subs = {k[2] for k in jstats}
    assert {("mixer", "wq_a", "w"), ("mixer", "wkv_b", "w"),
            ("mlp", "shared", "down", "w")} <= subs
    for key, v in jstats.items():
        np.testing.assert_allclose(tcol.stats[key], v, rtol=1e-5, atol=1e-7)


def test_deepseek_smoothquant_plus_matches(ref):
    tcfg, rep = _tcfg(), ref["rep"]
    tp = convert.from_reference(ref["np_params"])
    batches = _calib(tcfg)
    col = TC.collect_stats(tp, tcfg, batches)
    _, t_smap = TSM.smooth_model(convert.from_reference(ref["np_params"]),
                                 tcfg, col, rep.alpha)
    assert set(t_smap) == set(ref["s_map"]) == {
        "mla.a", "mla.qb", "mla.kvb", "mla.wo", "moe.in", "moe.down",
        "moe.shared.down"}
    for name, s in ref["s_map"].items():
        np.testing.assert_allclose(t_smap[name], s, rtol=1e-5)

    tq, trep = TAP.smoothquant_plus(tp, tcfg, batches,
                                    QuantConfig(group_size=GROUP), step=STEP)
    assert trep.alpha == rep.alpha
    for a in rep.loss_curve:
        np.testing.assert_allclose(trep.loss_curve[a], rep.loss_curve[a],
                                   rtol=1e-4)
    assert trep.a8_eligibility == rep.a8_eligibility
    assert trep.a8_eligibility["layers/mixer/wkv_b_absorbed"] is False
    for k, v in rep.a8_errors.items():
        np.testing.assert_allclose(trep.a8_errors[k], v, rtol=1e-4)
    assert trep.fp_bytes == rep.fp_bytes and trep.quant_bytes == rep.quant_bytes
    jq = ref["jq"]
    paths = TAP.quantizable_paths(tcfg) + [("mixer", "wkv_b_absorbed", "wk_t"),
                                           ("mixer", "wkv_b_absorbed", "wv")]
    for i, layer in enumerate(tq["layers"]):
        for wp in paths:
            qt, jqt = TSM.tget(layer, wp), TSM.tget(jq["layers"], wp)
            assert isinstance(qt, QuantizedTensor)
            g = qt.group_size
            a = unpack_codes(qt.packed, g).numpy().astype(np.int16)
            b = np.asarray(j_unpack(jqt.packed[i], g)).astype(np.int16)
            assert np.abs(a - b).max() <= 1
            assert (a != b).mean() <= 1e-3, wp
            np.testing.assert_allclose(qt.scales.numpy(),
                                       np.asarray(jqt.scales[i]), rtol=1e-5)


def test_deepseek_quantize_params_bytes_exact(ref):
    """From the same smoothed fp weights the two packages' RTN agree bit for
    bit, the absorbed pair's group-split packing along nope (wk_t) and r
    (wv) included."""
    tcfg = _tcfg()
    jcfg = ref["jcfg"]
    smoothed = ref["smoothed"]
    jq, jpaths, jfp, jqb = JAP.quantize_params(
        jax.tree.map(jnp.asarray, smoothed), jcfg,
        JQuantConfig(group_size=GROUP))
    tq, tpaths, tfp, tqb = TAP.quantize_params(
        convert.from_reference(smoothed), tcfg, QuantConfig(group_size=GROUP))
    assert (tfp, tqb) == (jfp, jqb)
    assert len(tpaths) == len(jpaths) * tcfg.num_layers
    for i, layer in enumerate(tq["layers"]):
        ab = layer["mixer"]["wkv_b_absorbed"]
        m = tcfg.mla
        assert ab["wk_t"].shape == (tcfg.num_heads, m.qk_nope_head_dim,
                                    m.kv_lora_rank)
        assert ab["wv"].shape == (tcfg.num_heads, m.kv_lora_rank,
                                  m.v_head_dim)
        for wp in TAP.quantizable_paths(tcfg) + [
                ("mixer", "wkv_b_absorbed", "wk_t"),
                ("mixer", "wkv_b_absorbed", "wv")]:
            qt, jqt = TSM.tget(layer, wp), TSM.tget(jq["layers"], wp)
            for f in ("packed", "scales", "zeros"):
                np.testing.assert_array_equal(
                    getattr(qt, f).numpy(), np.asarray(getattr(jqt, f)[i]))


ENGINE_KW = dict(batch_size=3, max_seq=48, page_size=8, max_prefill_tokens=16)
PROMPT_LENS = [5, 12, 20, 9, 14, 3, 17]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_deepseek_engine_matches_jax_engine_greedy(ref, kv_quant):
    jcfg = ref["jcfg"].with_(kv_quant=kv_quant)
    tcfg = _tcfg().with_(kv_quant=kv_quant)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    jeng = JE.ServingEngine(ref["jq"], jcfg, backend="xla", **ENGINE_KW)
    jreqs = [JE.Request(uid=i, prompt=p, max_tokens=6)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    tp = convert.from_reference(jax.tree.map(np.asarray, ref["jq"]))
    assert "wkv_b_absorbed" in tp["layers"][0]["mixer"]
    eng = TE.ServingEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    reqs = [TE.Request(uid=i, prompt=p, max_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    eng.pager.check_invariants()
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert any(start > 0 for _, start in eng.stats.chunk_rows)
    pool = eng.pools["layers"][0]
    assert set(pool) == ({"ckv", "kpe", "ckv_s", "kpe_s"} if kv_quant
                         else {"ckv", "kpe"})


def test_serve_cli_deepseek_smoke_cpu():
    from repro_torch.launch import serve

    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "5", "--batch-size", "2", "--max-seq",
                      "48", "--max-prompt", "20", "--max-prefill-tokens",
                      "8"])
    assert res["cfg"].mixer == "mla" and res["cfg"].moe.num_shared_experts
    assert all(r.finish_reason in ("completed", "length")
               for r in res["requests"])
    assert res["engine"].stats.completed == 5
    assert "wkv_b_absorbed" in res["engine"].params["layers"][0]["mixer"]


@pytest.mark.parametrize("quant", [False, True])
def test_deepseek_contiguous_cache_steps_match_jax(ref, quant):
    jcfg, tcfg = ref["jcfg"], _tcfg()
    jp = ref["jq"] if quant else jax.tree.map(jnp.asarray, ref["np_params"])
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(3).integers(
        2, jcfg.vocab_size, (2, 12)).astype(np.int32)
    smax = 20
    jl, jc = japi.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg, smax,
                             backend="xla")
    tl, tc = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                             smax)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for i, lc in enumerate(tc["layers"]):
        assert set(lc) == {"ckv", "kpe", "lens"}
        for k in ("ckv", "kpe"):
            np.testing.assert_allclose(lc[k].numpy(),
                                       np.asarray(jc["layers"][k][i]),
                                       rtol=1e-5, atol=1e-5)
        assert lc["lens"].tolist() == [12, 12]
    jdecode = jax.jit(lambda p, b, c: japi.decode_fn(p, b, c, jcfg,
                                                     backend="xla"))
    for step in range(5):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert tl.argmax(-1).tolist() == nxt.tolist(), f"step {step}"
        pos = np.full(2, 12 + step, np.int32)
        jl, jc = jdecode(jp, {"token": jnp.asarray(nxt[:, None]),
                              "position": jnp.asarray(pos)}, jc)
        tl, tc = tapi.decode_fn(
            tp, {"token": torch.from_numpy(nxt[:, None]),
                 "position": torch.from_numpy(pos)}, tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
    assert tc["layers"][0]["lens"].tolist() == [17, 17]


def test_deepseek_init_decode_cache_matches_jax(ref):
    from repro.models import lm as JLM

    jc = JLM.init_cache(ref["jcfg"], 3, 10)
    tc = tapi.init_decode_cache(_tcfg(), 3, 10, device="cpu")
    assert len(tc["layers"]) == ref["jcfg"].num_layers
    for k, leaf in jc["layers"].items():
        for lc in tc["layers"]:
            assert tuple(lc[k].shape) == leaf.shape[1:], k
            assert str(lc[k].dtype).removeprefix("torch.") == str(leaf.dtype)


def test_quantized_linear_matches_jax():
    from repro.core import quantize as JQ
    from repro.kernels import ops as JOPS
    from repro_torch.kernels import ops as TOPS

    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.125).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jqt = JQ.quantize(jnp.asarray(w), GROUP)
    want = JOPS.quantized_linear(jnp.asarray(x), jqt, jnp.asarray(bias),
                                 backend="xla")
    tqt = QuantizedTensor(*(torch.from_numpy(np.array(getattr(jqt, f)))
                            for f in ("packed", "scales", "zeros")))
    got = TOPS.quantized_linear(torch.from_numpy(x), tqt,
                                torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        TOPS.quantized_linear(torch.from_numpy(x), tqt).numpy(),
        np.asarray(JOPS.quantized_linear(jnp.asarray(x), jqt,
                                         backend="xla")), rtol=1e-5,
        atol=1e-5)
