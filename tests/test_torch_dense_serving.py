"""Serving parity for the registry's other dense decoders on their f32
smoke configs (llama3.2-3b, mistral-large-123b, chatglm3-6b, starcoder2-15b,
qwen2-vl-7b), every bias and LayerNorm shift drawn from a numpy seed into
the reference tree before conversion:

- the port's CPU engine on the JAX package's SmoothQuant+-quantized
  weights emits the JAX ``ServingEngine(backend="xla")``'s greedy tokens,
  token for token, through chunked prefill (chunks that read prefix pages)
  and paged decode;
- starcoder2's PTQ artifact (LayerNorm shifts and a bias on every linear)
  saved by either package loads in the other bitwise: codes, scales,
  zeros, fp leaves and ``a8`` flags;
- ``launch/serve.py --arch ID --smoke --device cpu`` serves each of the
  five.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import apply as JAP
from repro.core import calibration as JC
from repro.core.quantize import QuantizedTensor as JQT
from repro.models import api as japi
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import apply as TAP
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.models import convert
from repro_torch.serving import engine as TE

ARCHS = ["llama3.2-3b", "mistral-large-123b", "chatglm3-6b",
         "starcoder2-15b", "qwen2-vl-7b"]
GROUP = 16
ENGINE_KW = dict(batch_size=3, max_seq=48, page_size=8, max_prefill_tokens=16)
PROMPT_LENS = [5, 12, 20, 9, 14, 3, 17]
MAX_TOKENS = 6


def fill_biases(tree, seed: int, sd: float = 0.1):
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


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """The JAX config and its SmoothQuant+ (α = 0.5) of the bias-filled smoke
    model."""
    jcfg = j_get_config(arch, smoke=True).with_(dtype="float32")
    jp = fill_biases(jax.tree.map(
        np.asarray, japi.init_model(jax.random.PRNGKey(0), jcfg)), 3)
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, rep = JAP.smoothquant_plus(jax.tree.map(jnp.asarray, jp), jcfg,
                                   batches,
                                   JQuantConfig(group_size=GROUP, alpha=0.5))
    return jcfg, jq, rep


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine_greedy(arch):
    jcfg, jq, _ = _ref(arch)
    tcfg = get_config(arch, smoke=True).with_(dtype="float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    jeng = JE.ServingEngine(jq, jcfg, backend="xla", **ENGINE_KW)
    jreqs = [JE.Request(uid=i, prompt=p, max_tokens=MAX_TOKENS)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    tp = convert.from_reference(jax.tree.map(np.asarray, jq))
    eng = TE.ServingEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    reqs = [TE.Request(uid=i, prompt=p, max_tokens=MAX_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    eng.pager.check_invariants()
    assert all(r.finish_reason in ("completed", "length") for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert any(start > 0 for _, start in eng.stats.chunk_rows)


def _same_tree(j, t, path=()):
    """A reference-layout tree (JAX arrays / quantized weights) against the
    port's ``to_reference`` host tree, bit for bit."""
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
def test_starcoder2_artifact_cross_loads(direction, tmp_path):
    arch = "starcoder2-15b"
    jcfg, jq, rep = _ref(arch)
    tcfg = get_config(arch, smoke=True).with_(dtype="float32")
    jqcfg = JQuantConfig(group_size=GROUP, alpha=0.5)
    tqcfg = QuantConfig(group_size=GROUP, alpha=0.5)
    layers = jq["layers"]
    assert "bias" in layers["norm1"] and "b" in layers["mlp"]["down"]
    art = tmp_path / "art"
    if direction == "jax_to_port":
        JAP.save_ptq(art, jq, rep, jcfg, jqcfg)
        assert TAP.ptq_matches(art, tcfg, tqcfg)
        got, trep = TAP.load_ptq(art, tcfg, tqcfg, device="cpu")
        _same_tree(jq, convert.to_reference(got))
        assert trep.alpha == rep.alpha
        assert trep.a8_eligibility == rep.a8_eligibility
    else:
        tp = convert.from_reference(jax.tree.map(np.asarray, jq))
        trep = TAP.PTQReport(
            alpha=rep.alpha, search_loss=rep.search_loss,
            loss_curve=rep.loss_curve,
            quantized_paths=[(p[0], i) + tuple(p[1:])
                             for i in range(tcfg.num_layers)
                             for p in rep.quantized_paths],
            fp_bytes=rep.fp_bytes, quant_bytes=rep.quant_bytes,
            a8_eligibility=rep.a8_eligibility, a8_errors=rep.a8_errors)
        TAP.save_ptq(art, tp, trep, tcfg, tqcfg)
        assert JAP.ptq_matches(art, jcfg, jqcfg)
        got, jrep = JAP.load_ptq(art, jcfg, jqcfg)
        _same_tree(got, convert.to_reference(tp))
        assert jrep.alpha == rep.alpha
        assert jrep.a8_eligibility == rep.a8_eligibility


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke_cpu(arch):
    from repro_torch.launch import serve

    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "5", "--batch-size", "2", "--max-seq",
                      "48", "--max-prompt", "20", "--max-prefill-tokens",
                      "8"])
    cfg = res["cfg"]
    assert cfg.name == f"{arch}-smoke"
    assert all(r.finish_reason in ("completed", "length")
               for r in res["requests"])
    assert res["engine"].stats.completed == 5
    assert res["ptq_mode"] == "quantize-on-load"
    layer = res["engine"].params["layers"][0]
    assert isinstance(layer["mlp"]["down"]["w"], QuantizedTensor)
    if cfg.attn_bias:
        assert "b" in layer["mixer"]["wv"]
