"""Port parity for serving on the f32 codellama-7b and granite-moe-1b-a400m
smoke configs:

- the port's engine emits the same greedy tokens as the JAX
  ``ServingEngine(backend="xla")`` with the same converted params and
  prompts, fp and SmoothQuant+-quantized (token-for-token); for granite each
  package quantizes on load itself, under ``attn_impl`` "chunked" and
  "flash", A16 and ``a8_prefill``;
- ``launch/serve.py --arch granite-moe-1b-a400m --smoke --device cpu``
  serves;
- the port's engine matches the port's own unbatched greedy loop;
- the pager keeps its invariants; the top-k / top-p masks equal the
  reference's; no ``repro_torch`` module imports ``jax`` or ``repro``;
- with no card, the entry points raise instead of running on the CPU.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import apply as JAP
from repro.core import calibration as JC
from repro.models import api as japi
from repro.serving import engine as JE
from repro.serving.sampling import _filter_top_k_top_p as j_filter
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import lm as TLM
from repro_torch.serving import engine as TE
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving.sampling import filter_top_k_top_p

PROMPT_LENS = [5, 12, 20, 9, 14, 3, 17]
ENGINE_KW = dict(batch_size=3, max_seq=48, page_size=8, max_prefill_tokens=16)
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("codellama-7b", smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    batches = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    jq, _ = JAP.smoothquant_plus(jp, jcfg, batches,
                                 JQuantConfig(group_size=16))
    tcfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    return jcfg, tcfg, {"fp": jp, "sq+": jq}


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _serve_port(tp, tcfg, prompts):
    eng = TE.ServingEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    reqs = [TE.Request(uid=i, prompt=p, max_tokens=MAX_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    eng.pager.check_invariants()
    assert eng.pager.free_pages == eng.pager.num_pages - 1
    assert all(r.finish_reason in ("completed", "length") for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("kind", ["fp", "sq+"])
def test_engine_matches_jax_engine_greedy(models, kind):
    jcfg, tcfg, jparams = models
    prompts = _prompts(jcfg.vocab_size)
    jeng = JE.ServingEngine(jparams[kind], jcfg, backend="xla", **ENGINE_KW)
    jreqs = [JE.Request(uid=i, prompt=p, max_tokens=MAX_TOKENS)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()
    tp = convert.from_reference(jax.tree.map(np.asarray, jparams[kind]))
    assert _serve_port(tp, tcfg, prompts) == [r.output for r in jreqs]


@pytest.fixture(scope="module")
def granite_fp():
    jcfg = j_get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32")
    return jcfg, japi.init_model(jax.random.PRNGKey(0), jcfg)


@pytest.mark.parametrize("attn_impl,act_quant", [
    ("chunked", "a16"), ("flash", "a16"), ("chunked", "a8_prefill"),
    ("flash", "a8_prefill")])
def test_granite_engine_matches_jax_engine(granite_fp, attn_impl, act_quant):
    """Granite MoE: each package quantizes its own copy on load (the
    calibration passes run the flash kernel's plain version under
    ``attn_impl="flash"``, the reference its Pallas kernel in interpret
    mode), then serves; the greedy tokens are identical, A16 and A8."""
    jcfg, jp = granite_fp
    jimpl = "flash_interpret" if attn_impl == "flash" else "chunked"
    jc = jcfg.with_(attn_impl=jimpl, act_quant=act_quant)
    batches = JC.synthetic_calibration_set(jc, n_seqs=2, seq_len=24)
    jq, jrep = JAP.smoothquant_plus(jp, jc, batches,
                                    JQuantConfig(group_size=16))
    prompts = _prompts(jcfg.vocab_size)
    jeng = JE.ServingEngine(jq, jc, backend="xla", **ENGINE_KW)
    jreqs = [JE.Request(uid=i, prompt=p, max_tokens=MAX_TOKENS)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()

    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.calibration import synthetic_calibration_set

    tc = get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32", attn_impl=attn_impl, act_quant=act_quant)
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    tq, trep = TE.load_or_quantize(tp, tc, synthetic_calibration_set(
        tc, n_seqs=2, seq_len=24), QuantConfig(group_size=16))
    assert trep.alpha == jrep.alpha
    assert trep.a8_eligibility == jrep.a8_eligibility
    assert _serve_port(tq, tc, prompts) == [r.output for r in jreqs]


def test_serve_cli_granite_smoke_cpu():
    from repro_torch.launch import serve

    res = serve.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--device",
                      "cpu", "--requests", "5", "--batch-size", "2",
                      "--max-seq", "32", "--act-quant", "a8_prefill"],
                     attn_impl="flash")
    assert res["cfg"].attn_impl == "flash" and res["cfg"].family == "moe"
    assert all(r.finish_reason in ("completed", "length")
               for r in res["requests"])
    assert res["engine"].stats.completed == 5


def test_engine_matches_unbatched_greedy_loop(models):
    jcfg, tcfg, jparams = models
    tp = convert.from_reference(jax.tree.map(np.asarray, jparams["sq+"]))
    prompts = _prompts(jcfg.vocab_size)
    served = _serve_port(tp, tcfg, prompts)
    for prompt, out in zip(prompts, served):
        seq = torch.from_numpy(prompt)[None].long()
        want = []
        for _ in range(MAX_TOKENS):
            nxt = int(TLM.lm_forward(tp, seq, tcfg)[0, -1].argmax())
            want.append(nxt)
            if nxt == 1:                    # the engine's default EOS
                break
            seq = torch.cat([seq, torch.tensor([[nxt]])], dim=1)
        assert out == want


def test_pager_refcounts_and_invariants():
    pool = TKV.PagePool(9, 4, batch_size=3, max_pages_per_slot=3)
    a = pool.alloc(0, 2)
    pool.alloc(1, 1)
    pool.attach(2, a[:1])                   # shared read-only page
    assert pool.page_ref(a[0]) == 2
    pool.check_invariants()
    TKV.assert_live_tables(pool.table(), np.array([5, 2, 0]), 4,
                           [True, True, False], refs=pool.refs())
    with pytest.raises(TKV.PagerInvariantError, match="stale"):
        TKV.assert_live_tables(pool.table(), np.array([9, 0, 0]), 4,
                               [True, False, False])
    with pytest.raises(TKV.PagerInvariantError, match="shared"):
        TKV.assert_live_tables(pool.table(), np.array([0, 0, 1]), 4,
                               [False, False, True], refs=pool.refs())
    pool.free_slot(0)
    assert pool.page_ref(a[0]) == 1 and pool.free_pages == 8 - 2
    pool.free_slot(2)
    pool.free_slot(1)
    pool.check_invariants()
    assert pool.free_pages == 8


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.7),
                                         (4, 0.5), ([0, 3], [0.9, 1.0])])
def test_top_k_top_p_masks_match(top_k, top_p):
    logits = np.random.default_rng(0).standard_normal((2, 40)).astype(
        np.float32) * 3
    ref = j_filter(jnp.asarray(logits),
                   np.asarray(top_k) if isinstance(top_k, list) else top_k,
                   np.asarray(top_p, np.float32)
                   if isinstance(top_p, list) else top_p)
    tk = torch.tensor(top_k) if isinstance(top_k, list) else top_k
    tpp = torch.tensor(top_p) if isinstance(top_p, list) else top_p
    out = filter_top_k_top_p(torch.from_numpy(logits), tk, tpp)
    np.testing.assert_array_equal(out.numpy() <= -1e29,
                                  np.asarray(ref) <= -1e29)


def test_port_imports_neither_jax_nor_reference():
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "assert len(mods) >= 20, mods\n"
        "new = {'repro_torch.serving.' + m for m in "
        "('faults', 'prefix_cache', 'metrics', 'trace')}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=src,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    jcfg, tcfg, jparams = models
    from repro_torch.launch import serve
    from repro_torch.models import api

    tp = convert.from_reference(jax.tree.map(np.asarray, jparams["fp"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.ServingEngine(tp, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_model(tcfg)


def test_unported_features_raise(models):
    _, tcfg, _ = models
    for kw in (dict(mixer="mamba2"), dict(family="hybrid"),
               dict(family="audio")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcfg.with_(**kw).check()
    # MLA is ported, but only with its MLAConfig
    with pytest.raises(ValueError, match="disagree"):
        tcfg.with_(mixer="mla").check()
    # int8 KV pools, W4A8 prefill, the flash kernel and tied embeddings are
    # ported: check() accepts them
    for kw in (dict(kv_quant=True), dict(act_quant="a8_prefill"),
               dict(kv_quant=True, act_quant="a8_prefill"),
               dict(attn_impl="flash"), dict(tie_embeddings=True)):
        tcfg.with_(**kw).check()
    gcfg = get_config("granite-moe-1b-a400m", smoke=True)
    gcfg.with_(attn_impl="flash").check()
    get_config("deepseek-v2-236b").check()
    # the router stays f32 and is never quantized: other settings raise
    with pytest.raises(NotImplementedError, match="router_dtype"):
        gcfg.with_(moe=dataclasses.replace(
            gcfg.moe, router_dtype="bfloat16")).check()
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.apply import quantize_params
    with pytest.raises(NotImplementedError, match="skip_router"):
        quantize_params({"layers": []}, gcfg, QuantConfig(skip_router=False))
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("zamba2-7b")


@pytest.mark.parametrize("gs", [12, 4, 0, -8])
def test_serve_refuses_groups_no_kernel_takes(monkeypatch, capsys, gs):
    """A group size that no W4 kernel takes (G % 8 != 0, or G <= 0) is
    refused by the serve entry before the model is built or calibration
    starts, on the CPU as on the card."""
    from repro_torch.launch import serve

    def started(*args, **kwargs):
        raise AssertionError("the serve entry went past its argument check")

    monkeypatch.setattr(serve, "synthetic_calibration_set", started)
    monkeypatch.setattr(serve, "resolve_device", started)
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--group-size", str(gs)])
    assert f"--group-size {gs}" in capsys.readouterr().err
