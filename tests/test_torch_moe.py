"""Port parity for the MoE on the f32 granite-moe-1b-a400m smoke config:
the sort-based dispatch bookkeeping (equal, capacity drops included),
``apply_moe`` with fp and int4 experts, A16 and A8, against the
reference's ``apply_moe(backend="xla")`` (atol 1e-5 on outputs, rtol 1e-5
on the aux loss: f32 sums in another order), the converted params (expert
stacks split per layer, no ``lm_head`` under tied embeddings), the tied
head, and the calibration statistics of the MoE taps (rtol 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import calibration as JC
from repro.core import quantize as jq
from repro.models import api as japi
from repro.models import lm as JLM
from repro.models import mlp as JM
from repro_torch.configs import get_config
from repro_torch.core import calibration as TC
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.models import convert
from repro_torch.models import lm as TLM
from repro_torch.models import mlp as TM


def _cfgs(**kw):
    jcfg = j_get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32", **kw)
    tcfg = get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32", **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp


@pytest.mark.parametrize("n,e,cap,seed", [(7, 4, 2, 0), (40, 4, 12, 1),
                                          (64, 8, 5, 2), (200, 32, 9, 3),
                                          (33, 2, 40, 4)])
def test_dispatch_indices_equal_reference(n, e, cap, seed):
    ids = np.random.default_rng(seed).integers(0, e, n).astype(np.int32)
    jb, jk = JM._dispatch_indices(jnp.asarray(ids), e, cap)
    tb, tk, tc = TM._dispatch_indices(torch.from_numpy(ids), e, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.bincount(ids, minlength=e))


def test_dispatch_capacity_drops_at_half_capacity_factor(model):
    """capacity_factor=0.5: the reference's capacity formula and drop set
    over the top-k slots of 40 tokens."""
    jcfg, tcfg, _ = model
    m = dataclasses.replace(tcfg.moe, capacity_factor=0.5)
    n = 40
    cap = TM.moe_capacity(n, m)
    assert cap == max(int(n * m.top_k / m.num_experts * 0.5), m.top_k)
    ids = np.random.default_rng(9).integers(
        0, m.num_experts, n * m.top_k).astype(np.int32)
    jb, jk = JM._dispatch_indices(jnp.asarray(ids), m.num_experts, cap)
    tb, tk, _ = TM._dispatch_indices(torch.from_numpy(ids), m.num_experts,
                                     cap)
    assert not bool(tk.all())
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def _moe_params(jp, kind):
    """Layer 0's MoE params (reference tree) fp, or with int4 experts."""
    p = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    if kind == "int4":
        p = dict(p, experts={k: jq.quantize(v, group_size=16)
                             for k, v in p["experts"].items()})
    return p


@pytest.mark.parametrize("kind", ["fp", "int4"])
@pytest.mark.parametrize("cf,act_quant", [(4.0, "a16"), (0.5, "a16"),
                                          (4.0, "a8_prefill")])
def test_apply_moe_matches_reference(model, kind, cf, act_quant):
    """cf=0.5 drops token slots at capacity; a8_prefill with 12 tokens gives
    a per-expert capacity of 24 rows, so int4 experts take the A8 body."""
    jcfg0, tcfg0, jp = model
    m = dataclasses.replace(jcfg0.moe, capacity_factor=cf)
    jcfg = jcfg0.with_(moe=m, act_quant=act_quant)
    tcfg = tcfg0.with_(moe=dataclasses.replace(tcfg0.moe, capacity_factor=cf),
                       act_quant=act_quant)
    jmp = _moe_params(jp, kind)
    tmp = convert._convert(jax.tree.map(np.asarray, jmp), "cpu")
    if kind == "int4":
        assert isinstance(tmp["experts"]["gate"], QuantizedTensor)
    x = np.random.default_rng(1).standard_normal(
        (2, 6, jcfg.d_model)).astype(np.float32)
    jy, jaux = JM.apply_moe(jmp, jnp.asarray(x), jcfg, backend="xla")
    ty, taux = TM.apply_moe(tmp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if cf < 1:      # fewer buffer rows than token slots: some dropped
        assert TM.moe_capacity(12, tcfg.moe) * tcfg.moe.num_experts \
            < 12 * tcfg.moe.top_k


def test_convert_splits_expert_stacks_and_ties_head(model):
    jcfg, tcfg, jp = model
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    assert "lm_head" not in tp and len(tp["layers"]) == jcfg.num_layers
    m = jcfg.moe
    for i, lp in enumerate(tp["layers"]):
        g = lp["mlp"]["experts"]["gate"]
        assert tuple(g.shape) == (m.num_experts, jcfg.d_model, m.d_expert)
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jp["layers"]["mlp"]["experts"]["gate"][i]))
        assert tuple(lp["mlp"]["experts"]["down"].shape) == (
            m.num_experts, m.d_expert, jcfg.d_model)
    toks = np.random.default_rng(2).integers(2, jcfg.vocab_size, (2, 11)
                                             ).astype(np.int32)
    jl, _ = JLM.lm_forward(jp, jnp.asarray(toks), jcfg, backend="xla")
    tl = TLM.lm_forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_init_model_moe_shapes():
    _, tcfg = _cfgs()
    from repro_torch.models import api as tapi

    tp = tapi.init_model(tcfg, device="cpu")
    assert "lm_head" not in tp
    mlp = tp["layers"][0]["mlp"]
    assert tuple(mlp["router"]["w"].shape) == (tcfg.d_model,
                                               tcfg.moe.num_experts)
    assert tuple(mlp["experts"]["up"].shape) == (
        tcfg.moe.num_experts, tcfg.d_model, tcfg.moe.d_expert)


def test_calibration_moe_taps_match(model):
    jcfg, tcfg, jp = model
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    jb = JC.synthetic_calibration_set(jcfg, n_seqs=2, seq_len=24)
    tb = TC.synthetic_calibration_set(tcfg, n_seqs=2, seq_len=24)
    jcol = JC.collect_stats(jp, jcfg, jb)
    tcol = TC.collect_stats(tp, tcfg, tb)
    assert set(tcol.stats) == set(jcol.stats)
    moe_keys = [k for k in jcol.stats if k[2][:2] == ("mlp", "experts")]
    assert len(moe_keys) == 2 * jcfg.num_layers
    for key, v in jcol.stats.items():
        assert tcol.stats[key].shape == v.shape
        np.testing.assert_allclose(tcol.stats[key], v, rtol=1e-5, atol=1e-7)
    for key, v in jcol.a8_err.items():
        np.testing.assert_allclose(tcol.a8_err[key], v, rtol=1e-4)
