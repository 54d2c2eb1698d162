"""Port parity at the model level: the JAX reference's ``init_model`` params,
converted with ``repro_torch.models.convert``, give the same logits through
``lm_forward``, ``lm_prefill_chunk`` and ``lm_decode_paged`` on the f32
codellama-7b smoke config — fp weights and RTN-quantized weights, and with
both the paged kernels' plain versions ("auto") and the dense gather oracle.
Tolerance: atol 1e-4 on the logits (f32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core.apply import rtn_baseline as j_rtn
from repro.models import api as japi
from repro.models import attention as JA
from repro.models import lm as JLM
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.apply import rtn_baseline
from repro_torch.models import attention as TA
from repro_torch.models import convert
from repro_torch.models import lm as TLM

ATOL = 1e-4
PS = 8


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("codellama-7b", smoke=True).with_(dtype="float32")
    tcfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    jq = j_rtn(jp, jcfg, JQuantConfig(group_size=16))
    return jcfg, tcfg, {"fp": jp, "rtn": jq}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=ATOL, rtol=0)


def test_convert_unstacks_layers(setup):
    jcfg, tcfg, jparams = setup
    tp = convert.from_reference(_np(jparams["rtn"]))
    assert len(tp["layers"]) == jcfg.num_layers
    wq = tp["layers"][2]["mixer"]["wq"]["w"]
    jwq = jparams["rtn"]["layers"]["mixer"]["wq"]["w"]
    np.testing.assert_array_equal(wq.packed.numpy(), np.asarray(jwq.packed[2]))
    assert wq.packed.is_contiguous() and wq.group_size == 16


@pytest.mark.parametrize("kind", ["fp", "rtn"])
def test_lm_forward_matches(setup, kind):
    jcfg, tcfg, jparams = setup
    tp = convert.from_reference(_np(jparams[kind]))
    toks = np.random.default_rng(0).integers(2, jcfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    jl, _ = JLM.lm_forward(jparams[kind], jnp.asarray(toks), jcfg,
                           backend="xla")
    tl = TLM.lm_forward(tp, torch.from_numpy(toks), tcfg)
    _close(tl, jl)


def test_rtn_baseline_matches(setup):
    jcfg, tcfg, jparams = setup
    tp = rtn_baseline(convert.from_reference(_np(jparams["fp"])), tcfg,
                      QuantConfig(group_size=16))
    ref = convert.from_reference(_np(jparams["rtn"]))
    for a, b in zip(tp["layers"], ref["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            qa, qb = a["mixer"][name]["w"], b["mixer"][name]["w"]
            assert torch.equal(qa.packed, qb.packed)
            assert torch.equal(qa.scales, qb.scales)


@pytest.mark.parametrize("impl", ["auto", "gather"])
@pytest.mark.parametrize("kind", ["fp", "rtn"])
def test_paged_prefill_chunks_and_decode_match(setup, kind, impl):
    """Two prefill chunks (the second reads the first through the pages)
    then one decode step, with ragged rows and a shuffled page table."""
    jcfg, tcfg, jparams = setup
    tcfg = tcfg.with_(paged_attn_impl=impl)
    jp = jparams[kind]
    tp = convert.from_reference(_np(jp))
    rng = np.random.default_rng(1)
    b, n_pages, pages = 2, 9, 3
    table = np.zeros((b, pages), np.int32)
    table[:] = rng.permutation(np.arange(1, n_pages))[:b * pages].reshape(
        b, pages)
    jpool = japi.init_paged_cache(jcfg, n_pages, PS)
    tpool = TLM.init_paged_cache(tcfg, n_pages, PS, "cpu")
    prompt = rng.integers(2, jcfg.vocab_size, (b, 16), dtype=np.int32)
    for starts, lens in (([0, 0], [8, 5]), ([8, 5], [8, 3])):
        starts = np.asarray(starts, np.int32)
        lens = np.asarray(lens, np.int32)
        toks = np.zeros((b, 8), np.int32)
        for r in range(b):
            toks[r, :lens[r]] = prompt[r, starts[r]:starts[r] + lens[r]]
        jl, jpool = japi.prefill_chunk_fn(
            jp, {"tokens": jnp.asarray(toks)}, jpool, jnp.asarray(table),
            jnp.asarray(starts), jnp.asarray(lens), jcfg, backend="xla",
            last_idx=jnp.asarray(lens - 1))
        tl, tpool = TLM.lm_prefill_chunk(
            tp, torch.from_numpy(toks), tpool, torch.from_numpy(starts),
            torch.from_numpy(lens), torch.from_numpy(table), tcfg,
            last_idx=torch.from_numpy(lens - 1))
        _close(tl, jl)
    # the written pool rows agree (page 0 holds padded rows' garbage)
    for i, layer in enumerate(tpool["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                layer[name][1:].numpy(),
                np.asarray(jpool["layers"][name][i, 1:]), atol=ATOL, rtol=0)
    pos = np.array([16, 8], np.int32)
    tok = rng.integers(2, jcfg.vocab_size, (b, 1), dtype=np.int32)
    jl, _ = japi.decode_paged_fn(
        jp, {"token": jnp.asarray(tok), "position": jnp.asarray(pos)}, jpool,
        jnp.asarray(table), jcfg, backend="xla")
    tl, _ = TLM.lm_decode_paged(tp, torch.from_numpy(tok), tpool,
                                torch.from_numpy(pos),
                                torch.from_numpy(table), tcfg)
    _close(tl, jl)


def test_contiguous_decode_matches(setup):
    jcfg, tcfg, jparams = setup
    lp_j = jax.tree.map(lambda a: a[0], jparams["fp"]["layers"])["mixer"]
    lp_t = convert.from_reference(_np(jparams["fp"]))["layers"][0]["mixer"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jc = JA.init_gqa_cache(jcfg, 2, 16)
    tc = TA.init_gqa_cache(tcfg, 2, 16, "cpu")
    kv = rng.standard_normal(tuple(tc["k"].shape)).astype(np.float32)
    lens = np.array([3, 7], np.int32)
    jc = dict(jc, k=jnp.asarray(kv), v=jnp.asarray(-kv),
              lens=jnp.asarray(lens))
    tc.update(k=torch.from_numpy(kv.copy()), v=torch.from_numpy(-kv),
              lens=torch.from_numpy(lens.copy()))
    pos = lens[:, None]
    jy, jc = JA.gqa_decode(lp_j, jnp.asarray(x), jnp.asarray(pos), jc, jcfg,
                           backend="xla")
    ty, tc = TA.gqa_decode(lp_t, torch.from_numpy(x), torch.from_numpy(pos),
                           tc, tcfg)
    _close(ty, jy)
    _close(tc["k"], jc["k"])
    assert tc["lens"].tolist() == np.asarray(jc["lens"]).tolist()
