"""Port parity for the flash attention B4: its plain version against the
JAX package's Pallas ``flash_attention`` in interpret mode (small blocks, so
the block skip and the padded tail both run) and against
``chunked_attention`` in both packages; causal and non-causal, GQA, T not a
multiple of the block.  Then ``attn_impl="flash"`` at the model level: the
port's ``gqa_prefill`` and ``forward_fn`` on the f32 granite smoke config
against the reference's ``attn_impl="flash_interpret"``.

Tolerance: 1e-5 (f32 sums in another order) on attention outputs; atol
1e-4 on logits, as ``test_torch_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import api as japi
from repro.models import attention as JA
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import attention as TA
from repro_torch.models import convert

TOL = 1e-5


def _qkv(b, t, s, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _t(*a):
    return [torch.from_numpy(x) for x in a]


@pytest.mark.parametrize("b,t,h,hkv,d,causal", [
    (2, 37, 4, 2, 16, True),      # GQA, T not a multiple of the block
    (1, 64, 4, 4, 32, True),      # MHA, whole blocks (one skipped per row)
    (1, 50, 8, 2, 16, True),      # grp 4
    (2, 32, 4, 2, 16, False),     # non-causal, S a multiple of the block
])
def test_plain_matches_reference_flash_interpret(b, t, h, hkv, d, causal):
    q, k, v = _qkv(b, t, t, h, hkv, d)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, block_q=16, block_kv=16, interpret=True)
    got = FA.flash_attention_plain(*_t(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, t, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_chunked_attention(causal):
    b, t, h, hkv, d = 2, 48, 4, 2, 16
    q, k, v = _qkv(b, t, t, h, hkv, d, seed=1)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t))
    want = JA.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=causal, q_chunk=16, kv_chunk=16)
    tq, tk, tv, tpos = _t(q, k, v, np.ascontiguousarray(pos))
    got = FA.flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    port = TA.chunked_attention(tq, tk, tv, tpos, tpos, causal=causal,
                                q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), port.numpy(), rtol=0, atol=TOL)


def test_contract_errors():
    q, k, v = _t(*_qkv(1, 600, 600, 2, 1, 16))
    with pytest.raises(ValueError, match="divisible by block_kv"):
        ops.flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q[:, :, :1].repeat(1, 1, 3, 1),
                            k.repeat(1, 1, 2, 1), v.repeat(1, 1, 2, 1))
    with pytest.raises(ValueError, match="S >= T"):
        ops.flash_attention(q, k[:, :10], v[:, :10])


@pytest.fixture(scope="module")
def granite():
    jcfg = j_get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32")
    tcfg = get_config("granite-moe-1b-a400m", smoke=True).with_(
        dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.from_reference(jax.tree.map(np.asarray, jp))


def test_gqa_prefill_flash_equals_chunked(granite):
    _, tcfg, _, tp = granite
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 29, tcfg.d_model)).astype(
        np.float32))
    pos = torch.arange(29)[None].expand(2, 29)
    mixer = tp["layers"][0]["mixer"]
    yf, cf = TA.gqa_prefill(mixer, x, pos, tcfg.with_(attn_impl="flash"))
    yc, cc = TA.gqa_prefill(mixer, x, pos, tcfg)
    np.testing.assert_allclose(yf.numpy(), yc.numpy(), rtol=0, atol=TOL)
    assert torch.equal(cf["k"], cc["k"])


def test_forward_fn_flash_matches_reference(granite):
    jcfg, tcfg, jp, tp = granite
    toks = np.random.default_rng(3).integers(2, jcfg.vocab_size, (2, 37)
                                             ).astype(np.int32)
    want = japi.forward_fn(jp, {"tokens": jnp.asarray(toks)},
                           jcfg.with_(attn_impl="flash_interpret"),
                           backend="xla")
    got = tapi.forward_fn(tp, {"tokens": torch.from_numpy(toks)},
                          tcfg.with_(attn_impl="flash"))
    assert got.shape == (2, 37, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
