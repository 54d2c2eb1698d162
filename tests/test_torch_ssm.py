"""Port parity for the sub-quadratic mixers and the models built on them
(``models/ssm.py``, ``models/lm.py``'s hybrid and RWKV6 stacks, the
contiguous decode cache behind ``api.prefill_fn`` / ``api.decode_fn``), on
the f32 smoke configs of zamba2-7b and rwkv6-7b with the JAX package's
weights, against the JAX package on the CPU.  Tolerance: 1e-5 of the
largest magnitude of the reference's result (logits, outputs and states),
tokens exact:

- Mamba2: ``mamba2_forward`` (with its state), ``mamba2_prefill_chunk``
  (ragged ``lens``, state carried in) and ``mamba2_decode``; ``ssd_chunked``
  over several 128-step chunks, also with decays large enough that the
  masked differences would overflow if exponentiated first (held to 2e-4:
  f32 cumulative sums near -600 differ in their rounding);
- RWKV6: ``rwkv6_forward``, ``rwkv6_decode``, the channel mix;
- the reference's own invariants (``tests/test_state_leaves.py``): the
  chunked prefill's state equals the token recurrence's, and RWKV6's
  iterated decode equals its full scan;
- ``lm_forward`` logits, and ``prefill_fn`` then ``decode_fn`` at each
  step, for zamba2-smoke, rwkv6-smoke and codellama-7b-smoke (its int8
  contiguous slab too, and a ragged ``last_idx`` prefill);
- the registry: both configs (and whisper's) field for field, ``NOT_PORTED``
  empty; MLA's contiguous cache is refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import ssm as JS
from repro_torch.configs import NOT_PORTED, get_config
from repro_torch.models import api
from repro_torch.models import convert
from repro_torch.models import ssm as TS


def _cfgs(arch, **kw):
    return (j_get_config(arch, smoke=True).with_(dtype="float32", **kw),
            get_config(arch, smoke=True).with_(dtype="float32", **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return convert.from_reference({"x": jax.tree.map(np.asarray, tree)})["x"]


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0,
                               atol=tol, err_msg=what)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _cfgs("zamba2-7b")
    p = JS.init_mamba2(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, p, _tree_t(p)


@pytest.fixture(scope="module")
def rwkv():
    jcfg, tcfg = _cfgs("rwkv6-7b")
    p = JS.init_rwkv6(jax.random.PRNGKey(5), jcfg)
    # the reference draws u_bonus zero: fill it so its term is live
    p = dict(p, u_bonus=jnp.asarray(_x(jcfg.d_model, 9)))
    cm = JS.init_rwkv_channel_mix(jax.random.PRNGKey(6), jcfg)
    return jcfg, tcfg, p, _tree_t(p), cm, _tree_t(cm)


# ----------------------------------------------------------------- mamba2 --
def test_mamba2_forward_prefill_chunk_and_decode_match_jax(mamba):
    jcfg, tcfg, jp, tp = mamba
    x = _x((2, 11, jcfg.d_model), 0)
    jy, jst = JS.mamba2_forward(jp, jnp.asarray(x), jcfg, backend="xla",
                                return_state=True)
    ty, tst = TS.mamba2_forward(tp, _t(x), tcfg, return_state=True)
    _close(ty, jy, "forward")
    for k in jst:
        _close(tst[k], jst[k], f"forward state {k}")
    # a short prompt (T < K-1) pads the conv history
    jy2, jst2 = JS.mamba2_forward(jp, jnp.asarray(x[:, :2]), jcfg,
                                  backend="xla", return_state=True)
    ty2, tst2 = TS.mamba2_forward(tp, _t(x[:, :2]), tcfg, return_state=True)
    for k in jst2:
        _close(tst2[k], jst2[k], f"short state {k}")
    # ragged chunks on top of the forward's state (lens 0 keeps a row's)
    jst_c, tst_c = jst, tst
    for c, lens in enumerate(([5, 0], [3, 6])):
        xc = _x((2, 6, jcfg.d_model), 10 + c)
        ln = np.asarray(lens, np.int32)
        jy, jst_c = JS.mamba2_prefill_chunk(jp, jnp.asarray(xc), jst_c,
                                            jnp.asarray(ln), jcfg,
                                            backend="xla")
        ty, tst_c = TS.mamba2_prefill_chunk(tp, _t(xc), tst_c, _t(ln), tcfg)
        _close(ty, jy, f"chunk {c}")
        for k in jst_c:
            _close(tst_c[k], jst_c[k], f"chunk {c} state {k}")
    for i in range(3):
        xd = _x((2, 1, jcfg.d_model), 20 + i)
        jy, jst_c = JS.mamba2_decode(jp, jnp.asarray(xd), jst_c, jcfg,
                                     backend="xla")
        ty, tst_c = TS.mamba2_decode(tp, _t(xd), tst_c, tcfg)
        _close(ty, jy, f"decode {i}")
        for k in jst_c:
            _close(tst_c[k], jst_c[k], f"decode {i} state {k}")


@pytest.mark.parametrize("t,decay,tol", [(128, 0.05, 1e-5),
                                         (300, 0.05, 1e-5),
                                         (300, 6.0, 2e-4)])
def test_ssd_chunked_matches_jax_over_chunks(t, decay, tol):
    """Several chunks and a ragged last one.  With per-step log decays down
    to -24 (``decay`` 6: mean -4.8), Λ within a chunk reaches about -600
    as at full width (about -1400 there), exp(Λ_i − Λ_j) underflows to 0 far
    below the diagonal, and the masked positive half would overflow if
    exponentiated before the mask.  There Λ_i − Λ_j is the difference of
    two f32 cumulative sums near -600, whose rounding (about 6e-5 in each)
    either implementation carries into exp: that case is held to 2e-4 of
    the output's largest magnitude, the others to 1e-5."""
    b, h, p, n = 2, 3, 4, 5
    x = _x((b, t, h, p), 1)
    la = -np.abs(_x((b, t, h), 2, scale=decay))
    bm, cm = _x((b, t, n), 3), _x((b, t, n), 4)
    h0 = _x((b, h, p, n), 5)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, la, bm, cm, h0)))
    ty, th = TS.ssd_chunked(*map(_t, (x, la, bm, cm, h0)))
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    for got, want in ((ty, jy), (th, jh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * max(
            1.0, float(np.abs(want).max())))


def test_mamba2_prefill_state_matches_step_recurrence(mamba):
    """The reference's invariant: the full forward and the state-carrying
    chunks (ragged last chunk) end on the token recurrence's state."""
    _, cfg, _, p = mamba
    t = 11
    x = _t(_x((1, t, cfg.d_model), 4))
    out_full, st_full = TS.mamba2_forward(p, x, cfg, return_state=True)
    st = TS.init_mamba2_state(cfg, 1, "cpu")
    outs = []
    for i in range(t):
        o, st = TS.mamba2_decode(p, x[:, i:i + 1], st, cfg)
        outs.append(o)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out_full.numpy(), torch.cat(outs, 1).numpy(),
                               **tol)
    for k in st:
        np.testing.assert_allclose(st_full[k].numpy(), st[k].numpy(), **tol)
    st_c = TS.init_mamba2_state(cfg, 1, "cpu")
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, 1))
    for c in range(3):
        _, st_c = TS.mamba2_prefill_chunk(
            p, x_pad[:, c * 4:(c + 1) * 4], st_c,
            torch.tensor([4 if c < 2 else 3]), cfg)
    for k in st:
        np.testing.assert_allclose(st_c[k].numpy(), st[k].numpy(), **tol)


# ------------------------------------------------------------------ rwkv6 --
def test_rwkv6_forward_decode_and_channel_mix_match_jax(rwkv):
    jcfg, tcfg, jp, tp, jcm, tcm = rwkv
    x = _x((2, 7, jcfg.d_model), 0)
    jy, jst = JS.rwkv6_forward(jp, jnp.asarray(x), jcfg, backend="xla",
                               return_state=True)
    ty, tst = TS.rwkv6_forward(tp, _t(x), tcfg, return_state=True)
    _close(ty, jy, "forward")
    for k in jst:
        _close(tst[k], jst[k], f"forward state {k}")
    for i in range(3):
        xd = _x((2, 1, jcfg.d_model), 30 + i)
        jy, jst = JS.rwkv6_decode(jp, jnp.asarray(xd), jst, jcfg,
                                  backend="xla")
        ty, tst = TS.rwkv6_decode(tp, _t(xd), tst, tcfg)
        _close(ty, jy, f"decode {i}")
        for k in jst:
            _close(tst[k], jst[k], f"decode {i} state {k}")
    xp = _x((2, 7, jcfg.d_model), 40)
    _close(TS.rwkv_channel_mix(tcm, _t(x), _t(xp), tcfg),
           JS.rwkv_channel_mix(jcm, jnp.asarray(x), jnp.asarray(xp),
                               backend="xla"), "channel mix")


def test_rwkv6_single_step_matches_full_scan(rwkv):
    """The reference's invariant: the decode step iterated from the zero
    state reproduces the full scan, per step and in its final state."""
    _, cfg, _, p, _, _ = rwkv
    t = 9
    x = _t(_x((1, t, cfg.d_model), 6))
    out_full, st_full = TS.rwkv6_forward(p, x, cfg, return_state=True)
    st = TS.init_rwkv6_state(cfg, 1, "cpu")
    outs = []
    for i in range(t):
        o, st = TS.rwkv6_decode(p, x[:, i:i + 1], st, cfg)
        outs.append(o)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out_full.numpy(), torch.cat(outs, 1).numpy(),
                               **tol)
    for k in st:
        np.testing.assert_allclose(st_full[k].numpy(), st[k].numpy(), **tol)


# ----------------------------------------------------------------- models --
MODELS = {"zamba2-7b": {}, "rwkv6-7b": {}, "codellama-7b": {},
          "codellama-7b-int8": {"kv_quant": True}}


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ("zamba2-7b", "rwkv6-7b", "codellama-7b"):
        jcfg, _ = _cfgs(arch)
        jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jp, convert.from_reference(jax.tree.map(np.asarray, jp)))
    return out


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-7b"])
def test_lm_forward_matches_jax(weights, arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = weights[arch]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 37))
    toks = toks.astype(np.int32)
    want = japi.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                           backend="xla")
    got = api.forward_fn(tp, {"tokens": _t(toks)}, tcfg)
    _close(got, want, "logits")
    if arch == "zamba2-7b":
        assert [len(g) for g in tp["groups"]] == [2, 2]
        assert len(tp["tail"]) == 1 and "layers" not in tp


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_fn_and_decode_fn_match_jax(weights, name):
    arch = name.removesuffix("-int8")
    jcfg, tcfg = _cfgs(arch, **MODELS[name])
    jp, tp = weights[arch]
    rng = np.random.default_rng(2)
    toks = rng.integers(2, jcfg.vocab_size, (2, 12)).astype(np.int32)
    smax = 24
    jl, jc = japi.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg, smax,
                             backend="xla")
    tl, tc = api.prefill_fn(tp, {"tokens": _t(toks)}, tcfg, smax)
    _close(tl, jl, "prefill logits")
    jtok = ttok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for s in range(4):
        pos = np.full(2, 12 + s, np.int32)
        jl, jc = japi.decode_fn(jp, {"token": jnp.asarray(jtok[:, None]),
                                     "position": jnp.asarray(pos)}, jc,
                                jcfg, backend="xla")
        tl, tc = api.decode_fn(tp, {"token": _t(ttok[:, None]),
                                    "position": _t(pos)}, tc, tcfg)
        _close(tl, jl, f"decode step {s}")
        jtok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        ttok = tl.argmax(-1).numpy().astype(np.int32)
        assert (jtok == ttok).all()
    if arch != "zamba2-7b":
        _same_cache(tc["layers"], jax.tree.map(np.asarray, jc["layers"]),
                    arch)


def _same_cache(got, want, arch):
    for i, (g, w) in enumerate(zip(got, _unstack(want, len(got)))):
        assert set(g) == set(w), arch
        for k in g:
            if g[k].dtype == torch.int8:
                assert (g[k].to(torch.int32) - torch.from_numpy(
                    w[k].astype(np.int32))).abs().max() <= 1, (arch, k)
            else:
                _close(g[k], w[k], f"{arch} layer {i} {k}")


def _unstack(tree, n):
    return [{k: v[i] for k, v in tree.items()} for i in range(n)]


def test_prefill_fn_last_idx_matches_jax(weights):
    """A right-padded joint prefill of an attention stack gathers each
    row's logits at its real last token."""
    jcfg, tcfg = _cfgs("codellama-7b")
    jp, tp = weights["codellama-7b"]
    toks = np.random.default_rng(3).integers(2, jcfg.vocab_size, (3, 10))
    toks = toks.astype(np.int32)
    last = np.array([9, 4, 6], np.int32)
    jl, _ = japi.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg, 16,
                            backend="xla", last_idx=jnp.asarray(last))
    tl, _ = api.prefill_fn(tp, {"tokens": _t(toks)}, tcfg, 16,
                           last_idx=_t(last))
    _close(tl, jl, "last_idx logits")


# ---------------------------------------------------------------- registry --
def test_registry_has_the_ssm_configs():
    assert NOT_PORTED == ()
    for arch in ("zamba2-7b", "rwkv6-7b", "whisper-medium"):
        for smoke in (False, True):
            j = j_get_config(arch, smoke=smoke)
            t = get_config(arch, smoke=smoke).check()
            for f in dataclasses.fields(j):
                assert repr(getattr(t, f.name)) == repr(getattr(j, f.name)), \
                    (arch, f.name)
    with pytest.raises(ValueError, match="disagree"):
        get_config("whisper-medium").with_(family="dense").check()
    dcfg = get_config("deepseek-v2-236b", smoke=True)
    # MLA's contiguous latent cache is ported (it raised here before)
    dc = api.init_decode_cache(dcfg, 1, 8, device="cpu")
    assert [set(lc) for lc in dc["layers"]] == \
        [{"ckv", "kpe", "lens"}] * dcfg.num_layers
    assert dc["layers"][0]["ckv"].shape == (1, 8, dcfg.mla.kv_lora_rank)
    assert api.paged_supported(get_config("rwkv6-7b"))[0] is False
