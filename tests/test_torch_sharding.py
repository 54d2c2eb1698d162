"""The port's sharding rules, hints, meshes, mesh-blocked MoE dispatch and
restore with placements (``repro_torch/sharding``, ``launch/mesh.py``,
``models/mlp.py``, ``checkpoint/manager.py``) against the reference.

Spec trees: for every registry arch at full width, on a 16×16 and a
2×16×16 mesh, the port's specs (one dict per layer) equal the reference's
once the reference's stacked lead axes are dropped, for params, quantized
params, batches, decode caches and ZeRO optimizer state.  Specs are
compared as placements: a one-axis tuple entry ``("data",)`` is the axis
``"data"``, and trailing replicated dims are dropped.  The ZeRO axis is the
one structural difference: where the reference puts "data" on its stacked
layer axis, the port's per-layer leaf has none and takes the first free,
divisible dim instead.

The (1, 1) local mesh's gloo group is made once, in a module fixture, and
destroyed at teardown.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.configs.base import QuantConfig as RefQuant
from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
from repro.core.apply import quantize_params as ref_quantize
from repro.models import api as ref_api
from repro.optim import adamw as ref_adamw
from repro.sharding import rules as RR

from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, MoEConfig,
                                     ModelConfig, QuantConfig, TrainConfig)
from repro_torch.core.apply import quantize_params
from repro_torch.launch import mesh as LM
from repro_torch.models import api
from repro_torch.models import mlp as M
from repro_torch.optim import adamw
from repro_torch.sharding import hints as H
from repro_torch.sharding import rules
from repro_torch.train.trainer import make_train_step


def _ref_mesh(multi):
    if multi:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _norm(spec):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_flat(specs):
    from jax.sharding import PartitionSpec
    return {RR._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


def _split(path):
    parts = path.split("/")
    return ("/".join(p for p in parts if not p.isdigit()),
            sum(p.isdigit() for p in parts))


def _compare(port_specs, ref_specs, what, zero_lead=None):
    """Every port leaf's spec equals its reference leaf's with the stacked
    lead axes dropped, and the two trees hold the same leaves.
    ``zero_lead(path, spec)`` checks a ZeRO leaf whose reference spec puts
    "data" on a lead axis; returns how many there were."""
    port, ref = rules.flat_specs(port_specs), _ref_flat(ref_specs)
    assert {_split(p)[0] for p in port} == set(ref), what
    n_lead = 0
    for p, s in port.items():
        rp, nl = _split(p)
        r = ref[rp]
        if any(e is not None for e in r[:nl]):
            assert zero_lead is not None, (what, p, r)
            zero_lead(p, s, r)
            n_lead += 1
            continue
        assert _norm(r[nl:]) == _norm(s), (what, p, s, r)
    return n_lead


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    cfg = ref_config(arch)
    shapes = jax.eval_shape(
        lambda: ref_api.init_model(jax.random.PRNGKey(0), cfg))
    qshapes = jax.eval_shape(
        lambda p: ref_quantize(p, cfg, RefQuant())[0], shapes)
    return cfg, shapes, qshapes


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = get_config(arch)
    params = api.init_model(cfg, device="meta")
    qparams = quantize_params(api.init_model(cfg, device="meta"), cfg,
                              QuantConfig())[0]
    return cfg, params, qparams


def _port_flat(arch, quantized=False, multi=False):
    cfg, params, qparams = _port_trees(arch)
    return rules.flat_specs(rules.param_specs(
        qparams if quantized else params, LM.production_shape(multi), cfg))


# ------------------------------------------------------------ spec trees ----
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_reference(arch):
    """Params, quantized params, batch, cache and ZeRO optimizer state, on
    both production meshes, for one registry arch at full width."""
    rcfg, rshapes, rqshapes = _ref_trees(arch)
    cfg, params, qparams = _port_trees(arch)
    ropt = ref_adamw.OptState(
        step=jax.ShapeDtypeStruct((), jnp.int32), mu=rshapes, nu=rshapes)
    popt = adamw.OptState(step=torch.empty((), device="meta"), mu=params,
                          nu=params)
    n_zero_lead = 0
    for multi in (False, True):
        rm, pm = _ref_mesh(multi), LM.production_shape(multi)
        rps = RR.param_specs(rshapes, rm, rcfg)
        pps = rules.param_specs(params, pm, cfg)
        _compare(pps, rps, "params")
        _compare(rules.param_specs(qparams, pm, cfg),
                 RR.param_specs(rqshapes, rm, rcfg), "quantized params")

        def zero_lead(path, spec, ref_spec, pps_flat=rules.flat_specs(pps)):
            # the port's leaf: its param spec with "data" on the first free
            # divisible dim (or none), the model axes where the ref has them
            base = list(pps_flat[path]) + [None] * 8
            assert [e for e in spec if e not in (None, "data")] == \
                [e for e in ref_spec if e not in (None, "data")], path
            assert list(spec).count("data") <= 1, path
            for e, b in zip(spec, base):
                assert e == b or (e == "data" and b is None), path

        n_zero_lead += _compare(
            rules.opt_specs(popt, pps, pm).mu,
            RR.opt_specs(ropt, rps, rm).mu, "opt mu", zero_lead)
        for name, shape in SHAPES_BY_NAME.items():
            _compare(rules.batch_specs(api.input_specs(cfg, shape), pm),
                     RR.batch_specs(ref_api.input_specs(
                         rcfg, REF_SHAPES[name]), rm), f"batch {name}")
            if shape.kind == "decode":
                _compare(rules.cache_specs_tree(
                    api.cache_specs(cfg, shape), pm),
                    RR.cache_specs_tree(ref_api.cache_specs(
                        rcfg, REF_SHAPES[name]), rm), f"cache {name}")
    # the structural ZeRO difference appears exactly when a layer stack
    # divides "data"
    stacks = {cfg.num_layers, cfg.enc_layers} - {0}
    if cfg.family != "hybrid" and not any(n % 16 == 0 for n in stacks):
        assert n_zero_lead == 0


@pytest.mark.parametrize("multi", [False, True])
def test_logits_specs_equal_reference(multi):
    rm, pm = _ref_mesh(multi), LM.production_shape(multi)
    assert _norm(rules.logits_spec(pm)) == _norm(tuple(RR.logits_spec(rm)))
    for batch, vocab in ((128, 32000), (1, 51865), (32, 128256)):
        assert _norm(rules.logits_prefill_spec(pm, batch, vocab)) == \
            _norm(tuple(RR.logits_prefill_spec(rm, batch, vocab)))
        assert _norm(rules.logits_decode_spec(pm, batch, vocab)) == \
            _norm(tuple(RR.logits_decode_spec(rm, batch, vocab)))


def test_param_specs_dense_tp():
    flat = _port_flat("mistral-large-123b")
    assert flat["embed/table"] == ("model", None)
    assert flat["layers/0/mixer/wq/w"] == (None, "model")
    assert flat["layers/87/mixer/wo/w"] == ("model", None)
    # mistral kv=8 < 16 → kv replicated
    assert flat["layers/0/mixer/wk/w"] == ()
    assert flat["layers/0/mlp/down/w"] == ("model", None)


def test_param_specs_zamba_kv_sharded():
    flat = _port_flat("zamba2-7b")  # kv=32 divisible by 16 → sharded
    assert flat["shared/mixer/wk/w"] == (None, "model")
    assert flat["groups/0/0/mixer/in_x/w"] == (None, "model")
    assert all(a is None for a in flat["groups/3/5/mixer/in_bc/w"])


def test_quantized_param_specs_follow_fp():
    flat = _port_flat("mistral-large-123b", quantized=True)
    assert flat["layers/0/mixer/wq/w/packed"] == (None, "model")
    # scales keep only the output-axis sharding
    assert flat["layers/0/mixer/wq/w/scales"] == (None, "model")
    assert flat["layers/0/mlp/down/w/scales"] == (None, None)


def test_quantized_moe_specs_ep_and_cosharded():
    flat = _port_flat("deepseek-v2-236b", quantized=True)
    # experts [E, Ci(/2|/G), Co]: E=160 on model (EP)
    for leaf in ("gate", "up", "down"):
        for field in ("packed", "scales", "zeros"):
            assert flat[f"layers/5/mlp/experts/{leaf}/{field}"] == (
                "model", None, None), (leaf, field)
    # MLA absorbed decode weights [H, Ci', Co']: heads on model (TP)
    for leaf in ("wk_t", "wv"):
        for field in ("packed", "scales", "zeros"):
            assert flat[f"layers/0/mixer/wkv_b_absorbed/{leaf}/{field}"] == (
                "model", None, None), (leaf, field)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mistral-large-123b"])
def test_quantized_trio_cosharded_everywhere(arch):
    flat = _port_flat(arch, quantized=True)
    packed = {k[:-len("/packed")]: v for k, v in flat.items()
              if k.endswith("/packed")}
    assert packed
    for base, pspec in packed.items():
        for field in ("scales", "zeros"):
            fspec = flat[f"{base}/{field}"]
            if fspec:
                assert fspec[:-2] == pspec[:-2], base
                assert fspec[-1] == pspec[-1], base


def test_opt_specs_zero_shards_over_data():
    cfg, params, _ = _port_trees("llama3.2-3b")
    pm = LM.production_shape()
    pspecs = rules.param_specs(params, pm, cfg)
    ospecs = rules.opt_specs(adamw.init_opt_state(params, TrainConfig()),
                             pspecs, pm)
    flat = rules.flat_specs(ospecs.mu)
    # wq moment (3072, 3072), param spec (None, model) → data on dim 0
    assert flat["layers/0/mixer/wq/w"] == ("data", "model")
    assert ospecs.step == () and ospecs.ef is None


def test_cache_specs_decode():
    cfg = get_config("mistral-large-123b")
    specs = rules.cache_specs_tree(
        api.cache_specs(cfg, SHAPES_BY_NAME["decode_32k"]),
        LM.production_shape())
    # [B, S, Hkv, Dh]: batch 128 → data, seq 32768 → model (SP decode)
    assert rules.flat_specs(specs)["layers/0/k"] == (
        ("data",), ("model",), None, None)


def test_cache_specs_long_context_batch1():
    cfg = get_config("rwkv6-7b")
    specs = rules.cache_specs_tree(
        api.cache_specs(cfg, SHAPES_BY_NAME["long_500k"]),
        LM.production_shape())
    # rwkv state [B=1, H=64, K, V] → heads on model
    assert rules.flat_specs(specs)["layers/0/wkv"] == (
        None, "model", None, None)


def test_shape_specs_allocate_nothing():
    cfg = get_config("deepseek-v2-236b")
    params = api.init_model(cfg, device="meta")
    assert all(t.device.type == "meta" for t in T.leaves(params))
    for shape in SHAPES:
        ok, _ = api.supports_shape(cfg, shape)
        assert ok == (shape.name != "long_500k")
        batch = api.input_specs(cfg, shape)
        assert all(t.device.type == "meta" for t in batch.values())
    # the encoder-decoder's dry-run cache holds seq_len // 2 rows
    w = get_config("whisper-medium")
    cache = api.cache_specs(w, SHAPES_BY_NAME["decode_32k"])
    assert cache["layers"][0]["xk"].shape[1] == 16384
    assert cache["layers"][0]["self"]["k"].shape[1] == 16384


# ----------------------------------------------------------------- hints ----
def test_hints_noop_without_mesh_or_dtensor(monkeypatch):
    x = torch.ones(4, 8, 6, 2)
    assert H.shard_hint(x, ("pod", "data"), None, "model", None) is x
    shape = LM.MeshShape(("data", "model"), (2, 3))
    with H.hint_mesh(shape):
        assert H.current_mesh() is shape
        assert H.shard_hint(x, ("pod", "data"), None, "model") is x
        # absent axes drop, indivisible axes replicate
        assert H.hint_spec(x.shape, (("pod", "data"), None, "model", None),
                           shape) == ("data", None, "model", None)
        assert H.hint_spec((3, 4), ("data", "model"), shape) == (None, None)
    assert H.current_mesh() is None


# --------------------------------------------------- mesh-blocked MoE ----
def _moe_cfg(e=4, k=2, cf=None):
    return ModelConfig(
        name="t", family="moe", num_layers=1, d_model=32, num_heads=4,
        num_kv_heads=4, d_ff=16, vocab_size=64, dtype="float32",
        moe=MoEConfig(num_experts=e, top_k=k, d_expert=16,
                      capacity_factor=cf if cf is not None else float(e)))


def _moe_pair(cfg, seed=0):
    from repro.configs.base import ModelConfig as RC, MoEConfig as RM
    from repro.models.mlp import init_moe
    rcfg = RC(name="t", family="moe", num_layers=1, d_model=32, num_heads=4,
              num_kv_heads=4, d_ff=16, vocab_size=64, dtype="float32",
              moe=RM(num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                     d_expert=16, capacity_factor=cfg.moe.capacity_factor))
    rp = init_moe(jax.random.PRNGKey(seed), rcfg)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), rp)
    x = np.random.default_rng(seed).standard_normal((4, 8, 32)).astype(
        np.float32)
    return rcfg, rp, pp, x


@pytest.mark.parametrize("cf", [None, 1.0])
def test_blocked_dispatch_matches_reference(cf, monkeypatch):
    """The port's blocked dispatch (a 2-way data hint mesh) equals the
    reference's on the same weights, dropless and with per-block drops;
    dropless, it equals the one-block dispatch too."""
    from repro.models import mlp as ref_mlp

    cfg = _moe_cfg(cf=cf)
    rcfg, rp, pp, x = _moe_pair(cfg)
    base, _ = M.apply_moe(pp, torch.from_numpy(x), cfg)

    class FakeMesh:
        shape = {"data": 2, "model": 1}

    monkeypatch.setattr(ref_mlp.H, "current_mesh", lambda: FakeMesh())
    monkeypatch.setattr(ref_mlp.H, "shard_hint", lambda a, *ax: a)
    want, _ = jax.jit(lambda p, x: ref_mlp.apply_moe(
        p, x, rcfg, backend="xla"))(rp, jnp.asarray(x))
    with H.hint_mesh(LM.MeshShape(("data", "model"), (2, 1))):
        assert M.dispatch_blocks(32) == 2 and M.dispatch_blocks(31) == 1
        got, _ = M.apply_moe(pp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if cf is None:
        np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------- the local mesh (gloo, 1 rank) --
@pytest.fixture(scope="module")
def local_mesh():
    mesh = LM.make_local_mesh(device_type="cpu")
    yield mesh
    LM.close_mesh()


def test_local_mesh_is_one_by_one(local_mesh):
    assert tuple(local_mesh.shape) == (1, 1)
    assert LM.axis_sizes(local_mesh) == {"data": 1, "model": 1}


def _smoke_state(tc):
    cfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    params = api.init_model(cfg, seed=0, device="cpu")
    return cfg, params, adamw.init_opt_state(params, tc)


def test_restore_with_placements_round_trips(local_mesh):
    from torch.distributed.tensor import DTensor

    tc = TrainConfig(grad_compression="int8_ef")
    cfg, params, opt = _smoke_state(tc)
    params["layers"][0]["mixer"]["wq"]["w"].add_(0.25)
    pspecs = rules.param_specs(params, local_mesh, cfg)
    ospecs = rules.opt_specs(opt, pspecs, local_mesh)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, (params, opt), {"note": "x"})
        like = _smoke_state(tc)[1:]
        plain, meta = mgr.restore(like, device="cpu")
        placed, meta2 = mgr.restore(like, mesh=local_mesh,
                                    specs=(pspecs, ospecs))
    assert meta2 == meta
    seen = []

    def check(t, spec):
        assert isinstance(t, DTensor)
        assert t.placements == tuple(rules.placements(spec, local_mesh))
        seen.append(t.full_tensor())

    rules.map_specs(check, placed, (pspecs, ospecs))
    want = T.leaves(plain[0]) + [plain[1].step] + T.leaves(plain[1].mu) \
        + T.leaves(plain[1].nu) + T.leaves(plain[1].ef)
    assert len(seen) == len(want)
    for t, u in zip(seen, want):
        assert t.dtype == u.dtype and torch.equal(t, u)
    assert torch.equal(placed[0]["layers"][0]["mixer"]["wq"]["w"]
                       .full_tensor(), params["layers"][0]["mixer"]["wq"]["w"])


def test_train_step_on_local_mesh_equals_unplaced(local_mesh):
    """The counterpart of the reference's ``test_pjit_train_step_local_mesh``:
    one codellama-smoke step with params and optimizer state placed as
    ``DTensor`` s on the (1, 1) mesh equals the unplaced step."""
    from torch.distributed.tensor import distribute_tensor

    tc = TrainConfig(learning_rate=3e-3, warmup_steps=1)
    cfg, params, opt = _smoke_state(tc)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    step = make_train_step(cfg, tc)
    pspecs = rules.param_specs(params, local_mesh, cfg)
    ospecs = rules.opt_specs(opt, pspecs, local_mesh)

    def place(tree, specs):
        return rules.map_specs(lambda t, sp: distribute_tensor(
            t.clone(), local_mesh, rules.placements(sp, local_mesh)),
            tree, specs)

    from torch.distributed.tensor.experimental import implicit_replication

    dp, do = place(params, pspecs), place(opt, ospecs)
    db = place(batch, rules.batch_specs(batch, local_mesh))
    p1, _, m1 = step(params, opt, batch)
    with implicit_replication():     # the step's own aranges and zeros
        p2, _, m2 = step(dp, do, db)
    assert bool(torch.isfinite(m1["loss"]))
    np.testing.assert_allclose(float(m2["loss"].full_tensor()
                                     if hasattr(m2["loss"], "full_tensor")
                                     else m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    for a, b in zip(T.leaves(p2), T.leaves(p1)):
        np.testing.assert_allclose(a.full_tensor().numpy(), b.numpy(),
                                   rtol=1e-6, atol=1e-7)
