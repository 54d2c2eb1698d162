"""The port's analysis tools (``repro_torch/launch``: ``op_cost``,
``comm_bytes``, ``roofline``, ``dryrun``) against the reference's
``jaxpr_cost`` and ``roofline`` (imported directly: ``repro.launch.dryrun``
sets a 512-device ``XLA_FLAGS`` at import, which would slow every later
test in the worker).

``op_cost`` against ``jaxpr_cost`` on bf16 smoke cells (train, prefill,
decode) of codellama, granite and the hybrid: dot FLOPs equal exactly, up
to two structural differences the hybrid states exactly (its prefill head
and its SSM scan's carry transposes, see ``_hybrid_extra``), and total bytes
agree within ``BYTES_RATIO``: the port counts floats at the width the card
reads (the reference caps them at 2 bytes), and has no scan carries and no
``dynamic_slice`` (its chunk slices are views).

The fake process group (8 ranks, a 2×4 mesh) is made once, in a module
fixture, and destroyed at teardown.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import TrainConfig as RefTrain
from repro.launch import jaxpr_cost as JC
from repro.launch import roofline as REF_RL
from repro.models import api as ref_api
from repro.optim import adamw as ref_adamw
from repro.train.trainer import make_train_step as ref_train_step

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig, TrainConfig
from repro_torch.launch import comm_bytes as CB
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.launch import op_cost as OC
from repro_torch.launch import roofline as RL
from repro_torch.models import api
from repro_torch.models.ssm import mamba_dims
from repro_torch.optim import adamw
from repro_torch.sharding import hints as H
from repro_torch.train.trainer import make_train_step, value_and_grad

#: port bytes / reference bytes on the smoke cells (observed 0.76–1.30)
BYTES_RATIO = (0.7, 1.4)
SEQ, BATCH = 32, 2


def _dot_flops(cost):
    return sum(v for k, v in cost["by_op"].items() if k in OC.DOT_NAMES)


def _costs(arch, kind):
    rcfg = ref_config(arch, smoke=True).with_(dtype="bfloat16")
    cfg = get_config(arch, smoke=True).with_(dtype="bfloat16")
    rs, s = RefShape("x", kind, SEQ, BATCH), ShapeConfig("x", kind, SEQ, BATCH)
    rp = jax.eval_shape(lambda: ref_api.init_model(jax.random.PRNGKey(0),
                                                   rcfg))
    rb = ref_api.input_specs(rcfg, rs)
    p, b = api.init_model(cfg, device="meta"), api.input_specs(cfg, s)
    hybrid = cfg.family == "hybrid"
    if kind == "train":
        rtc, tc = RefTrain(remat="block"), TrainConfig(remat="block")
        ro = jax.eval_shape(lambda q: ref_adamw.init_opt_state(q, rtc), rp)
        ref = JC.jaxpr_cost(ref_train_step(rcfg, rtc, backend="xla"), rp, ro,
                            rb)
        port = OC.op_cost(make_train_step(cfg, tc), p,
                          adamw.init_opt_state(p, tc), b)
    elif kind == "prefill":
        # the hybrid takes no last_idx: the reference then runs its head
        # over every position (see _hybrid_extra)
        li = None if hybrid else jnp.full((BATCH,), SEQ - 1, jnp.int32)
        ref = JC.jaxpr_cost(lambda q, bb: ref_api.prefill_fn(
            q, bb, rcfg, SEQ, backend="xla", last_idx=li), rp, rb)
        pli = None if hybrid else torch.full((BATCH,), SEQ - 1,
                                             dtype=torch.int32,
                                             device="meta")
        port = OC.op_cost(api.prefill_fn, p, b, cfg, SEQ, last_idx=pli)
    else:
        ref = JC.jaxpr_cost(lambda q, bb, cc: ref_api.decode_fn(
            q, bb, cc, rcfg, backend="xla"), rp, rb,
            ref_api.cache_specs(rcfg, rs))
        port = OC.op_cost(api.decode_fn, p, b, api.cache_specs(cfg, s), cfg)
    return cfg, ref, port


def _hybrid_extra(cfg, kind):
    """Dot FLOPs the reference counts and the port does not, on the hybrid
    (one SSD chunk: SEQ ≤ 128).  Prefill: the reference's head runs over
    every position and the port's over the last.  Train: the reference's
    scan transposes its carry, so each Mamba2 layer's backward also takes
    the gradient of the first chunk's inter-chunk term with respect to the
    zero initial state (one dot) and of the last chunk's state update (its
    contraction and its outer product, two dots each), which no output
    reads; autograd skips both."""
    if kind == "prefill":
        return 2 * BATCH * (SEQ - 1) * cfg.d_model * cfg.vocab_size
    if kind == "train":
        _, hp, nh, n = mamba_dims(cfg)
        b, lc = BATCH, SEQ
        per = 3 * 2 * b * lc * nh * hp * n + 2 * 2 * b * lc * nh * hp
        return cfg.num_layers * per
    return 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["codellama-7b", "granite-moe-1b-a400m",
                                  "zamba2-7b"])
def test_op_cost_matches_jaxpr_cost(arch, kind):
    cfg, ref, port = _costs(arch, kind)
    ref_dots = ref["by_prim"]["dot_general"]
    extra = _hybrid_extra(cfg, kind) if cfg.family == "hybrid" else 0
    assert _dot_flops(port) == ref_dots - extra
    lo, hi = BYTES_RATIO
    assert lo <= port["bytes"] / ref["bytes"] <= hi, (
        port["bytes"], ref["bytes"])


def test_op_cost_counts_every_loop_trip():
    """The reference's scan-trip test: a Python loop is counted as it
    runs."""
    x = torch.empty(128, 128, device="meta")
    w = torch.empty(10, 128, 128, device="meta")

    def f(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    assert OC.op_cost(f, x, w)["flops"] == 10 * 2 * 128 ** 3


def test_op_cost_sees_remat_recompute():
    from torch.utils.checkpoint import checkpoint

    x = torch.empty(64, 64, device="meta", requires_grad=True)
    w = torch.empty(4, 64, 64, device="meta")

    def f(x):
        for i in range(4):
            x = checkpoint(lambda c, wi: torch.tanh(c @ wi), x, w[i],
                           use_reentrant=False)
        return x.sum()

    fwd = _dot_flops(OC.op_cost(f, x))
    grad = _dot_flops(OC.op_cost(lambda x: torch.autograd.grad(f(x), x), x))
    # backward with remat ≥ 3× forward matmul flops (fwd recompute + 2 bwd)
    assert grad >= 2.9 * fwd


def test_op_cost_remat_adds_one_forward_of_the_blocks():
    cfg = get_config("codellama-7b", smoke=True).with_(dtype="bfloat16")
    p = api.init_model(cfg, device="meta")
    b = api.input_specs(cfg, ShapeConfig("x", "train", SEQ, BATCH))

    def grad_dots(remat):
        return _dot_flops(OC.op_cost(value_and_grad, lambda q, bb: (
            api.loss_fn(q, bb, cfg, remat=remat)), p, b))

    fwd = _dot_flops(OC.op_cost(api.loss_fn, p, b, cfg))
    head = 2 * BATCH * SEQ * cfg.d_model * cfg.vocab_size
    # the recompute runs each block again up to its last saved tensor:
    # PyTorch's checkpoint stops before the MLP's down projection, whose
    # output the backward does not read
    down = 2 * BATCH * SEQ * cfg.d_ff * cfg.d_model
    assert grad_dots(True) - grad_dots(False) == \
        fwd - head - cfg.num_layers * down


def test_op_cost_nibble_width():
    """The reference's width rule on a packed int4 weight: each nibble op
    halves the width, so the high half (shift, then mask) reaches the
    concatenation at a quarter byte and the dequantized weight streams at
    that, as ``jaxpr_cost`` counts it too."""
    from repro_torch.core.quantize import quantize

    qt = quantize(torch.empty(256, 64, device="meta"), 128)
    x = torch.empty(4, 256, device="meta")
    from repro_torch.kernels import ops as kops

    c = OC.op_cost(kops.w4a16_matmul, x, qt)
    assert c["by_op"]["mm"] == 2 * 4 * 256 * 64
    assert c["bytes_by_op"]["mm"] == 4 * 256 * 4 + 256 * 64 * 0.25 \
        + 4 * 64 * 4


# ------------------------------------------------------------- roofline ----
def test_roofline_terms_and_bottleneck():
    rl = RL.Roofline(flops=1e15, hbm_bytes=1e12, coll_bytes=1e13, chips=256,
                     model_flops=8e14)
    d = rl.to_dict()
    assert d["t_compute_s"] == 1e15 / (256 * RL.PEAK_FLOPS)
    assert d["t_memory_s"] == 1e12 / (256 * RL.HBM_BW)
    assert d["t_collective_s"] == 1e13 / (256 * RL.IB_BW)
    assert d["bottleneck"] == "collective"
    assert 0 < d["roofline_fraction"] <= 1.0
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.NVLINK_BW, RL.IB_BW) == (
        989.4e12, 3.35e12, 450e9, 50e9)
    # the weight-stream term and per-axis link rates
    bw = RL.axis_link_bw({"data": 16, "model": 16})
    assert bw == {"model": RL.IB_BW, "data": RL.IB_BW}
    assert RL.axis_link_bw({"data": 2, "model": 4}) == {
        "model": RL.NVLINK_BW, "data": RL.NVLINK_BW}
    rl2 = RL.Roofline(flops=0, hbm_bytes=4e12, coll_bytes=0, chips=256,
                      model_flops=1, weight_stream_bytes=1e12,
                      model_shards=16,
                      coll_by_axis={"model": 3e12, "data": 1e12},
                      link_bw={"model": RL.NVLINK_BW, "data": RL.IB_BW})
    assert rl2.t_memory == (4e12 + 1e12 * 15) / (256 * RL.HBM_BW)
    assert rl2.t_collective == 3e12 / (256 * RL.NVLINK_BW) \
        + 1e12 / (256 * RL.IB_BW)


def test_model_flops_moe_counts_active_only():
    cfg = get_config("deepseek-v2-236b")
    shape = SHAPES_BY_NAME["train_4k"]
    ntot, nemb = RL.count_params(api.init_model(cfg, device="meta"))
    rcfg = ref_config("deepseek-v2-236b")
    rshapes = jax.eval_shape(lambda: ref_api.init_model(
        jax.random.PRNGKey(0), rcfg))
    assert (ntot, nemb) == REF_RL.count_params(rshapes)
    mf = RL.model_flops_estimate(cfg, shape, ntot, nemb)
    assert mf == REF_RL.model_flops_estimate(rcfg, shape, ntot, nemb)
    dense = 6 * (ntot - nemb) * shape.global_batch * shape.seq_len
    assert mf < 0.5 * dense  # top-6/160 is sparse


# ------------------------------------------------------ the fake mesh ----
@pytest.fixture(scope="module")
def fake_mesh():
    shape = LM.MeshShape(("data", "model"), (2, 4))
    mesh = LM.make_fake_mesh(shape)
    yield shape, mesh
    LM.close_mesh()


def test_collective_toy_one_all_reduce(fake_mesh):
    """Column- then row-parallel on the 4-rank "model" axis: exactly one
    all-reduce of ``[B, S, D]``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = fake_mesh[1]["model"]
    b, s, d, f = 2, 8, 16, 32

    def dt(shape, placement):
        local = list(shape)
        if isinstance(placement, Shard):
            local[placement.dim] //= 4
        return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                  [placement], run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    x = dt((b, s, d), Replicate())
    w1, w2 = dt((d, f), Shard(1)), dt((f, d), Shard(0))
    with CB.CommBytes() as cb:
        y = torch.relu(x @ w1) @ w2
        y = y.redistribute(mesh, [Replicate()])
    assert cb.counts == {"all-reduce": 1}
    assert cb.bytes == {"all-reduce": b * s * d * 4}
    assert cb.by_axis(mesh) == {"model": b * s * d * 4}


def test_shard_hint_redistributes_dtensor(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    shape, mesh = fake_mesh
    x = distribute_tensor(torch.empty(4, 3, 8, 5, device="meta"), mesh,
                          [Replicate(), Replicate()], src_data_rank=None)
    with H.hint_mesh(mesh):
        y = H.shard_hint(x, ("pod", "data"), None, "model", None)
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(y.shape) == (4, 3, 8, 5)


@pytest.mark.parametrize("arch,kind", [
    ("granite-moe-1b-a400m", "train"), ("granite-moe-1b-a400m", "prefill"),
    ("zamba2-7b", "decode")])
def test_dryrun_smoke_cell(fake_mesh, tmp_path, arch, kind):
    """One smoke cell per kind through ``run_cell`` on the 2×4 fake mesh:
    the three roofline terms, collectives by kind and argument bytes."""
    shape, _ = fake_mesh
    seq, batch = (16, 4) if kind == "train" else (64, 8)
    cell = ShapeConfig(f"smoke_{kind}", kind, seq, batch)
    rec = D.run_cell(arch, cell, "2x4", tmp_path, mesh_shape=shape,
                     smoke=True)
    assert rec["ok"], rec.get("error")
    rl = rec["roofline"]
    for k in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert rl[k] >= 0
    assert rl["t_compute_s"] > 0 and rl["t_memory_s"] > 0
    assert rec["chips"] == 8 and rec["memory"]["temp_size_in_bytes"] is None
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["collectives_per_device"]
    assert set(rec["collectives_per_device_by_axis"]) <= {"data", "model"}
    assert rl["flops"] == rec["cost_op_global"]["flops"]
    assert rec["step"] == {"train": "train_step", "prefill": "prefill_step",
                           "decode": "serve_step"}[kind]
    # the cached record comes back on a rerun
    assert D.run_cell(arch, cell, "2x4", tmp_path, mesh_shape=shape,
                      smoke=True) == rec


def test_dryrun_skips_long_context_dense(fake_mesh, tmp_path):
    rec = D.run_cell("llama3.2-3b", "long_500k", "single", tmp_path,
                     mesh_shape=fake_mesh[0])
    assert rec["ok"] and rec["skipped"]
    assert "sub-quadratic" in rec["reason"]
