"""The train step on the card against the same step on the CPU (codellama-7b
smoke, f32 with TF32 off, the same converted params and batches):

- 3 steps of ``make_train_step`` with ``microbatch=2`` and
  ``grad_compression="int8_ef"``, and 3 plain steps with remat off, each
  step from the CPU's state before it: losses and pre-clip grad norms
  rtol 1e-5; per leaf of the parameters and first moments at most 1 % of
  the elements (or 2) move by more than 1e-3 of the leaf's largest
  magnitude (an int8 code flips where a gradient sits within rounding of
  a half-code tie: its moment moves by ~1/127 of the largest, its weight
  by up to ±lr) and the rest agree within 1e-4 relative L2; then 3 steps
  run free on each device: losses rtol 1e-4, parameters 5e-3 relative L2
  a leaf (the flips compound);
- a checkpoint saved at step 2 and restored on the card takes step 3 equal
  to the uninterrupted run's (loss rtol 1e-6, parameters 1e-5 relative L2:
  the card may sum a scatter in another order from run to run);
- a loss that would reach the flash kernel (B4) or a quantized weight's
  W4A16 kernel with grad-requiring operands raises.

Marked ``cuda``: skipped where there is no GPU.  Run on the GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda_train.py``.
"""
import pytest
import torch

from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.quantize import quantize
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import strict_fp32_matmul
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step, value_and_grad

pytestmark = pytest.mark.cuda

TC_KW = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
VARIANTS = {"microbatch_ef": dict(microbatch=2, grad_compression="int8_ef"),
            "plain_no_remat": dict(remat="none")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    strict_fp32_matmul()
    return torch.device("cuda")


def _cfg():
    return get_config("codellama-7b", smoke=True).with_(dtype="float32")


def _data(device):
    cfg = _cfg()
    return SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=4), cfg, device=device)


def _to(tree, device):
    return T.map_leaves(lambda t: t.to(device, copy=True), tree)


def _run(params, tc, device, steps=3):
    data = _data(device)
    params = _to(params, device)
    st = adamw.init_opt_state(params, tc)
    step_fn = make_train_step(_cfg(), tc)
    out = []
    for i in range(steps):
        params, st, m = step_fn(params, st, data.batch_at(i))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    _to(params, "cpu")))
    return out, params, st


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_steps_card_match_cpu(dev, name):
    """Each step from the CPU's state before it, on both devices."""
    tc = TrainConfig(**TC_KW, **VARIANTS[name])
    step_fn = make_train_step(_cfg(), tc)
    data = {"cpu": _data("cpu"), "cuda": _data(dev)}
    params = api.init_model(_cfg(), seed=0, device="cpu")
    st = adamw.init_opt_state(params, tc)
    for i in range(3):
        cp = _to(params, dev)
        cst = adamw.OptState(st.step.to(dev), _to(st.mu, dev),
                             _to(st.nu, dev), _to(st.ef, dev))
        params, st, m = step_fn(params, st, data["cpu"].batch_at(i))
        cp, cst, cm = step_fn(cp, cst, data["cuda"].batch_at(i))
        for k in ("loss", "grad_norm"):
            assert float(cm[k]) == pytest.approx(float(m[k]), rel=1e-5), i
        for a, b in zip(T.leaves(cp) + T.leaves(cst.mu),
                        T.leaves(params) + T.leaves(st.mu)):
            d = (a.cpu().double() - b.double()).abs()
            keep = d <= 1e-3 * float(b.abs().max())
            assert int((~keep).sum()) <= max(2, 0.01 * a.numel()), i
            assert float(d[keep].norm()) <= 1e-4 * float(
                b.double()[keep].norm()), i
    # 3 steps run free on each device: int8 code flips compound, so the
    # bound is the flip model's (chip_smoke.py's FREE_RUN_TOL: losses 1e-4
    # relative, parameters 5e-3 relative L2 a leaf)
    p0 = api.init_model(_cfg(), seed=0, device="cpu")
    free, host = _run(p0, tc, dev)[0], _run(p0, tc, "cpu")[0]
    assert free[-1][0] < free[0][0]
    for (lc, _, pc), (lh, _, ph) in zip(free, host):
        assert lc == pytest.approx(lh, rel=1e-4)
        for a, b in zip(T.leaves(pc), T.leaves(ph)):
            assert float((a.double() - b.double()).norm()) <= 5e-3 * float(
                b.double().norm())


def test_restore_on_card_continues(dev, tmp_path):
    tc = TrainConfig(**TC_KW, **VARIANTS["microbatch_ef"])
    p0 = api.init_model(_cfg(), seed=0, device="cpu")
    full, _, _ = _run(p0, tc, dev, steps=3)
    part, params, st = _run(p0, tc, dev, steps=2)
    CheckpointManager(tmp_path).save(2, (params, st))
    fresh = T.map_leaves(lambda t: t.to(dev, copy=True), p0)
    (params, st), _ = CheckpointManager(tmp_path).restore(
        (fresh, adamw.init_opt_state(fresh, tc)), device=dev)
    cfg = _cfg()
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=4), cfg, device=dev)
    params, st, m = make_train_step(cfg, tc)(params, st, data.batch_at(2))
    # the restored state is the saved one bit for bit; the step itself may
    # sum in another order on the card (the embedding's backward scatters)
    assert float(m["loss"]) == pytest.approx(full[2][0], rel=1e-6)
    for a, b in zip(T.leaves(params), T.leaves(full[2][2])):
        err = float((a.cpu().double() - b.double()).norm())
        assert err <= 1e-5 * float(b.double().norm())


def test_grad_guard_on_card(dev):
    cfg = _cfg()
    params = api.init_model(cfg, seed=0, device=dev)
    batch = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       global_batch=2), cfg,
                            device=dev).batch_at(0)
    fcfg = cfg.with_(attn_impl="flash")
    with pytest.raises(RuntimeError, match="flash_attention.*requires grad"):
        value_and_grad(lambda p, b: api.loss_fn(p, b, fcfg), params, batch)
    params["layers"][0]["mixer"]["wq"]["w"] = quantize(
        params["layers"][0]["mixer"]["wq"]["w"], 16)
    with pytest.raises(RuntimeError, match="w4a16_matmul.*requires grad"):
        value_and_grad(lambda p, b: api.loss_fn(p, b, cfg), params, batch)
