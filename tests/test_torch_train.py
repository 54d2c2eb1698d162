"""Port parity for training on the f32 codellama-7b smoke config, against
the JAX package on the same weights and batches:

- ``lr_schedule``, ``clip_by_global_norm`` and the int8 error-feedback
  round trip against ``repro.optim.adamw`` (f32 rtol 1e-6; the int8 codes
  exactly);
- ``SyntheticTokens.batch_at`` bit-equal to the reference's (tokens,
  labels, and an encoder-decoder's frames);
- ``api.loss_fn`` and its gradients, remat off and on, against
  ``jax.value_and_grad(api.loss_fn)``: loss rtol 1e-6, each gradient leaf
  within 1e-4 of its L2 norm (sums run in another order);
- 3 steps of ``make_train_step`` (plain, ``microbatch=2``, ``int8_ef``)
  against the reference's jitted one: losses rtol 1e-5, pre-clip grad norms
  rtol 1e-4, parameters after each step leaf by leaf within 1e-4 relative
  L2 (Adam's ``m̂ / (√v̂ + ε)`` turns a 1e-7 relative gradient difference
  into a larger one where a gradient is small, so the parameters compare in
  L2, not element by element); under ``int8_ef`` an int8 code flips where
  a gradient sits within rounding of a half-code tie (one element moves by a
  whole code step), so there the parameters agree within 1e-3 relative L2,
  the first moments within 1e-2, and the residuals differ on at most 0.5 %
  of a leaf's elements (or 2), by at most a code step;
- checkpoints: the JAX package saves at step 2 and the port restores and
  takes step 3, which equals the reference's step 3 (tolerances as above),
  and the reverse; the port's own save → restore → step is bitwise its
  uninterrupted step; partial writes ignored, ``keep``, a shape mismatch or
  a missing leaf raising;
- SIGTERM saves a checkpoint, in a subprocess; one that lands inside
  AdamW's leaf loop saves the whole step at its end;
- ``launch.train.main(--device cpu)`` resumes from its checkpoint and
  continues with the losses of the uninterrupted run.
"""
import json
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as j_get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro.optim import adamw as JAW
from repro.train import trainer as JTR
from repro_torch import tree as T
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.optim import adamw as TAW
from repro_torch.train import trainer as TTR

ARCH = "codellama-7b"
SEQ, BATCH, STEPS = 32, 4, 3
VARIANTS = {
    "plain": {},
    "microbatch": {"microbatch": 2},
    "int8_ef": {"grad_compression": "int8_ef"},
}
TC_KW = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL, GN_RTOL, PARAM_RTOL = 1e-5, 1e-4, 1e-4
# int8_ef: the code flips at half-code ties (module docstring)
EF_PARAM_RTOL, EF_MU_RTOL, EF_FLIP_SHARE = 1e-3, 1e-2, 5e-3
ROOT = Path(__file__).resolve().parent.parent


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """A reference tree (params or OptState) → the port's, on the CPU."""
    return convert.from_reference(_np(tree))


def _data_cfg(vocab):
    return dict(vocab_size=vocab, seq_len=SEQ, global_batch=BATCH)


@pytest.fixture(scope="module")
def ref():
    """The reference's 3 jitted steps per variant: per step the loss, the
    grad norm and the (params, OptState) after it."""
    jcfg = j_get_config(ARCH, smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    data = JSyntheticTokens(JDataConfig(**_data_cfg(jcfg.vocab_size)), jcfg)
    runs = {}
    for name, kw in VARIANTS.items():
        tc = JTrainConfig(**TC_KW, **kw)
        step_fn = jax.jit(JTR.make_train_step(jcfg, tc, backend="xla"))
        p, st = jp, JAW.init_opt_state(jp, tc)
        steps = []
        for i in range(STEPS):
            p, st, m = step_fn(p, st, data.batch_at(i))
            steps.append(dict(loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]),
                              lr=float(m["lr"]), state=(p, st)))
        runs[name] = dict(tc=tc, step_fn=step_fn, steps=steps)
    return dict(jcfg=jcfg, jp=jp, data=data, runs=runs)


def _tcfg():
    return get_config(ARCH, smoke=True).with_(dtype="float32")


def _tdata(cfg):
    return SyntheticTokens(DataConfig(**_data_cfg(cfg.vocab_size)), cfg,
                           device="cpu")


def _assert_params_close(got, want, rtol=PARAM_RTOL, what=""):
    """Leaf by leaf relative L2 (``want`` in the port's layout)."""
    for i, (a, b) in enumerate(zip(T.leaves(got), T.leaves(want),
                                   strict=True)):
        err = float((a.double() - b.double()).norm())
        assert err <= rtol * float(b.double().norm()) + 1e-12, \
            f"{what} leaf {i}: rel L2 {err / float(b.double().norm()):.3g}"


# ------------------------------------------------------------ optimizer ---
@pytest.mark.parametrize("kw", [dict(warmup_steps=3, total_steps=12),
                                dict(warmup_steps=0, total_steps=5),
                                dict(warmup_steps=4, total_steps=4)])
def test_lr_schedule_matches_reference(kw):
    for step in range(0, 16):
        want = float(JAW.lr_schedule(JTrainConfig(**kw), jnp.int32(step)))
        got = float(TAW.lr_schedule(TrainConfig(**kw),
                                    torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    jg, jn = JAW.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                     max_norm)
    tg, tn = TAW.clip_by_global_norm(
        {"a": torch.from_numpy(tree["a"]),
         "b": {"c": torch.from_numpy(tree["b"]["c"])}}, max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    np.testing.assert_allclose(tg["a"].numpy(), np.asarray(jg["a"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tg["b"]["c"].numpy(),
                               np.asarray(jg["b"]["c"]), rtol=1e-6)


def test_int8_error_feedback_matches_reference():
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((9, 13)) * 1e-2).astype(np.float32)
    e = (rng.standard_normal((9, 13)) * 1e-4).astype(np.float32)
    jq, ja = JAW.compress_int8(jnp.asarray(g))
    tq, ta = TAW.compress_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ta) == float(ja)
    np.testing.assert_array_equal(TAW.decompress_int8(tq, ta).numpy(),
                                  np.asarray(JAW.decompress_int8(jq, ja)))
    (jd,), (je,) = JAW.compress_grads_with_ef([jnp.asarray(g)],
                                              [jnp.asarray(e)])
    (td,), (te,) = TAW.compress_grads_with_ef([torch.from_numpy(g)],
                                              [torch.from_numpy(e)])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-9)


# ----------------------------------------------------------------- data ---
@pytest.mark.parametrize("arch", [ARCH, "whisper-medium"])
def test_batch_at_bit_equal_to_reference(arch):
    jcfg = j_get_config(arch, smoke=True)
    tcfg = get_config(arch, smoke=True)
    dc = dict(seed=7, vocab_size=jcfg.vocab_size, seq_len=70, global_batch=3)
    jb = JSyntheticTokens(JDataConfig(**dc), jcfg).batch_at(5)
    tb = SyntheticTokens(DataConfig(**dc), tcfg, device="cpu").batch_at(5)
    assert set(tb) == set(jb) == ({"tokens", "labels", "frames"}
                                  if jcfg.encdec else {"tokens", "labels"})
    for k in jb:
        want = np.asarray(jb[k].astype(jnp.float32) if k == "frames"
                          else jb[k])
        got = tb[k].to(torch.float32).numpy() if k == "frames" \
            else tb[k].numpy()
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert tb["tokens"].dtype == torch.int32
    it = SyntheticTokens(DataConfig(**dc), tcfg, device="cpu").iterate(5)
    assert torch.equal(next(it)["tokens"], tb["tokens"])


# ------------------------------------------------------- loss and grads ---
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(ref, remat):
    jcfg, tcfg = ref["jcfg"], _tcfg()
    batch = ref["data"].batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg, backend="xla", remat=remat)))(
            ref["jp"], batch)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tl, tg = TTR.value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg, remat=remat),
        _port(ref["jp"]), tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    _assert_params_close(tg, T.leaves(_port(jg)), what="grad")


# ------------------------------------------------------------ the steps ---
def _port_run(ref, name, steps=STEPS):
    """The port's steps of variant ``name`` from the reference's initial
    params: per step (loss, grad norm, lr, a copy of (params, OptState))."""
    tcfg = _tcfg()
    tc = TrainConfig(**TC_KW, **VARIANTS[name])
    step_fn = TTR.make_train_step(tcfg, tc)
    params = _port(ref["jp"])
    st = TAW.init_opt_state(params, tc)
    data = _tdata(tcfg)
    out = []
    for i in range(steps):
        params, st, m = step_fn(params, st, data.batch_at(i))
        out.append(dict(loss=float(m["loss"]),
                        grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                        params=T.map_leaves(torch.clone, params),
                        state=TAW.OptState(
                            st.step.clone(), T.map_leaves(torch.clone, st.mu),
                            T.map_leaves(torch.clone, st.nu),
                            None if st.ef is None
                            else T.map_leaves(torch.clone, st.ef))))
    return out


@pytest.fixture(scope="module")
def port_runs(ref):
    return {name: _port_run(ref, name) for name in VARIANTS}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_steps_match_reference(ref, port_runs, name):
    ef = name == "int8_ef"
    p_rtol, mu_rtol = (EF_PARAM_RTOL, EF_MU_RTOL) if ef else (PARAM_RTOL,
                                                              PARAM_RTOL)
    for i, (got, want) in enumerate(zip(port_runs[name],
                                        ref["runs"][name]["steps"])):
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL), i
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=GN_RTOL), i
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6), i
        jp, jst = want["state"]
        _assert_params_close(got["params"], _port(jp), rtol=p_rtol,
                             what=f"step {i}")
        _assert_params_close(got["state"].mu, _port(jst.mu), rtol=mu_rtol,
                             what=f"step {i} mu")
        assert int(got["state"].step) == int(jst.step) == i + 1
        assert (got["state"].ef is None) == (not ef) == (jst.ef is None)
        if ef:
            for a, b in zip(T.leaves(got["state"].ef),
                            T.leaves(_port(jst.ef)), strict=True):
                diff = (a - b).abs()
                top = float(b.abs().max())
                # a flip moves an element by a code step, about twice the
                # largest residual; f32 noise moves it far less
                flips = int((diff > 0.25 * top).sum())
                assert flips <= max(2, EF_FLIP_SHARE * diff.numel()), \
                    f"step {i}: {flips} residual flips"
                assert float(diff.max()) <= 2.5 * top, f"step {i}"
    assert port_runs[name][-1]["loss"] < port_runs[name][0]["loss"]


# ---------------------------------------------------------- checkpoints ---
@pytest.mark.parametrize("name", ["plain", "int8_ef"])
def test_jax_checkpoint_restores_in_port(ref, port_runs, name, tmp_path):
    """The JAX package saves (params, OptState) after step 2; the port
    restores it and its step 3 equals the reference's step 3."""
    run = ref["runs"][name]
    JCheckpointManager(tmp_path).save(2, run["steps"][1]["state"],
                                      {"loss": 0.0})
    tcfg = _tcfg()
    like = (port_runs[name][0]["params"], port_runs[name][0]["state"])
    (params, st), meta = CheckpointManager(tmp_path).restore(
        like, device="cpu")
    assert meta["step"] == 2 and int(st.step) == 2
    step_fn = TTR.make_train_step(tcfg, TrainConfig(**TC_KW,
                                                    **VARIANTS[name]))
    params, st, m = step_fn(params, st, _tdata(tcfg).batch_at(2))
    want = run["steps"][2]
    assert float(m["loss"]) == pytest.approx(want["loss"], rel=LOSS_RTOL)
    _assert_params_close(params, _port(want["state"][0]),
                         rtol=EF_PARAM_RTOL if name == "int8_ef"
                         else PARAM_RTOL, what="step 3")


@pytest.mark.parametrize("name", ["plain", "int8_ef"])
def test_port_checkpoint_restores_in_jax(ref, port_runs, name, tmp_path):
    """The port saves after step 2; the JAX package restores it into its
    own tree and its step 3 equals the port's step 3."""
    got = port_runs[name]
    CheckpointManager(tmp_path).save(
        2, (got[1]["params"], got[1]["state"]), {"loss": got[1]["loss"]})
    run = ref["runs"][name]
    (jp, jst), meta = JCheckpointManager(tmp_path).restore(
        run["steps"][0]["state"])
    assert meta["step"] == 2 and int(jst.step) == 2
    jp, jst, m = run["step_fn"](jp, jst, ref["data"].batch_at(2))
    assert float(m["loss"]) == pytest.approx(got[2]["loss"], rel=LOSS_RTOL)
    _assert_params_close(got[2]["params"], _port(jp),
                         rtol=EF_PARAM_RTOL if name == "int8_ef"
                         else PARAM_RTOL, what="step 3")


def test_port_checkpoint_continues_bitwise(ref, port_runs, tmp_path):
    got = port_runs["microbatch"]
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, (got[1]["params"], got[1]["state"]))
    tcfg = _tcfg()
    fresh = _port(ref["jp"])
    tc = TrainConfig(**TC_KW, **VARIANTS["microbatch"])
    (params, st), _ = mgr.restore((fresh, TAW.init_opt_state(fresh, tc)))
    params, st, m = TTR.make_train_step(tcfg, tc)(
        params, st, _tdata(tcfg).batch_at(2))
    assert float(m["loss"]) == got[2]["loss"]
    for a, b in zip(T.leaves(params), T.leaves(got[2]["params"])):
        assert torch.equal(a, b)


def test_checkpoint_manager_keep_partial_and_mismatch(tmp_path):
    params = {"layers": [{"w": torch.ones(2, 3)}, {"w": torch.zeros(2, 3)}],
              "embed": {"table": torch.arange(6.).reshape(3, 2).to(
                  torch.bfloat16)}}
    st = TAW.init_opt_state(params, TrainConfig())
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, (params, st), {"tag": s})
    (tmp_path / "step_00000009.tmp").mkdir()          # a write cut short
    (tmp_path / "step_00000008").mkdir()              # no meta.json yet
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    (p2, st2), meta = mgr.restore((params, st))
    assert meta == {"step": 3, "tag": 3}
    assert p2["embed"]["table"].dtype == torch.bfloat16
    assert torch.equal(p2["embed"]["table"], params["embed"]["table"])
    assert torch.equal(p2["layers"][0]["w"], params["layers"][0]["w"])
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        assert set(z.files) == {
            "0␟layers␟w", "0␟embed␟table", "1␟.step", "1␟.mu␟layers␟w",
            "1␟.mu␟embed␟table", "1␟.nu␟layers␟w", "1␟.nu␟embed␟table"}
        assert z["0␟layers␟w"].shape == (2, 2, 3)
        assert z["0␟embed␟table"].dtype == np.float32
    wide = {"layers": [{"w": torch.ones(2, 4)}, {"w": torch.ones(2, 4)}],
            "embed": params["embed"]}
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore((wide, TAW.init_opt_state(wide, TrainConfig())))
    more = dict(params, head={"w": torch.ones(1)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore((more, st))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore((params, st))


def test_sigterm_saves_checkpoint(tmp_path):
    script = textwrap.dedent(f"""
        import os, signal, sys, torch
        sys.path.insert(0, {str(ROOT / 'src')!r})
        from repro_torch.checkpoint.manager import (
            CheckpointManager, install_sigterm_checkpoint)
        from repro_torch.configs.base import TrainConfig
        from repro_torch.optim import adamw
        params = {{"w": torch.ones(3)}}
        opt = adamw.init_opt_state(params, TrainConfig())
        mgr = CheckpointManager({str(tmp_path)!r})
        install_sigterm_checkpoint(
            lambda: mgr.save(7, (params, opt), {{"reason": "sigterm"}}))
        os.kill(os.getpid(), signal.SIGTERM)
        print("survived")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == -signal.SIGTERM, res.stderr
    assert "survived" not in res.stdout
    assert CheckpointManager(tmp_path).latest_step() == 7


def test_sigterm_mid_update_saves_a_whole_step(tmp_path):
    """A SIGTERM that lands inside AdamW's leaf loop (the params, moments
    and residual are half updated) saves at the step's end: the checkpoint
    equals, array for array, the one an uninterrupted run writes there."""
    a, b = tmp_path / "a", tmp_path / "b"
    script = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {str(ROOT / 'src')!r})
        from repro_torch import tree
        from repro_torch.configs import get_config
        from repro_torch.launch import train
        from repro_torch.models import api
        from repro_torch.optim import adamw
        args = ["--arch", {ARCH!r}, "--smoke", "--device", "cpu",
                "--steps", "4", "--batch", "4", "--seq", "16",
                "--lr", "3e-3", "--grad-compression", "int8_ef"]
        train.main(args + ["--ckpt-dir", {str(a)!r}, "--ckpt-every", "2"])
        n = len(tree.leaves(api.init_model(get_config({ARCH!r}, smoke=True),
                                           seed=0, device="cpu")))
        orig, calls = adamw._adam_leaf, [0]
        def leaf(*args_):
            orig(*args_)
            calls[0] += 1
            if calls[0] == n + 3:     # the 4th leaf of the 2nd step
                os.kill(os.getpid(), signal.SIGTERM)
        adamw._adam_leaf = leaf
        train.main(args + ["--ckpt-dir", {str(b)!r}, "--ckpt-every", "100"])
        print("survived")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == -signal.SIGTERM, res.stderr
    assert "survived" not in res.stdout
    assert CheckpointManager(b).latest_step() == 2
    da, db = a / "step_00000002", b / "step_00000002"
    assert json.loads((db / "meta.json").read_text())["reason"] == "sigterm"
    with np.load(da / "arrays.npz") as za, np.load(db / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert int(zb["1␟.step"]) == 2
        for k in za.files:
            np.testing.assert_array_equal(zb[k], za[k], err_msg=k)


# ------------------------------------------------------------------ CLI ---
class _Stop(Exception):
    pass


def test_train_main_resumes_from_checkpoint(tmp_path, monkeypatch):
    from repro_torch.launch import train

    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "16", "--lr", "3e-3"]
    full = train.main(args)

    make = train.make_train_step

    def stop_at_3(cfg, tc):
        """The train step, failing when it is called for step 3."""
        fn, calls = make(cfg, tc), [0]

        def step(*a):
            calls[0] += 1
            if calls[0] == 4:
                raise _Stop
            return fn(*a)

        return step

    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    monkeypatch.setattr(train, "make_train_step", stop_at_3)
    with pytest.raises(_Stop):
        train.main(args + ck)
    monkeypatch.undo()
    assert CheckpointManager(tmp_path).latest_step() == 3
    resumed = train.main(args + ck)
    assert resumed == full[3:]
    assert CheckpointManager(tmp_path).latest_step() == 6
    assert full[-1] < full[0]


def test_train_main_defaults_to_the_card():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would train on it")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
