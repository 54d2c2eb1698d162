"""Port parity for the hybrid stack's paged serving (``models/lm.py``'s
hybrid prefill chunk and decode step, ``models/api.py``'s fixed-rows leaf,
``serving/engine.py``, ``serving/faults.py``), on zamba2-7b's f32 smoke
config (2 groups of 2 Mamba2 layers, a tail of 1) with the JAX package's
weights, against the JAX package on the CPU:

- one hybrid prefill chunk (ragged rows, state carried in from an earlier
  chunk, gathered and scattered at ``slots``) and one decode step with a
  partial ``active`` mask: logits within 1e-5 of their largest magnitude,
  pools and fixed rows within 1e-5, the rows of inactive slots bitwise
  unchanged;
- the engine on a pool tight enough to preempt: the JAX engine's greedy
  tokens, token for token, its preemptions and swapped bytes (the
  fixed-rows share apart too); its swap images (the fixed rows and the KV
  rows) within 1e-5 of the JAX engine's, image for image, and each image's
  CRC-32 the reference's ``swap_image_checksum`` of the same bytes (the
  two engines' f32 states differ in their last bits, so their CRCs do
  not);
- under serve's ``--chaos`` plan, non-strict (``fixed_drain`` and
  ``swap_corrupt`` fire on images that carry fixed rows): the JAX engine's
  fault log, counters, per-request outcome and tokens;
- refusals: the prefix cache on a hybrid engine, and RWKV6 on the paged
  engine (``UnsupportedModelError``, in the serve entry too);
- the serve entry on the CPU: PTQ, the ``[note]`` line, preemption.

One JAX engine runs per engine test (its jitted steps compile anew for
every engine).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import convert
from repro_torch.serving import engine as TE
from repro_torch.serving import faults as TF

ARCH = "zamba2-7b"
TIGHT = dict(batch_size=3, max_seq=24, page_size=4, num_pages=1 + 7)


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config(ARCH, smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = get_config(ARCH, smoke=True).with_(dtype="float32")
    return jcfg, jp, tcfg, convert.from_reference(jax.tree.map(np.asarray,
                                                               jp))


def _close(got, want, what):
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                               err_msg=what)


def test_prefill_chunk_and_decode_step_match_jax(models):
    """A ragged second chunk on top of a first one (state carried in), at
    slots (2, 0) of 3, then one decode step with slot 1 inactive."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(0)
    ps, n_pages, b = 4, 12, 3
    jpools = japi.init_paged_cache(jcfg, n_pages, ps)
    tpools = api.init_paged_cache(tcfg, n_pages, ps, "cpu")
    jfix = japi.init_fixed_state(jcfg, b)
    tfix = api.init_fixed_state(tcfg, b, "cpu")
    slots = np.array([2, 0], np.int32)
    table = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    starts = np.zeros(2, np.int32)
    for lens in (np.array([6, 3], np.int32), np.array([5, 7], np.int32)):
        toks = rng.integers(2, jcfg.vocab_size, (2, 8)).astype(np.int32)
        jl, jpools, jfix = japi.prefill_chunk_fn(
            jp, {"tokens": jnp.asarray(toks)}, jpools, jnp.asarray(table),
            jnp.asarray(starts), jnp.asarray(lens), jcfg, backend="xla",
            last_idx=jnp.asarray(lens - 1), fixed=jfix,
            slots=jnp.asarray(slots))
        tl, tpools, tfix = api.prefill_chunk_fn(
            tp, {"tokens": torch.from_numpy(toks)}, tpools,
            torch.from_numpy(table), torch.from_numpy(starts),
            torch.from_numpy(lens), tcfg,
            last_idx=torch.from_numpy(lens - 1), fixed=tfix,
            slots=torch.from_numpy(slots).long())
        _close(tl, jl, "prefill logits")
        starts = starts + lens
    for k in jfix:
        _close(tfix[k], jfix[k], f"fixed {k} after prefill")
    assert not tfix["h"][:, 1].any()          # slot 1 never prefilled
    full_table = np.zeros((b, 5), np.int32)
    full_table[2], full_table[0] = table[0], table[1]
    tok = rng.integers(2, jcfg.vocab_size, (b, 1)).astype(np.int32)
    pos = np.array([starts[1], 0, starts[0]], np.int32)
    active = np.array([True, False, True])
    before = {k: v.clone() for k, v in tfix.items()}
    jl, jpools, jfix = japi.decode_paged_fn(
        jp, {"token": jnp.asarray(tok), "position": jnp.asarray(pos)},
        jpools, jnp.asarray(full_table), jcfg, backend="xla", fixed=jfix,
        active=jnp.asarray(active))
    tl, tpools, tfix = api.decode_paged_fn(
        tp, {"token": torch.from_numpy(tok), "position": torch.from_numpy(pos)},
        tpools, torch.from_numpy(full_table), tcfg, fixed=tfix,
        active=torch.from_numpy(active))
    _close(tl[active], np.asarray(jl)[active], "decode logits")
    for k in jfix:
        _close(tfix[k], jfix[k], f"fixed {k} after decode")
        assert torch.equal(tfix[k][:, 1], before[k][:, 1]), k
        assert not torch.equal(tfix[k][:, 0], before[k][:, 0]), k
    for i, lp in enumerate(tpools["layers"]):
        for k in lp:
            _close(lp[k], jpools["layers"][k][i], f"pool {i} {k}")


def _prompts(vocab, n=6, seed=5):
    rng = np.random.default_rng(seed)
    lens = (3, 7, 10, 5)
    return [rng.integers(2, vocab, size=lens[i % 4]).astype(np.int32)
            for i in range(n)]


def _ref_image(mod, st):
    """A drained swap image in the reference's layout (numpy):
    ``{"kv": {"layers": {leaf: [L, n, ...]}} or None, "fixed": {leaf: [M,
    1, ...]}}``."""
    if mod is JE:
        return jax.tree.map(np.asarray, {"kv": st.rows,
                                         "fixed": st.fixed_rows})
    kv = None
    if st.rows is not None:
        layers = st.rows["layers"]
        kv = {"layers": {k: np.stack([lr[k].numpy() for lr in layers])
                         for k in layers[0]}}
    return {"kv": kv, "fixed": {k: v.numpy()
                                for k, v in st.fixed_rows.items()}}


def _run(mod, params, cfg, prompts, max_tokens=8, plan=None, **kw):
    """Drive an engine step by step, recording each swap image as its CRC-32
    is taken: (submit seq, CRC, fixed-rows bytes, the image, whether the
    ``swap_corrupt`` fault flipped a byte of it after the CRC)."""
    extra = dict(backend="xla") if mod is JE else dict(device="cpu")
    eng = mod.ServingEngine(params, cfg, fault_plan=plan, **kw, **extra)
    reqs = [mod.Request(uid=i, prompt=p, max_tokens=max_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    crcs, seen = [], set()
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
        assert steps < 600
        for seq, st in eng._swapped.items():
            if st.checksum is not None and id(st) not in seen:
                seen.add(id(st))
                crcs.append((seq, st.checksum, st.fbytes,
                             _ref_image(mod, st), st.corrupted))
    return eng, reqs, crcs


def _same_images(tcrcs, jcrcs):
    assert [c[:1] + c[2:3] + c[4:] for c in tcrcs] == \
        [c[:1] + c[2:3] + c[4:] for c in jcrcs]
    for (_, crc, _, img, bad), (_, _, _, jimg, _) in zip(tcrcs, jcrcs):
        assert (crc == japi.swap_image_checksum(img)) != bad
        assert jax.tree.structure(img) == jax.tree.structure(jimg)
        for a, b in zip(jax.tree.leaves(img), jax.tree.leaves(jimg)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(
                1.0, float(np.abs(b).max())))


STATS = ("decoded_tokens", "prefilled_tokens", "steps", "completed",
         "prefill_batches", "preemptions", "resumes", "grown_pages",
         "swapped_out_bytes", "swapped_in_bytes", "swapped_fixed_bytes",
         "swapped_fixed_in_bytes", "idle_steps", "admitted", "failed",
         "retries", "faults_injected")


def test_tight_pool_matches_jax_engine(models):
    """Preemption under pressure: tokens, counters and image CRCs equal the
    JAX engine's; every image carries one slot's fixed rows."""
    jcfg, jp, tcfg, tp = models
    prompts = _prompts(jcfg.vocab_size)
    jeng, jreqs, jcrcs = _run(JE, jp, jcfg, prompts, **TIGHT)
    teng, treqs, tcrcs = _run(TE, tp, tcfg, prompts, **TIGHT)
    st = teng.stats
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for f in STATS:
        assert getattr(st, f) == getattr(jeng.stats, f), f
    assert st.preemptions > 0 and st.resumes == st.preemptions
    one = api.rows_nbytes(api.init_fixed_state(tcfg, 1, "cpu"))
    assert st.swapped_fixed_bytes == st.preemptions * one
    assert st.swapped_fixed_in_bytes == st.swapped_fixed_bytes
    assert st.swapped_out_bytes == st.swapped_in_bytes
    _same_images(tcrcs, jcrcs)
    assert len(tcrcs) == st.preemptions
    teng.pager.check_invariants()
    assert teng.pager.free_pages == teng.pager.num_pages - 1
    assert not teng._swapped


def test_chaos_plan_matches_jax_engine(models):
    """serve's ``--chaos`` plan, non-strict, on the tight pool: the fault
    log (``fixed_drain`` in place of ``swap_drain`` for these images),
    counters, outcomes and tokens equal the JAX engine's."""
    jcfg, jp, tcfg, tp = models
    prompts = _prompts(jcfg.vocab_size, n=7)
    specs = serve.chaos_plan(0).specs
    plans = {JE: JF.FaultPlan([JF.FaultSpec(**dataclasses.asdict(s))
                               for s in specs], seed=0),
             TE: TF.FaultPlan([TF.FaultSpec(**dataclasses.asdict(s))
                               for s in specs], seed=0)}
    kw = dict(TIGHT, strict=False, max_prefill_tokens=8)
    jeng, jreqs, jcrcs = _run(JE, jp, jcfg, prompts, plan=plans[JE], **kw)
    teng, treqs, tcrcs = _run(TE, tp, tcfg, prompts, plan=plans[TE], **kw)
    tplan, jplan = plans[TE], plans[JE]
    assert tplan.log == jplan.log
    assert tplan.injected == jplan.injected
    assert tplan.injected["fixed_drain"] == 1
    assert tplan.injected["swap_drain"] == 0
    assert tplan.injected["swap_corrupt"] == 1
    ctr = "faults_fired_total"
    assert teng.metrics.counter(ctr).snapshot() == \
        jeng.metrics.counter(ctr).snapshot()
    assert [(r.uid, r.finish_reason, r.retries, r.reprefills, r.output)
            for r in treqs] == \
        [(r.uid, r.finish_reason, r.retries, r.reprefills, r.output)
         for r in jreqs]
    assert sum(r.reprefills for r in treqs) == 1
    for f in STATS:
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    _same_images(tcrcs, jcrcs)
    teng.pager.check_invariants()
    assert not teng._swapped


def test_corrupt_swap_image_flips_the_first_fixed_leaf():
    g = torch.Generator().manual_seed(0)
    fixed = {k: torch.randn(3, 1, 4, generator=g)
             for k in ("h", "conv_x", "conv_bc")}
    rows = {"layers": [{"k": torch.randn(2, 4, generator=g)}]}
    keep = {k: v.clone() for k, v in fixed.items()}
    r2, f2 = TF.corrupt_swap_image(rows, fixed)
    assert r2 is rows
    for k in fixed:
        assert torch.equal(fixed[k], keep[k])
    a = f2["conv_bc"].view(-1).view(torch.uint8)
    assert a[0] == keep["conv_bc"].view(-1).view(torch.uint8)[0] ^ 0xFF
    assert f2["h"] is fixed["h"] and f2["conv_x"] is fixed["conv_x"]
    want = JF.corrupt_host_image({"kv": None, "fixed": {
        k: v.numpy() for k, v in fixed.items()}})["fixed"]
    for k in fixed:
        np.testing.assert_array_equal(f2[k].numpy(), want[k])
    assert api.swap_image_checksum(rows, f2) == japi.swap_image_checksum(
        {"kv": {"layers": {"k": rows["layers"][0]["k"][None].numpy()}},
         "fixed": {k: v.numpy() for k, v in f2.items()}})


def test_refusals(models):
    _, _, tcfg, tp = models
    with pytest.raises(ValueError, match="prefix"):
        TE.ServingEngine(tp, tcfg, prefix_cache=True, device="cpu")
    rcfg = get_config("rwkv6-7b", smoke=True).with_(dtype="float32")
    with pytest.raises(TE.UnsupportedModelError, match="paged serving"):
        TE.ServingEngine({}, rcfg, device="cpu")
    with pytest.raises(TE.UnsupportedModelError) as port:
        serve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu"])
    with pytest.raises(JE.UnsupportedModelError) as ref:
        JE.ServingEngine({}, j_get_config("rwkv6-7b", smoke=True),
                         backend="xla")
    assert str(port.value) == str(ref.value)
    assert api.state_leaves(tcfg) == (api.KV_PAGES, api.FIXED_ROWS)
    assert api.state_leaves(rcfg) == (api.KV_PAGES,)


def test_serve_zamba2_on_cpu(capsys):
    res = serve.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                      "--requests", "5", "--batch-size", "3", "--max-seq",
                      "48", "--max-prompt", "30", "--max-tokens", "12",
                      "--page-size", "4", "--num-pages", "14"])
    out = capsys.readouterr().out
    assert "[note] token prefix cache disabled: hybrid slots" in out
    assert "MB fixed-rows state" in out
    eng = res["engine"]
    assert eng.cache is None and eng.stats.preemptions > 0
    assert eng.stats.swapped_fixed_bytes > 0
    assert all(r.finish_reason in ("completed", "length")
               for r in res["requests"])
