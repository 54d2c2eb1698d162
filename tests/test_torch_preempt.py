"""Port parity for preemption and swap (``serving/engine.py``,
``serving/kv_cache.py``, ``models/api.py``), on the f32 smoke configs of
codellama-7b (fp and int8 KV pools) and deepseek-v2-236b (MLA latent pools):

- under a pool too small for the batch (the reference's
  ``tests/test_lazy_paging.py`` cases), the port's engine emits the JAX
  engine's (``backend="xla"``) greedy tokens, token for token, with the same
  preemptions, resumes, grown pages and swapped bytes, and the same tokens
  as its own roomy run; the pager ends with every page free;
- the pager's swap holds, ``split_for_swap`` / ``swap_out`` / ``swap_in`` and
  ``check_invariants`` follow the reference pager op for op;
- ``swap_image_checksum`` equals the reference's on the same rows;
- a byte flipped in a drained host image turns the victim into a re-prefill
  whose greedy output still equals the roomy run's; a second corrupt image
  fails the request.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serving import engine as JE
from repro.serving import kv_cache as JKV
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models import convert
from repro_torch.serving import engine as TE
from repro_torch.serving import kv_cache as TKV

# name → (arch, kv_quant, engine kwargs, requests, max_tokens), as the
# reference's lazy-paging tests run them (MLA with 12 new tokens, not 6, so
# that its pool preempts too)
CASES = {
    "fp": ("codellama-7b", False,
           dict(batch_size=3, max_seq=24, page_size=4, num_pages=1 + 7), 6, 8),
    "int8": ("codellama-7b", True,
             dict(batch_size=3, max_seq=24, page_size=4, num_pages=1 + 7),
             5, 8),
    "mla": ("deepseek-v2-236b", False,
            dict(batch_size=2, max_seq=16, page_size=4, num_pages=1 + 5),
            4, 12),
}


def _prompts(vocab, n, seed=5):
    rng = np.random.default_rng(seed)
    lens = (3, 7, 10, 5)
    return [rng.integers(2, vocab, size=lens[i % 4]).astype(np.int32)
            for i in range(n)]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in {c[0] for c in CASES.values()}:
        jcfg = j_get_config(arch, smoke=True).with_(dtype="float32")
        jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, jp, convert.from_reference(
            jax.tree.map(np.asarray, jp)))
    return out


def _case(models, name):
    arch, kvq, kw, n, max_tokens = CASES[name]
    jcfg, jp, tp = models[arch]
    tcfg = get_config(arch, smoke=True).with_(dtype="float32", kv_quant=kvq)
    return jcfg.with_(kv_quant=kvq), jp, tcfg, tp, kw, n, max_tokens


def _serve_port(tp, tcfg, prompts, max_tokens, kw, hook=None):
    eng = TE.ServingEngine(tp, tcfg, device="cpu", **kw)
    reqs = [TE.Request(uid=i, prompt=p, max_tokens=max_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    if hook is None:
        eng.run_until_drained()
    else:
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            hook(eng)
    eng.pager.check_invariants()
    assert eng.pager.free_pages == eng.pager.num_pages - 1
    return eng, reqs


@pytest.mark.parametrize("name", list(CASES))
def test_tight_pool_matches_jax_engine(models, name):
    """Token for token and counter for counter: preemptions, resumes,
    grown pages and the bytes swapped out and back in."""
    jcfg, jp, tcfg, tp, kw, n, max_tokens = _case(models, name)
    prompts = _prompts(jcfg.vocab_size, n)
    jeng = JE.ServingEngine(jp, jcfg, backend="xla", **kw)
    jreqs = [JE.Request(uid=i, prompt=p, max_tokens=max_tokens)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    js = jeng.run_until_drained()
    eng, reqs = _serve_port(tp, tcfg, prompts, max_tokens, kw)
    st = eng.stats
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert st.preemptions > 0 and st.resumes == st.preemptions
    assert st.swapped_out_bytes == st.swapped_in_bytes > 0
    for f in ("preemptions", "resumes", "grown_pages", "swapped_out_bytes",
              "swapped_in_bytes", "steps", "decoded_tokens", "idle_steps",
              "active_slot_steps", "max_active"):
        assert getattr(st, f) == getattr(js, f), f
    assert not eng._swapped


@pytest.mark.parametrize("name", list(CASES))
def test_tight_pool_matches_roomy_pool(models, name):
    """Preemption is a scheduling effect only: the tight pool's tokens equal
    the default pool's, which never preempts."""
    _, _, tcfg, tp, kw, n, max_tokens = _case(models, name)
    prompts = _prompts(tcfg.vocab_size, n)
    roomy, rreqs = _serve_port(tp, tcfg, prompts, max_tokens,
                               {**kw, "num_pages": None})
    tight, treqs = _serve_port(tp, tcfg, prompts, max_tokens, kw)
    assert roomy.stats.preemptions == 0 and roomy.stats.grown_pages > 0
    assert tight.stats.preemptions > 0
    assert [r.output for r in treqs] == [r.output for r in rreqs]


def _flip_first_drained(eng, state):
    """After a step: flip byte 0 of the first drained host image's first
    leaf, once."""
    if state.get("victim") is not None:
        return
    for seq, st in eng._swapped.items():
        if st.on_host and st.rows is not None:
            leaf = st.rows["layers"][0][sorted(st.rows["layers"][0])[0]]
            leaf.view(-1).view(torch.uint8)[0] ^= 0xFF
            state["victim"] = seq
            return


def test_corrupt_swap_image_reprefills(models):
    """The CRC catches a flipped byte at swap-in: the victim re-prefills
    its prompt and generated tokens instead of resuming, and its greedy
    output (and everyone's) still equals the roomy run's."""
    _, _, tcfg, tp, kw, n, max_tokens = _case(models, "fp")
    prompts = _prompts(tcfg.vocab_size, n)
    _, rreqs = _serve_port(tp, tcfg, prompts, max_tokens,
                           {**kw, "num_pages": None})
    state = {}
    eng, reqs = _serve_port(tp, tcfg, prompts, max_tokens, kw,
                            hook=lambda e: _flip_first_drained(e, state))
    victim = next(r for r in reqs if r.submit_seq == state["victim"])
    assert victim.reprefills == 1 and victim._gen_in_prompt > 0
    assert eng.stats.resumes == eng.stats.preemptions - 1
    assert [r.output for r in reqs] == [r.output for r in rreqs]
    assert all(r.finish_reason in ("completed", "length") for r in reqs)


def test_second_corrupt_swap_image_fails_the_request(models):
    _, _, tcfg, tp, kw, n, max_tokens = _case(models, "fp")
    prompts = _prompts(tcfg.vocab_size, n)
    state = {}

    def hook(eng):
        if state.get("victim") is None:
            _flip_first_drained(eng, state)
            for r in eng.queue:
                if r.submit_seq == state.get("victim"):
                    r.reprefills = 1            # its one re-prefill spent
    eng, reqs = _serve_port(tp, tcfg, prompts, max_tokens, kw, hook=hook)
    victim = next(r for r in reqs if r.submit_seq == state["victim"])
    assert victim.finish_reason == "failed" and eng.stats.failed == 1
    assert all(r.finish_reason in ("completed", "length")
               for r in reqs if r is not victim)


def _ops(pool, mod):
    """One op sequence on a pager of module ``mod``: allocate, share a page,
    grow, swap a slot holding a shared page out and back in, abandon a
    hold."""
    a = pool.alloc(0, 2)
    pool.alloc(1, 1)
    pool.attach(1, a[:1])                    # slot 1 shares slot 0's page
    pool.grow(1, 1)
    pool.check_invariants()
    kept, private = pool.split_for_swap(1)
    assert kept == [(1, a[0])] and [li for li, _ in private] == [0, 2]
    pool.swap_out(1, (kept, private))
    assert pool.held()[a[0]] == 1 and pool.page_ref(a[0]) == 2
    assert (pool.table()[1] == mod.TRASH_PAGE).all()
    pool.check_invariants()
    with pytest.raises(RuntimeError, match="stale"):
        pool.swap_out(0, ([], [(0, a[1])]))
    fresh = pool.swap_in(2, kept, [0, 2])
    assert pool.slot_pages(2)[1] == a[0] and len(fresh) == 2
    assert pool.held()[a[0]] == 0
    pool.check_invariants()
    kept, private = pool.split_for_swap(2)
    pool.swap_out(2, (kept, private))
    pool.drop_hold(a[0])                     # the image was discarded
    pool.check_invariants()
    return (pool.table().copy(), pool.refs().copy(), pool.held().copy(),
            pool.free_pages, fresh)


def test_pager_swap_ops_follow_the_reference():
    mk = dict(num_pages=9, page_size=4, batch_size=3, max_pages_per_slot=4)
    got = _ops(TKV.PagePool(**mk), TKV)
    want = _ops(JKV.PagePool(**mk), JKV)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_tripwires_count_swap_holds():
    pool = TKV.PagePool(9, 4, batch_size=2, max_pages_per_slot=3)
    a = pool.alloc(0, 2)
    pool.attach(1, a[:1])
    pool.swap_out(1, pool.split_for_swap(1))  # slot 1's share: a hold
    TKV.assert_live_tables(pool.table(), np.array([5, 0]), 4, [True, False],
                           refs=pool.refs(), held=pool.held())
    with pytest.raises(TKV.PagerInvariantError, match="refcount"):
        TKV.assert_live_tables(pool.table(), np.array([5, 0]), 4,
                               [True, False], refs=pool.refs())
    with pytest.raises(TKV.PagerInvariantError, match="shared"):
        TKV.assert_live_tables(pool.table(), np.array([1, 0]), 4,
                               [True, False], refs=pool.refs(),
                               held=pool.held())


@pytest.mark.parametrize("arch,kv_quant,dtype", [
    ("codellama-7b", False, "float32"), ("codellama-7b", True, "float32"),
    ("codellama-7b", False, "bfloat16"), ("deepseek-v2-236b", True,
                                          "float32")])
def test_swap_image_checksum_equals_reference(arch, kv_quant, dtype):
    """The same rows give the same CRC-32 in both packages (the port's
    per-layer leaves against the reference's ``[L, n, ...]`` stacks), and
    scattering them back restores the pools bit for bit."""
    cfg = get_config(arch, smoke=True).with_(dtype=dtype, kv_quant=kv_quant)
    pools = api.init_paged_cache(cfg, 6, 4, "cpu")
    gen = torch.Generator().manual_seed(0)
    for lp in pools["layers"]:
        for k, t in lp.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
            else:
                t.copy_(torch.randn(t.shape, generator=gen))
    pages = torch.tensor([4, 1, 3])
    rows = api.gather_pool_rows(pools, pages)
    stacked = {"layers": {
        k: np.stack([lr[k].float().numpy() if dtype == "bfloat16"
                     else lr[k].numpy() for lr in rows["layers"]])
        for k in rows["layers"][0]}}
    if dtype == "bfloat16":
        stacked = {"layers": {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                              for k, v in stacked["layers"].items()}}
    want = japi.swap_image_checksum({"kv": stacked, "fixed": None})
    assert api.swap_image_checksum(rows) == want
    assert api.rows_nbytes(rows) == sum(
        v.nbytes for v in stacked["layers"].values())
    before = [{k: t.clone() for k, t in lp.items()} for lp in pools["layers"]]
    for lp in pools["layers"]:
        for t in lp.values():
            t[pages] = 0
    api.scatter_pool_rows(pools, rows, pages)
    for lp, lb in zip(pools["layers"], before):
        for k in lp:
            assert torch.equal(lp[k], lb[k])
