"""Port parity for the shared-prefix KV cache (``serving/prefix_cache.py``,
the pager's cached marks, evictor and copy-on-write in
``serving/kv_cache.py``, the cache-aware planner in ``serving/scheduler.py``,
``models/api.py:copy_pool_page``), against the JAX package on the CPU:

- chained block hashes are the reference's byte for byte, in the engine's fp
  (``kvq=0``) and int8 (``kvq=1``) modes;
- one scripted op sequence (insert, match, attach, COW, free, allocation
  under pressure) gives the same pages, LRU eviction order, counters and
  invariants on both pagers;
- ``cow(hold_src=True)`` pins its source until ``drop_hold``;
- ``copy_pool_page`` writes into the pools' own storage (every
  ``data_ptr`` kept) and copies codes and scale leaves bit for bit;
- the engine with ``prefix_cache=True`` serves two waves (a 12-token shared
  prefix, then a page-aligned full match that takes a COW, a repeat, and a
  fresh prompt that evicts) with the JAX engine's greedy tokens and cache
  counters: codellama-7b smoke with fp pools, int8 pools, chunked prefill,
  and deepseek-v2-236b smoke (MLA latent pools); and the warm run's tokens
  equal a cold (cache-off) run's.
"""
from collections import deque

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serving import engine as JE
from repro.serving import kv_cache as JKV
from repro.serving import prefix_cache as JPC
from repro.serving import scheduler as JS
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models import convert
from repro_torch.serving import engine as TE
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving import prefix_cache as TPC
from repro_torch.serving import scheduler as TS

COUNTERS = ("prefix_hits", "prefix_matched_tokens", "pages_shared",
            "pages_inserted", "pages_evicted", "cow_copies",
            "prefilled_tokens", "admitted", "preemptions", "resumes",
            "steps", "decoded_tokens")


# ------------------------------------------------------------- pager level --
@pytest.mark.parametrize("mode", ["kvq=0", "kvq=1"])
def test_block_hashes_equal_reference(mode):
    rng = np.random.default_rng(0)
    toks = rng.integers(2, 32000, 37).astype(np.int32)
    jc = JPC.PrefixCache(JKV.PagePool(9, 4, 1, 8), 4, mode=mode)
    tc = TPC.PrefixCache(TKV.PagePool(9, 4, 1, 8), 4, mode=mode)
    want = jc.block_hashes(toks)
    assert len(want) == 9
    assert tc.block_hashes(toks) == want
    # a memoized head continues the chain the same way
    assert tc.block_hashes(toks, head=want[:3]) == want
    assert tc.block_hashes(list(toks[:17])) == want[:4]
    other = TPC.PrefixCache(TKV.PagePool(9, 4, 1, 8), 4,
                            mode="kvq=1" if mode == "kvq=0" else "kvq=0")
    assert other.block_hashes(toks)[0] != want[0]


def _script(KV, PC):
    """One op sequence on a pager + cache of the given package; returns what
    it observed at every step."""
    pool = KV.PagePool(11, 4, batch_size=3, max_pages_per_slot=6)
    cache = PC.PrefixCache(pool, 4, mode="kvq=0")
    out = []
    a = np.arange(2, 14, dtype=np.int32)               # 3 full pages
    b = np.concatenate([a[:8], [90, 91, 92, 93]]).astype(np.int32)
    pa = pool.alloc(0, 4)
    out.append(("insert", cache.insert(a, pa, 3)))
    got, mtok = cache.match(b)
    out.append(("match_b", got, mtok))
    pool.attach(1, got)
    pb = pool.grow(1, 2)
    out.append(("insert_b", cache.insert(b, pool.slot_pages(1), 3)))
    pool.check_invariants()
    src, dst = pool.cow(1, 1, hold_src=True)
    out.append(("cow", src, dst, pool.page_ref(src), int(pool.held()[src]),
                pool.is_cached(src), pool.is_cached(dst)))
    pool.drop_hold(src)
    pool.check_invariants()
    pool.free_slot(0)
    pool.free_slot(1)
    pool.check_invariants()
    out.append(("evictable", cache.evictable_count(), pool.free_pages,
                sorted(cache.evictable_page_ids())))
    got, mtok = cache.match(a)
    out.append(("match_a", got, mtok))
    # allocation under pressure evicts LRU-first
    order = []
    while pool.free_pages < 10 and cache.evict_one():
        order.append((len(cache), pool.free_pages))
    out.append(("evicted", order, cache.stats.evicted_pages))
    out.append(("counts", dict(pool.counts),
                dict(vars(cache.stats)), pb != []))
    pool.check_invariants()
    return out


def test_scripted_pager_matches_reference():
    assert _script(TKV, TPC) == _script(JKV, JPC)


def _eviction_order(KV, PC):
    """Pages reclaimed by an allocation that needs more than the free list:
    the order the evictor gives them back in."""
    pool = KV.PagePool(9, 4, batch_size=4, max_pages_per_slot=8)
    cache = PC.PrefixCache(pool, 4, mode="")
    seqs = [np.arange(10 * i, 10 * i + 8, dtype=np.int32) for i in range(3)]
    pages = []
    for i, s in enumerate(seqs):
        pages.append(pool.alloc(i, 2))
        cache.insert(s, pages[-1], 2)
    for i in (1, 0, 2):                  # unreferenced in this order
        pool.free_slot(i)
    cache.match(seqs[1])                 # touch: 1's pages become youngest
    free0 = pool.free_pages
    got = pool.alloc(3, free0 + 3)
    return pages, got, cache.stats.evicted_pages, len(cache)


def test_lru_eviction_order_matches_reference():
    t, j = _eviction_order(TKV, TPC), _eviction_order(JKV, JPC)
    assert t == j
    pages, got, evicted, left = t
    assert evicted == 3 and left == 3
    # LRU: seq 0's pages went first (freed after seq 1's, but the match
    # touched seq 1's), then seq 2's first; evicted pages join the free
    # list's end, which allocation pops first
    assert got[:3] == [pages[2][0], pages[0][1], pages[0][0]]


def test_cow_hold_src_pins_source():
    pool = TKV.PagePool(6, 4, batch_size=2, max_pages_per_slot=8)
    cache = TPC.PrefixCache(pool, 4, mode="")
    a = np.arange(2, 10, dtype=np.int32)
    p = pool.alloc(0, 2)
    cache.insert(a, p, 2)
    pool.free_slot(0)                               # 2 evictable, 3 free
    got, _ = cache.match(a)
    pool.attach(1, got)
    src, dst = pool.cow(1, 1, hold_src=True)
    assert src == p[1] and pool.slot_pages(1) == [p[0], dst]
    assert pool.held()[src] == 1 and pool.page_ref(src) == 1
    assert pool.is_cached(src) and not pool.is_cached(dst)
    pool.check_invariants()
    # pinned: an allocation cannot reclaim it
    assert not pool.can_alloc(pool.free_pages + 1)
    with pytest.raises(RuntimeError, match="out of pages"):
        pool.grow(1, pool.free_pages + 1)
    pool.drop_hold(src)                             # copied: now evictable
    assert pool.can_alloc(pool.free_pages + 1)
    pool.check_invariants()
    # without the hold, a released cached source turns evictable at once
    src2, _ = pool.cow(1, 0)
    assert pool.page_ref(src2) == 0 and cache.evictable_count() == 2
    pool.check_invariants()


def test_live_table_tripwire_names_cached_write_page():
    pool = TKV.PagePool(9, 4, batch_size=2, max_pages_per_slot=4)
    cache = TPC.PrefixCache(pool, 4, mode="")
    pages = pool.alloc(0, 2)
    cache.insert(np.arange(8), pages, 2)
    with pytest.raises(TKV.PagerInvariantError, match="copy-on-write") as e:
        TKV.assert_live_tables(pool.table(), np.asarray([6, 0]), 4,
                               [True, False], refs=pool.refs(),
                               held=pool.held(), cached=pool.cached_mask())
    assert e.value.slot == 0
    pool.grow(0, 1)
    TKV.assert_live_tables(pool.table(), np.asarray([9, 0]), 4,
                           [True, False], refs=pool.refs(), held=pool.held(),
                           cached=pool.cached_mask())


def test_plan_charges_suffix_and_takes_cow_like_reference():
    """The planner's buckets (prefix lengths, shared pages, COW pairs, fresh
    pages) equal the reference planner's on the same pool state."""
    def run(KV, PC, S, Request):
        pool = KV.PagePool(33, 4, batch_size=4, max_pages_per_slot=8)
        cache = PC.PrefixCache(pool, 4, mode="")
        sched = S.Scheduler(page_size=4, max_seq=32)
        sys_p = np.arange(2, 14, dtype=np.int32)
        donor = pool.alloc(3, 4)
        cache.insert(sys_p, donor, 3)
        pool.free_slot(3)
        q = deque([Request(uid=0, prompt=np.concatenate([sys_p, [77, 78]]),
                           max_tokens=8),
                   Request(uid=1, prompt=sys_p.copy(), max_tokens=8),
                   Request(uid=2, prompt=np.arange(40, 45, dtype=np.int32),
                           max_tokens=8)])
        bkts = sched.plan(q, [0, 1, 2], pool, cache=cache)
        pool.check_invariants()
        return [(b.pad_len, [r.uid for r in b.reqs], b.slots, b.needs,
                 b.prefix_lens, b.shared, b.cow) for b in bkts], \
            pool.free_pages, pool.held().tolist(), sched.counts
    assert run(TKV, TPC, TS, TE.Request) == run(JKV, JPC, JS, JE.Request)


@pytest.mark.parametrize("arch,kvq", [("codellama-7b", False),
                                      ("codellama-7b", True),
                                      ("deepseek-v2-236b", False),
                                      ("deepseek-v2-236b", True)])
def test_copy_pool_page_in_place_bit_exact(arch, kvq):
    cfg = get_config(arch, smoke=True).with_(dtype="float32", kv_quant=kvq)
    pools = api.init_paged_cache(cfg, 9, 4, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    for lp in pools["layers"]:
        for k, t in lp.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-128, 128, t.shape, generator=g,
                                      dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=g))
    ptrs = [(k, t.data_ptr()) for lp in pools["layers"] for k, t in lp.items()]
    before = [{k: t.clone() for k, t in lp.items()} for lp in pools["layers"]]
    src, dst = torch.tensor([2, 5]), torch.tensor([7, 1])
    out = api.copy_pool_page(pools, src, dst)
    assert out is pools
    assert [(k, t.data_ptr()) for lp in pools["layers"]
            for k, t in lp.items()] == ptrs
    leaves = set()
    for lp, lb in zip(pools["layers"], before):
        for k, t in lp.items():
            leaves.add(k)
            want = lb[k].clone()
            want[dst] = lb[k][src]
            assert torch.equal(t, want), k
    assert any(k.endswith("_s") for k in leaves) == kvq


# ------------------------------------------------------------ engine level --
@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("codellama-7b", "deepseek-v2-236b"):
        jcfg = j_get_config(arch, smoke=True).with_(dtype="float32")
        jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, jp, convert.from_reference(
            jax.tree.map(np.asarray, jp)))
    return out


def _waves(vocab, seed=7):
    """Wave 1: three prompts behind one 12-token (3-page) shared prefix.
    Wave 2: the bare prefix (a page-aligned full match: COW + a one-token
    prefill), a repeat of wave 1's first prompt, a fresh 19-token prompt and
    a fourth prompt on the prefix."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(2, vocab, 12).astype(np.int32)
    w1 = [np.concatenate([sys_p, rng.integers(2, vocab, n).astype(np.int32)])
          for n in (3, 5, 2)]
    w2 = [sys_p.copy(), w1[0].copy(),
          rng.integers(2, vocab, 19).astype(np.int32),
          np.concatenate([sys_p, rng.integers(2, vocab, 6).astype(np.int32)])]
    return w1, w2


def _serve(mod, params, cfg, waves, **kw):
    extra = dict(backend="xla") if mod is JE else dict(device="cpu")
    eng = mod.ServingEngine(params, cfg, batch_size=2, max_seq=32,
                            page_size=4, **extra, **kw)
    outs = []
    for wave in waves:
        reqs = [mod.Request(uid=len(outs) + i, prompt=p.copy(), max_tokens=5)
                for i, p in enumerate(wave)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        outs += [r.output for r in reqs]
    eng.pager.check_invariants()
    return outs, eng


# name -> (arch, kv_quant, engine kwargs); 11 pages (10 + trash) evict and
# preempt under the second wave
ENGINE_CASES = {
    "fp": ("codellama-7b", False, dict(num_pages=11)),
    "int8": ("codellama-7b", True, dict(num_pages=11)),
    "chunked": ("codellama-7b", False, dict(num_pages=11,
                                            max_prefill_tokens=4)),
    "mla": ("deepseek-v2-236b", False, dict(num_pages=11)),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_cache_matches_jax_engine(models, name):
    arch, kvq, kw = ENGINE_CASES[name]
    jcfg, jp, tp = models[arch]
    tcfg = get_config(arch, smoke=True).with_(dtype="float32", kv_quant=kvq)
    waves = _waves(tcfg.vocab_size)
    jouts, jeng = _serve(JE, jp, jcfg.with_(kv_quant=kvq), waves,
                         prefix_cache=True, **kw)
    touts, teng = _serve(TE, tp, tcfg, waves, prefix_cache=True, **kw)
    assert touts == jouts
    ts, js = teng.stats, jeng.stats
    for f in COUNTERS:
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.prefix_hits >= 3 and ts.cow_copies >= 1
    assert ts.pages_evicted > 0 and ts.pages_shared > 0
    # every page is free or cached-evictable once drained
    assert teng.pager.free_pages + teng.pager.evictable_pages() \
        == teng.pager.num_pages - 1
    # warm equals cold: the cache changes no token, only the work
    couts, ceng = _serve(TE, tp, tcfg, waves, **kw)
    assert couts == touts
    assert ceng.stats.prefilled_tokens > ts.prefilled_tokens
    assert ceng.stats.prefix_hits == 0 and ceng.stats.cow_copies == 0
