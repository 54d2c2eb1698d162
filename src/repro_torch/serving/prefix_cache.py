"""Shared-prefix KV cache: block-hash index over pool pages + LRU eviction
(port of ``repro/serving/prefix_cache.py``, the token half).

Many live requests share a long system or few-shot prompt.  Without reuse
each of them re-prefills it and holds a private copy of identical pages.
This module gives the pager an automatic prefix cache, block-granular:

- every *full* page of a sequence gets a chained block hash, ``h_i =
  sha256(h_{i-1} + token_ids(page_i))`` (int32 bytes), rooted in the pool's
  KV quantization mode: int8 and fp pools never cross-match, and a page is
  reachable only through the exact token prefix that produced it.  The
  hashes are the reference's byte for byte;
- the index maps chain hash → resident pool page.  Matching walks a
  prompt's full pages front to back and stops at the first miss, so a hit is
  always a prefix of whole pages;
- cached pages are read-only; the pool keeps them resident after their last
  slot reference drops (refcount 0 + cached = evictable), and this cache
  reclaims them LRU-first through the pool's evictor hook exactly when an
  allocation would otherwise fail;
- evicting a parent makes its descendants unmatchable until the prefix is
  inserted again; a dangling entry can never alias other content.

The scheduler calls :meth:`PrefixCache.match` and ``PagePool.attach`` at
admission (the engine then prefills only the uncached suffix), and the
engine calls :meth:`PrefixCache.insert` with a slot's full pages after its
final prefill chunk and again when the slot finishes, so generated tokens
become matchable too.  The exact-match index over read-only encoder pages
(``data_hashes`` / ``match_exact`` / ``insert_exact``) comes with the
encoder-decoder state leaves (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.kv_cache import PagePool


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0            # match() calls
    hits: int = 0               # match() calls returning >= 1 page
    matched_tokens: int = 0     # sum of matched whole-page tokens
    inserted_pages: int = 0     # pages newly indexed
    evicted_pages: int = 0      # unreferenced cached pages reclaimed


class PrefixCache:
    """Block-hash index + LRU evictor over a :class:`PagePool`.  ``mode`` is
    folded into the root hash so pools with different row encodings (fp vs
    int8 + scales) never share pages."""

    def __init__(self, pool: PagePool, page_size: int, *, mode: str = ""):
        self.pool = pool
        self.page_size = page_size
        self._root = hashlib.sha256(mode.encode()).digest()
        self._index: Dict[bytes, int] = {}     # chain hash -> pool page
        self._by_page: Dict[int, bytes] = {}   # pool page -> chain hash
        self._lru: Dict[int, int] = {}         # evictable page -> last use
        self._clock = 0
        self.stats = PrefixCacheStats()
        self.faults = None                     # FaultPlan (or None)
        pool.set_evictor(self)

    def block_hashes(self, tokens, head=()) -> List[bytes]:
        """Chained hash per full page of ``tokens``.  ``head`` may carry the
        hashes of leading pages already computed (a request's memoized
        prompt hashes at slot finish): full pages never straddle the
        prompt/generation boundary, so only the continuation is chained."""
        toks = np.asarray(tokens, np.int32)
        n = len(toks) // self.page_size
        out = list(head[:n])
        h = out[-1] if out else self._root
        for i in range(len(out), n):
            blk = toks[i * self.page_size:(i + 1) * self.page_size]
            h = hashlib.sha256(h + blk.tobytes()).digest()
            out.append(h)
        return out

    def match(self, tokens, hashes: Optional[List[bytes]] = None,
              probe_faults: bool = True) -> Tuple[List[int], int]:
        """Longest cached whole-page prefix of ``tokens``: ``(pages,
        matched_tokens)``.  Matched evictable pages are LRU-touched, so an
        attach in the same admission cannot lose them to an eviction.
        ``hashes`` (:meth:`block_hashes`, pure in the tokens) skips the
        hashing; ``probe_faults=False`` marks a diagnostic match that must
        spend no fault budget and evict nothing."""
        self.stats.lookups += 1
        pages: List[int] = []
        for h in (hashes if hashes is not None
                  else self.block_hashes(tokens)):
            p = self._index.get(h)
            if p is None:
                break
            pages.append(p)
        if pages and probe_faults and self.faults is not None \
                and self.faults.fires("prefix_evict"):
            # the matched pages vanish between match and attach: evict every
            # evictable one and report a miss (the admission goes cold)
            for p in pages:
                if p in self._lru:
                    self._evict_page(p)
            pages = []
        self._clock += 1
        for p in pages:
            if p in self._lru:
                self._lru[p] = self._clock
        if pages:
            self.stats.hits += 1
            self.stats.matched_tokens += len(pages) * self.page_size
        return pages, len(pages) * self.page_size

    def insert(self, tokens, pages: List[int], n_full: int,
               hashes: Optional[List[bytes]] = None) -> int:
        """Index the first ``n_full`` pages of a slot's written sequence.
        Idempotent: a chain hash already indexed is skipped (a COW copy of a
        cached page, or a second insert at slot finish, stays unindexed).
        The slot must still reference the pages; they are marked read-only
        here.  Returns the number of pages newly indexed."""
        inserted = 0
        if hashes is None:
            hashes = self.block_hashes(tokens)
        for h, p in zip(hashes[:n_full], pages[:n_full]):
            if h in self._index or p in self._by_page:
                continue
            self._index[h] = p
            self._by_page[p] = h
            self.pool.mark_cached(p)
            inserted += 1
        self.stats.inserted_pages += inserted
        return inserted

    # ------------------------------------------------------- evictor hooks --
    def on_unreferenced(self, page: int) -> None:
        """Pool callback: a cached page's last reference dropped."""
        self._clock += 1
        self._lru[page] = self._clock

    def on_referenced(self, page: int) -> None:
        """Pool callback: an evictable page was attached again (pinned)."""
        self._lru.pop(page, None)

    def evictable_count(self) -> int:
        return len(self._lru)

    def evictable_page_ids(self):
        return self._lru.keys()

    def evict_one(self) -> bool:
        """Reclaim the least recently used unreferenced cached page."""
        if not self._lru:
            return False
        self._evict_page(min(self._lru, key=self._lru.get))
        return True

    def _evict_page(self, page: int) -> None:
        del self._lru[page]
        del self._index[self._by_page.pop(page)]
        self.pool.release_cached(page)
        self.stats.evicted_pages += 1

    def __len__(self) -> int:
        return len(self._index)
