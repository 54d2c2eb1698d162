"""Paged KV cache pager (port of ``repro/serving/kv_cache.py``, core).

The decode cache is one pool per layer, ``k[num_pages, page_size, Hkv,
Dh]``, shared by every slot; this host-side :class:`PagePool` hands pages to
slots on admission, grows tables lazily during decode and reclaims pages on
finish.  Logical position ``t`` of slot ``s`` lives at
``pool[table[s, t // page_size], t % page_size]``.  Page 0 is the trash
page: every unused table entry points at it, so idle rows' writes land
somewhere harmless.

Pages carry refcounts and belong to one *group* of tables (``"kv"`` first);
:meth:`PagePool.attach` shares resident pages into a slot.  Preemption swaps
a slot out (:meth:`PagePool.split_for_swap`, :meth:`PagePool.swap_out`,
:meth:`PagePool.swap_in`): its private pages' rows go to the host and the
pages return to the free list, while its shared pages stay resident under
*swap holds* until resume re-acquires them (or :meth:`PagePool.drop_hold`
abandons them).  The prefix-cache evictor, copy-on-write and the read-only
groups' detach / reattach of the reference pager wait for the slices that
port those features (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

TRASH_PAGE = 0


class PagerInvariantError(RuntimeError):
    """A pager tripwire fired (stale table, refcount drift)."""

    def __init__(self, msg: str, slot: Optional[int] = None):
        super().__init__(msg)
        self.slot = slot


class PagePool:
    """Host-side page allocator over the device pools.

    Invariants (:meth:`check_invariants`): the trash page is never
    allocated or held; ``ref[p]`` equals the number of table listings of
    ``p`` plus its swap holds; ``free`` and ``{ref > 0}`` partition ``{1,
    .., num_pages-1}``; a page is listed by at most one group's tables.
    """

    def __init__(self, num_pages: int, page_size: int, batch_size: int,
                 max_pages_per_slot: int, groups: Tuple[str, ...] = ("kv",)):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        if page_size < 1 or max_pages_per_slot < 1:
            raise ValueError("page_size/max_pages_per_slot must be >= 1")
        if groups[0] != "kv":
            raise ValueError(f"group 'kv' must come first, got {groups!r}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.batch_size = batch_size
        self.max_pages_per_slot = max_pages_per_slot
        self.groups = tuple(groups)
        self._maxp: Dict[str, int] = {g: max_pages_per_slot for g in groups}
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._slot_pages_g: Dict[str, List[List[int]]] = {
            g: [[] for _ in range(batch_size)] for g in groups}
        self._table_g: Dict[str, np.ndarray] = {
            g: np.full((batch_size, self._maxp[g]), TRASH_PAGE, np.int32)
            for g in groups}
        self._ref = np.zeros(num_pages, np.int32)   # slot listings + holds
        self._held: Dict[int, int] = {}             # page -> swap-hold count

    # ------------------------------------------------------------- queries --
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return max(1, -(-tokens // self.page_size))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def slot_pages(self, slot: int, group: str = "kv") -> List[int]:
        return list(self._slot_pages_g[group][slot])

    def table(self, group: str = "kv") -> np.ndarray:
        """[B, max_pages_per_slot(group)] int32 page ids (trash-padded)."""
        return self._table_g[group]

    def page_ref(self, page: int) -> int:
        return int(self._ref[page])

    def refs(self) -> np.ndarray:
        """[num_pages] int32 refcounts (slot listings + swap holds)."""
        return self._ref

    def held(self) -> np.ndarray:
        """[num_pages] int32 swap-hold counts."""
        h = np.zeros(self.num_pages, np.int32)
        for p, n in self._held.items():
            h[p] = n
        return h

    # ------------------------------------------------------- alloc / free ---
    def _release(self, page: int) -> None:
        self._ref[page] -= 1
        assert self._ref[page] >= 0, f"refcount underflow on page {page}"
        if self._ref[page] == 0:
            self._free.append(page)

    def alloc(self, slot: int, n: int) -> List[int]:
        """Give ``slot`` ``n`` pages.  The slot must currently own none."""
        if self._slot_pages_g["kv"][slot]:
            raise RuntimeError(f"slot {slot} already owns pages")
        return self.grow(slot, n)

    def grow(self, slot: int, n: int = 1, group: str = "kv") -> List[int]:
        """Append ``n`` fresh private pages to ``slot``'s table."""
        sp, tab = self._slot_pages_g[group], self._table_g[group]
        owned = len(sp[slot])
        if owned + n > self._maxp[group]:
            raise ValueError(
                f"slot {slot} would own {owned + n} {group} pages > "
                f"max={self._maxp[group]}")
        if n > len(self._free):
            raise RuntimeError(f"out of pages: need {n}, free "
                               f"{len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        sp[slot].extend(pages)
        tab[slot, owned:owned + n] = pages
        return pages

    def attach(self, slot: int, pages: List[int], group: str = "kv") -> None:
        """Share already-referenced pages into ``slot``'s table (one more
        reference each), appended in order."""
        sp, tab = self._slot_pages_g[group], self._table_g[group]
        owned = len(sp[slot])
        if owned + len(pages) > self._maxp[group]:
            raise ValueError(
                f"slot {slot} would own {owned + len(pages)} {group} pages "
                f"> max={self._maxp[group]}")
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("cannot attach the trash page")
            if self._ref[p] == 0:
                raise RuntimeError(f"page {p} is not resident (freed?)")
            self._ref[p] += 1
        sp[slot].extend(pages)
        tab[slot, owned:owned + len(pages)] = pages

    def drop_hold(self, page: int) -> None:
        """Release one hold on ``page`` (a swap image discarded): the
        reference it kept alive is dropped normally."""
        self._unhold(page)
        self._release(page)

    def _unhold(self, page: int) -> None:
        held = self._held[page] - 1
        if held:
            self._held[page] = held
        else:
            del self._held[page]

    def free_slot(self, slot: int) -> None:
        """Release every page ``slot`` lists, across all groups."""
        for g in self.groups:
            self.free_group(slot, g)

    def free_group(self, slot: int, group: str) -> None:
        sp, tab = self._slot_pages_g[group], self._table_g[group]
        for p in sp[slot]:
            self._release(p)
        sp[slot] = []
        tab[slot, :] = TRASH_PAGE

    # ------------------------------------------------------- swap support ---
    def split_for_swap(self, slot: int) -> Tuple[List[Tuple[int, int]],
                                                 List[Tuple[int, int]]]:
        """Partition ``slot``'s kv pages into ``(kept, private)`` lists of
        ``(logical_idx, page)``.  *Kept* pages are shared (refcount > 1):
        they stay in the pool under a hold and resume re-acquires them.
        *Private* pages are the ones whose rows round-trip through the host
        swap buffer."""
        kept, private = [], []
        for li, p in enumerate(self._slot_pages_g["kv"][slot]):
            (kept if self._ref[p] > 1 else private).append((li, p))
        return kept, private

    def swap_out(self, slot: int,
                 split: Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]
                 ) -> None:
        """Preemption: release ``slot``'s private pages (their rows must
        already be captured) and turn its references on shared pages into
        swap holds.  ``split`` is the caller's :meth:`split_for_swap`
        result, validated against the slot's current pages so that a pager
        change between the gather and the swap-out fails loudly instead of
        freeing pages whose rows were never captured."""
        sp, tab = self._slot_pages_g["kv"], self._table_g["kv"]
        kept, private = split
        if sorted(kept + private) != list(enumerate(sp[slot])):
            raise RuntimeError(
                f"swap_out partition is stale for slot {slot}: the pager "
                "changed between split_for_swap and swap_out")
        for _, p in kept:
            self._held[p] = self._held.get(p, 0) + 1
        for _, p in private:
            self._release(p)
        sp[slot] = []
        tab[slot, :] = TRASH_PAGE

    def swap_in(self, slot: int, kept: List[Tuple[int, int]],
                private_lis: List[int]) -> List[int]:
        """Resume a preempted request into ``slot``: each hold on a kept page
        turns back into a slot reference, and fresh private pages are
        allocated at ``private_lis``.  Returns the fresh page ids in
        ``private_lis`` order, ready for the swap-buffer scatter."""
        sp, tab = self._slot_pages_g["kv"], self._table_g["kv"]
        if sp[slot]:
            raise RuntimeError(f"slot {slot} already owns pages")
        if len(private_lis) > len(self._free):
            raise RuntimeError(f"out of pages: need {len(private_lis)}, "
                               f"free {len(self._free)}")
        fresh = [self._free.pop() for _ in private_lis]
        entries: Dict[int, int] = {}
        for li, p in kept:
            self._unhold(p)
            entries[li] = p
        for li, p in zip(private_lis, fresh):
            self._ref[p] = 1
            entries[li] = p
        if sorted(entries) != list(range(len(entries))):
            raise RuntimeError(f"swap-in logical pages not contiguous: "
                               f"{sorted(entries)}")
        pages = [entries[li] for li in range(len(entries))]
        sp[slot] = pages
        tab[slot, :len(pages)] = pages
        return fresh

    # ---------------------------------------------------------- invariants --
    def check_invariants(self) -> None:
        counts = np.zeros(self.num_pages, np.int64)
        group_of: Dict[int, str] = {}
        for g in self.groups:
            for sp in self._slot_pages_g[g]:
                for p in sp:
                    counts[p] += 1
                    other = group_of.setdefault(p, g)
                    assert other == g, (
                        f"page {p} listed by both {other!r} and {g!r} "
                        "group tables")
        held = self.held()
        assert counts[TRASH_PAGE] == 0, "trash page was allocated"
        assert TRASH_PAGE not in self._free, "trash page in free list"
        assert held[TRASH_PAGE] == 0, "trash page held"
        assert (self._ref == counts + held).all(), \
            "refcounts out of sync with slot tables + swap holds"
        free = set(self._free)
        assert len(free) == len(self._free), "free list duplicate"
        referenced = set(np.nonzero(self._ref)[0].tolist())
        assert not (free & referenced), "free page still referenced"
        assert free | referenced == set(range(1, self.num_pages)), \
            "page leak / invention"
        for g in self.groups:
            tab = self._table_g[g]
            for s, sp in enumerate(self._slot_pages_g[g]):
                assert tab[s, :len(sp)].tolist() == sp, f"{g} table out of sync"
                assert (tab[s, len(sp):] == TRASH_PAGE).all(), \
                    f"{g} table out of sync (tail)"
                assert len(set(sp)) == len(sp), \
                    f"slot {s} lists a {g} page twice"


def assert_live_tables(table, write_pos, page_size: int, active, *,
                       refs=None, held=None) -> None:
    """Pager tripwires, vectorized: an active slot's live table prefix (the
    pages covering positions 0..write_pos) must never reference the trash
    page, and with ``refs`` (+ ``held``, the swap holds) every table listing
    must be counted (``refs == listings + holds``) and the page under each
    active write cursor must be private (one reference, no hold)."""
    table = np.asarray(table)
    write_pos = np.asarray(write_pos)
    active = np.asarray(active, bool)
    b, p_max = table.shape
    need = write_pos // page_size + 1
    cols = np.arange(p_max)[None, :]
    stale = active[:, None] & (cols < need[:, None]) & (table == TRASH_PAGE)
    if stale.any():
        s, lp = np.argwhere(stale)[0]
        raise PagerInvariantError(
            f"stale page table: active slot {int(s)} (write position "
            f"{int(write_pos[s])}) references the trash page at logical page "
            f"{int(lp)}", slot=int(s))
    if refs is None:
        return
    refs = np.asarray(refs)
    held = np.zeros_like(refs) if held is None else np.asarray(held)
    occ = np.bincount(table[table != TRASH_PAGE].ravel(),
                      minlength=refs.shape[0])
    bad = np.nonzero(refs != occ + held)[0]
    bad = bad[bad != TRASH_PAGE]
    if bad.size:
        p = int(bad[0])
        raise PagerInvariantError(
            f"refcount out of sync: page {p} has ref={int(refs[p])} but "
            f"{int(occ[p])} table listings + {int(held[p])} swap holds")
    wp_page = table[np.arange(b), np.minimum(write_pos // page_size,
                                             p_max - 1)]
    shared = active & ((refs[wp_page] - held[wp_page] != 1)
                       | (held[wp_page] != 0))
    if shared.any():
        s = int(np.argmax(shared))
        raise PagerInvariantError(
            f"shared-page write hazard: active slot {s} would write position "
            f"{int(write_pos[s])} into page {int(wp_page[s])} "
            f"(ref={int(refs[wp_page[s]])}, held={int(held[wp_page[s]])})",
            slot=s)
