"""Host-side paged KV-cache bookkeeping for the continuous batcher (port
of ``repro.serve.paged_cache``).

The device side is ``models.lm.init_paged_state`` / ``decode_step_paged``:
attention K/V live in one physical page pool ``(L, n_pages, page_size,
KVH, hd)``, addressed through a per-slot block table.  This module owns
the host half:

* :class:`PageAllocator`: the free list over physical pages.  Page 0 is
  the **dead page** (free slots and unmapped block-table entries point
  there; reads of it are masked, writes to it are garbage by design), so
  allocations hand out pages ``1..n_pages-1``.  ``peak_in_use`` is what
  the paged-memory claim is asserted on;
* :func:`scatter_prefill_state`: after a batch-1 ``lm.prefill`` for a
  newly admitted request, write its K/V caches into the slot's pages of
  the pool and its recurrent state into the slot's rows, in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

DEAD_PAGE = 0


class PageAllocator:
    """Free-list allocator over the physical KV page pool.

    LIFO reuse (a freed page is handed out again first) keeps the pool's
    working set compact; correctness never depends on which page a slot
    gets, because all addressing goes through the block table.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the dead page)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._allocated: set = set()
        self.in_use = 0
        self.peak_in_use = 0
        self.total_allocs = 0

    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if not self.can_alloc(n):
            raise RuntimeError(
                f"KV page pool exhausted: requested {n}, "
                f"{len(self._free)} free of {self.n_pages - 1} "
                f"(raise n_pages, shrink max_slots, or admit less)")
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        self.in_use += n
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list.

        Guarded: freeing the dead page, a page outside the pool, or a page
        that is not currently allocated (double free) raises, since a page
        listed twice would later be handed to two slots at once.  The
        whole batch is checked before any page is re-listed, so a rejected
        call leaves the allocator untouched.
        """
        pages = list(pages)
        seen = set()
        for pg in pages:
            if pg == DEAD_PAGE:
                raise ValueError("freeing the dead page")
            if not (0 < pg < self.n_pages):
                raise ValueError(f"freeing page {pg} outside pool "
                                 f"[1, {self.n_pages - 1}]")
            if pg not in self._allocated or pg in seen:
                raise ValueError(f"double free of page {pg}")
            seen.add(pg)
        for pg in pages:
            self._allocated.discard(pg)
            self._free.append(pg)
        self.in_use -= len(pages)


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def reclaimable_pages(pos: int, horizon: Optional[int],
                      page_size: int) -> int:
    """The count ``r`` of leading logical pages dead for every future read
    at ``pos' >= pos``: page ``j`` (tokens ``[jP, (j+1)P)``) is dead once
    ``(j+1)·P - 1 <= pos - horizon``.  0 when the horizon is unbounded
    (``None``)."""
    if horizon is None:
        return 0
    return max(0, (pos - horizon + 1) // page_size)


# --------------------------------------------------------------------------
# prefill → pages
# --------------------------------------------------------------------------

def _logical_kv(cache: torch.Tensor, padded_len: int) -> torch.Tensor:
    """Prefill cache ``(L, 1, cache_len, KVH, hd)`` → logical ``(L,
    padded_len, KVH, hd)``.

    Global-attention caches are already logical (``cache_len ==
    padded_len`` when prefill ran with ``max_seq=padded_len``).  A
    local-window cache in rolling layout (slot ``t % window`` holds
    position ``t``) is gathered modulo its length; entries before
    ``prompt - window`` pick up stale slots, which the window mask at
    read time excludes.
    """
    cache_len = cache.shape[2]
    if cache_len == padded_len:
        return cache[:, 0]
    idx = torch.arange(padded_len, device=cache.device) % cache_len
    return cache[:, 0, idx]


def scatter_prefill_state(state: Dict[str, Any], pstate: Dict[str, Any],
                          slot: int, phys_pages: Sequence[int],
                          page_size: int) -> Dict[str, Any]:
    """Write a batch-1 prefill's caches into an admitted slot.

    ``state``: the engine's paged decode state (``init_paged_state``
    layout); ``pstate``: the state ``lm.prefill`` returned for the single
    new request, run with ``max_seq = len(phys_pages) * page_size``.
    Attention K/V (``(L, 1, cache_len, KVH, hd)``) scatter page-aligned
    into the pool at the slot's physical pages; recurrent ``conv`` /
    ``h`` / ``state`` rows overwrite row ``slot``, which also resets
    whatever the previous occupant or a free slot's garbage step left
    there.  Both ``groups`` and ``tail`` are written, **in place** (the
    reference returns an updated copy); returns ``state``.
    """
    padded_len = len(phys_pages) * page_size
    phys = torch.as_tensor(np.asarray(phys_pages, np.int64))
    for key in ("groups", "tail"):
        for bkey, cache in state.get(key, {}).items():
            for name, arr in cache.items():
                src = pstate[key][bkey][name]
                if name not in ("k", "v"):
                    arr[:, slot] = src[:, 0].to(arr.dtype)
                elif padded_len:
                    logical = _logical_kv(src, padded_len)
                    arr[:, phys.to(arr.device)] = logical.reshape(
                        logical.shape[0], len(phys_pages), page_size,
                        *logical.shape[2:]).to(arr.dtype)
    return state


def make_table(slot_pages: Sequence[Sequence[int]],
               max_pages: int) -> np.ndarray:
    """Per-slot page lists → dense ``(n_slots, max_pages)`` block table;
    unmapped entries point at the dead page."""
    table = np.full((len(slot_pages), max_pages), DEAD_PAGE, np.int32)
    for i, pages in enumerate(slot_pages):
        if len(pages) > max_pages:
            raise ValueError(f"slot {i}: {len(pages)} pages > table "
                             f"width {max_pages}")
        table[i, :len(pages)] = pages
    return table


def assert_paged_memory_bound(allocator: PageAllocator, n_slots: int,
                              max_pages: int) -> Dict[str, int]:
    """The paged-memory claim as numbers: peak pool usage (pages actually
    allocated at the high-water mark) against the ``n_slots ×
    max_pages`` a static per-slot cache pins."""
    static_pages = n_slots * max_pages
    return {"peak_pages": allocator.peak_in_use,
            "pool_pages": allocator.n_pages - 1,
            "static_equiv_pages": static_pages}
