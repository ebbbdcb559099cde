"""Paged KV-cache page-table allocator — the real-model data plane's memory
manager (a copy of ``repro.runtime.paging``: the port imports nothing from the
JAX package; MaxText ``page_manager.PageState`` is the
reference shape, SNIPPETS #3).

The dense per-slot layout the :class:`~repro_torch.runtime.batching.ContinuousBatcher`
started with allocates ``max_len`` KV positions per slot up front, so a
replica's sustainable ``max_slots`` is capped by worst-case sequence length
and short sequences strand most of it. This module splits the cache into
fixed-size *blocks* of ``block_size`` tokens drawn from one shared pool:

  * every slot owns a *page list* — logical page ``i`` of the slot maps to a
    physical block id; a request only reserves the pages its
    ``min(prompt_len + max_new, max_len)`` tokens can ever touch;
  * allocation is a free list (LIFO reuse); ``reserve`` either hands out all
    pages or raises :class:`PagedCacheOOM` **at admit time** — never a silent
    truncation or a mid-decode failure, per the repo's static-shape rules
    (admitted requests can always run to completion);
  * the table itself is a fixed-shape ``(max_slots, pages_per_slot)`` int32
    array (jit-friendly: it is a *traced* decode-step input, never part of a
    compiled-program spec), with two reserved physical blocks:

      - block 0, :data:`NULL_BLOCK` — the shared read-only tail. Unreserved
        logical pages of every slot point here; its K/V stay zero and its
        positions stay ``-1`` (masked) forever, so gathering through it
        reproduces exactly what a dense cache's zero-padded tail reads.
      - block 1, :data:`TRASH_BLOCK` — the shared write sink. Freed slots'
        rows point here so the decode step's unconditional slot-batched
        writes (inactive slots decode garbage, same as the dense engine)
        land somewhere no active slot ever gathers from.

Conservation invariant (property-tested in tests/test_paging.py and, for this copy,
tests/test_torch_batching.py)::

    len(free) + sum(len(owned[slot])) == n_blocks - 2

Sliding-window layers need only ``ceil(window / block_size)`` leading logical
pages of a slot (the rolling ``pos % window`` index never leaves them), so
local layers shrink per-slot footprint further with no extra bookkeeping —
see ``repro_torch.models.attention.attn_decode_paged`` for the layout contract.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["NULL_BLOCK", "TRASH_BLOCK", "PagedCacheOOM", "PageAllocator",
           "pages_needed"]

#: physical block 0: shared zero/masked tail — read-only, never allocated.
NULL_BLOCK = 0
#: physical block 1: shared write sink for freed/inactive slots — never read
#: by an active slot, never allocated.
TRASH_BLOCK = 1
#: blocks reserved for the two sentinels above.
RESERVED_BLOCKS = 2


class PagedCacheOOM(RuntimeError):
    """Raised loudly when a reservation cannot be satisfied — either the
    request can never fit (raise at submit) or the caller asked for a
    reservation the free list cannot cover right now (admission should have
    checked :meth:`PageAllocator.can_reserve` first)."""


def pages_needed(prompt_len: int, max_new: int, max_len: int,
                 block_size: int) -> int:
    """Pages a request must reserve: every KV position it can ever write.

    Prefill writes positions ``[0, prompt_len)``; decode writes at most
    ``max_new`` further positions and the engine stops at ``max_len - 1``,
    so the highest written position is ``min(prompt_len + max_new, max_len)
    - 1``. Sliding-window layers write at ``pos % window < window <= need``
    and therefore never need pages beyond this bound either.
    """
    need = min(prompt_len + max_new, max_len)
    return max(1, -(-need // block_size))


class PageAllocator:
    """Free-list block allocator + fixed-shape per-slot page table.

    ``n_blocks`` counts *physical* blocks including the two sentinels; the
    allocatable pool is ``n_blocks - 2``. ``pages_per_slot`` is the logical
    page count (``max_len / block_size``) — the static table width.
    """

    def __init__(self, n_blocks: int, block_size: int, max_slots: int,
                 pages_per_slot: int):
        if block_size < 1 or n_blocks <= RESERVED_BLOCKS:
            raise ValueError(
                f"need block_size >= 1 and n_blocks > {RESERVED_BLOCKS}, got "
                f"block_size={block_size} n_blocks={n_blocks}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.pages_per_slot = int(pages_per_slot)
        # LIFO free list: hot blocks are reused first (cache-friendly).
        self._free: List[int] = list(range(self.n_blocks - 1,
                                           RESERVED_BLOCKS - 1, -1))
        self._owned: Dict[int, List[int]] = {}
        # freed/never-admitted slots absorb writes in TRASH_BLOCK
        self.table = np.full((self.max_slots, self.pages_per_slot),
                             TRASH_BLOCK, np.int32)

    # ------------------------------------------------------------- accounting

    @property
    def n_allocatable(self) -> int:
        return self.n_blocks - RESERVED_BLOCKS

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return sum(len(v) for v in self._owned.values())

    def check_conservation(self) -> None:
        """allocated + free == total allocatable, no duplicates, no sentinel
        leakage — the free-list conservation invariant."""
        assert self.n_free + self.n_allocated == self.n_allocatable, (
            self.n_free, self.n_allocated, self.n_allocatable)
        seen = set(self._free)
        assert len(seen) == len(self._free), "duplicate blocks in free list"
        for slot, blocks in self._owned.items():
            for b in blocks:
                assert b not in seen and b >= RESERVED_BLOCKS, (slot, b)
                seen.add(b)
        assert len(seen) == self.n_allocatable

    # ------------------------------------------------------------- allocation

    def can_reserve(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def fits_ever(self, n_pages: int) -> bool:
        """Whether a request of this size could be admitted into an empty
        pool at all — the submit-time loud-OOM check."""
        return n_pages <= self.n_allocatable and n_pages <= self.pages_per_slot

    def reserve(self, slot: int, n_pages: int) -> np.ndarray:
        """Give ``slot`` ownership of ``n_pages`` blocks; logical pages
        ``[0, n_pages)`` map to them and the tail maps to NULL_BLOCK.
        Returns the slot's table row. Raises :class:`PagedCacheOOM` when the
        free list cannot cover the reservation."""
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        if n_pages < 1 or n_pages > self.pages_per_slot:
            raise PagedCacheOOM(
                f"request needs {n_pages} pages but a slot spans at most "
                f"{self.pages_per_slot} (max_len / block_size)")
        if n_pages > len(self._free):
            raise PagedCacheOOM(
                f"paged KV pool exhausted: need {n_pages} blocks, "
                f"{len(self._free)} free of {self.n_allocatable}")
        blocks = [self._free.pop() for _ in range(n_pages)]
        self._owned[slot] = blocks
        self.table[slot, :n_pages] = blocks
        self.table[slot, n_pages:] = NULL_BLOCK
        return self.table[slot]

    def free(self, slot: int) -> None:
        """Return the slot's blocks to the pool; its row becomes a pure
        write sink (TRASH_BLOCK) until the next reservation."""
        blocks = self._owned.pop(slot, None)
        if blocks is None:
            raise RuntimeError(f"slot {slot} holds no reservation")
        self._free.extend(reversed(blocks))
        self.table[slot] = TRASH_BLOCK

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))
