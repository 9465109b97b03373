"""Paged KV cache: fixed-size pages, per-sequence block tables, accounting.

The serving analogue of the paper's decoupled memory block: one physical
*arena* of ``num_pages`` fixed-size pages (per layer, per K/V) is shared by
every logical sequence, and each sequence reaches its tokens through a
block table — a small indirection stream, exactly how DeMM's compute units
reach a packed weight buffer through ``col_idx``.  Concurrency is then
bounded by *actual* tokens resident, not ``num_slots × max_len`` worst-case
reservations: thousands of logical sequences can share an arena sized for
the live working set, with preemption-by-page-eviction as the backpressure
mechanism (``repro_torch.paged.scheduler``).

This module is the host side, numpy and Python only, a copy of the JAX
package's ``paged/kv_cache.py``: :class:`PagedLayout` (static geometry,
stored in the decode state), :class:`PageAllocator` (free-list +
accounting), and :class:`PagedKVCache` (allocator + per-slot block tables +
token counts, mirrored to the device as a ``(B, NBLK)`` index tensor).  The
device side — gather/scatter indexing and the paged attention paths — lives
in ``repro_torch.models.attention`` (``gather_pages`` /
``scatter_token_pages`` / ``scatter_chunk_pages``).

Page 0 is reserved as the null/scratch page: unallocated block-table
entries point there, masked-lane writes are redirected there, and it is
never read unmasked.  The allocator therefore hands out pages
``1..num_pages-1``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

NULL_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static paged-arena geometry (hashable, frozen).

    * ``page_size``  — tokens per page (P).
    * ``num_pages``  — physical pages in the arena, *including* the reserved
      null page 0; usable pages = ``num_pages - 1``.
    * ``max_blocks`` — block-table width per sequence (NBLK); a sequence can
      grow to ``max_blocks * page_size`` tokens logically, but only pages it
      actually touches are ever allocated.
    """

    page_size: int
    num_pages: int
    max_blocks: int

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved null page), "
                f"got {self.num_pages}")
        if self.max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1, got {self.max_blocks}")

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def tokens_per_seq(self) -> int:
        """Logical per-sequence capacity (the dense cache's ``max_len``)."""
        return self.max_blocks * self.page_size

    @classmethod
    def for_serve(cls, max_len: int, page_size: int = 16,
                  num_pages: Optional[int] = None,
                  num_slots: int = 1) -> "PagedLayout":
        """Geometry for a serve engine: NBLK covers ``max_len``; the default
        arena is fully provisioned (``num_slots * NBLK`` pages + null page,
        i.e. no oversubscription — pass a smaller ``num_pages`` to actually
        share)."""
        nblk = -(-max_len // page_size)
        if num_pages is None:
            num_pages = num_slots * nblk + 1
        return cls(page_size=page_size, num_pages=num_pages, max_blocks=nblk)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` tokens."""
        return -(-tokens // self.page_size)


class PageAllocator:
    """LIFO free-list allocator over pages ``1..num_pages-1`` with
    allocation / free / fragmentation accounting."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2, got {num_pages}")
        self.num_pages = num_pages
        # LIFO: recently freed pages are recycled first (warm-cache friendly)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.alloc_total = 0
        self.free_total = 0
        self.alloc_failures = 0

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` pages or *none* (no partial allocations — a
        failed allocation is the preemption trigger, and partial grants
        would leave half-admitted sequences)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.alloc_total += n
        return pages

    def free(self, pages: Sequence[int]):
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"free of page {p} outside 1..{self.num_pages - 1}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)
        self.free_total += len(pages)

    def fragmentation(self, tokens_resident: int, page_size: int) -> float:
        """Internal fragmentation: fraction of *allocated* token slots not
        holding a token (last-page slack across all sequences).  0.0 when
        nothing is allocated."""
        cap = self.pages_used * page_size
        if cap <= 0:
            return 0.0
        return 1.0 - min(tokens_resident, cap) / cap


class PagedKVCache:
    """Host-side paged-cache bookkeeping for a slot-batched engine.

    Owns the allocator, the per-slot page lists, and the per-slot resident
    token counts; renders the ``(num_slots, max_blocks)`` int32 block table
    the device programs index with.  All methods are O(pages touched) host
    work — the arena itself lives in the decode-state pytree.
    """

    def __init__(self, layout: PagedLayout, num_slots: int):
        self.layout = layout
        self.num_slots = num_slots
        self.allocator = PageAllocator(layout.num_pages)
        self.table = np.full((num_slots, layout.max_blocks), NULL_PAGE,
                             np.int32)
        self._pages: List[List[int]] = [[] for _ in range(num_slots)]
        self.tokens = np.zeros((num_slots,), np.int64)

    # -- queries ------------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return self.allocator.pages_free

    @property
    def pages_used(self) -> int:
        return self.allocator.pages_used

    def occupancy(self) -> float:
        """Fraction of usable arena pages currently allocated."""
        usable = self.layout.usable_pages
        return self.allocator.pages_used / usable if usable else 0.0

    def fragmentation(self) -> float:
        return self.allocator.fragmentation(int(self.tokens.sum()),
                                            self.layout.page_size)

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._pages[slot])

    # -- mutation -----------------------------------------------------------

    def ensure_capacity(self, slot: int, tokens: int) -> bool:
        """Grow slot ``slot`` so positions ``[0, tokens)`` have pages.
        Returns False (allocating nothing) if the arena cannot satisfy it —
        the caller's cue to preempt or wait."""
        need = self.layout.pages_for(tokens)
        if need > self.layout.max_blocks:
            raise ValueError(
                f"slot {slot} needs {need} pages for {tokens} tokens but "
                f"max_blocks={self.layout.max_blocks} "
                f"(logical capacity {self.layout.tokens_per_seq} tokens)")
        have = len(self._pages[slot])
        if need <= have:
            return True
        got = self.allocator.alloc(need - have)
        if got is None:
            return False
        for i, page in enumerate(got):
            self.table[slot, have + i] = page
        self._pages[slot].extend(got)
        return True

    def note_tokens(self, slot: int, tokens: int):
        """Record the resident token count of ``slot`` (accounting only)."""
        self.tokens[slot] = tokens

    def trim(self, slot: int, tokens: int) -> int:
        """Shrink ``slot`` back to the pages covering ``tokens`` tokens,
        freeing the tail pages and nulling their block-table entries.

        The speculative-decode rollback: a verify window grows
        the slot to ``pos + γ + 1`` tokens so drafted positions have pages
        to write into, but only *accepted* tokens may keep pages — the tail
        beyond the committed count is returned to the allocator here, in the
        same tick, so drafted-but-rejected tokens never hold arena capacity
        across ticks.  Returns the number of pages freed."""
        keep = self.layout.pages_for(tokens)
        pages = self._pages[slot]
        if keep >= len(pages):
            return 0
        tail = pages[keep:]
        self.allocator.free(tail)
        self._pages[slot] = pages[:keep]
        self.table[slot, keep:] = NULL_PAGE
        return len(tail)

    def release(self, slot: int) -> int:
        """Free every page of ``slot`` (completion or preemption-eviction).
        Returns the number of pages released."""
        pages = self._pages[slot]
        n = len(pages)
        if n:
            self.allocator.free(pages)
        self._pages[slot] = []
        self.table[slot, :] = NULL_PAGE
        self.tokens[slot] = 0
        return n
