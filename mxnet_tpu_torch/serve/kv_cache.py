"""Paged KV cache: host-side page-table allocator + device page pools
(counterpart of ``mxnet_tpu/serve/kv_cache.py``).

All KV memory for all concurrent requests lives in ONE preallocated device
pool of fixed-size pages, ``(n_layers, num_pages, page_size, Hkv, D)`` per
tensor.  A sequence owns an ordered list of physical pages (its page
table); logical position ``p`` lives in page ``table[p // page_size]`` at
offset ``p % page_size``.  Admission, growth and eviction are host-side
free-list operations; the device tensors never reallocate and the engine
writes new K/V into them IN PLACE (the JAX engine donates the pool buffers
through its compiled step for the same effect).

Page 0 is the **null page**: masked writes (padded chunk rows, inactive
slots) land there and no allocation ever returns it.

The int8 pool (``kv_dtype="int8"``) and the cross-request `PrefixIndex`
wait for a later slice (ROADMAP.md queue C); the allocator's reference
counts and `fork` are already here.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from ..ops.paged_attention import ragged_paged_attention

__all__ = ["PageAllocator", "KVPools", "make_paged_kv_fn", "NULL_PAGE"]

NULL_PAGE = 0


class PageAllocator:
    """Free-list allocator over the physical pages of a pool, with
    per-page reference counts for sharing.

    Thread-safe.  Pages are recycled LIFO — a just-freed page is the next
    handed out, keeping the hot working set of physical pages small."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise MXNetError(
                f"KV pool needs >= 2 pages (page 0 is the reserved null "
                f"page), got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list; page 0 (null) is never allocatable
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        # page id -> owner count for every allocated page
        self._ref: Dict[int, int] = {}
        self._lock = threading.Lock()

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def total_pages(self) -> int:
        """Allocatable pages (the null page is not)."""
        return self.num_pages - 1

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently owned by sequences."""
        return 1.0 - self.free_pages / max(1, self.total_pages)

    def pages_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.page_size))

    def can_alloc(self, n: int) -> bool:
        with self._lock:
            return len(self._free) >= n

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take `n` pages, or None (backpressure — caller defers/evicts).
        All-or-nothing."""
        with self._lock:
            if len(self._free) < n:
                return None
            taken = [self._free.pop() for _ in range(n)]
            for p in taken:
                self._ref[p] = 1
        return taken

    def free(self, pages: List[int]) -> None:
        """Release one reference per page; a page returns to the free list
        when its LAST owner lets go."""
        with self._lock:
            for p in pages:
                if p == NULL_PAGE:
                    raise MXNetError("attempt to free the null page")
                ref = self._ref.get(p)
                if ref is None:
                    raise MXNetError(f"double free of page {p}")
                if ref > 1:
                    self._ref[p] = ref - 1
                else:
                    del self._ref[p]
                    self._free.append(p)

    def refcount(self, page: int) -> int:
        """Current owner count of `page` (0 = free/never allocated)."""
        with self._lock:
            return self._ref.get(page, 0)

    def shared_pages(self) -> int:
        """Physical pages with more than one owner."""
        with self._lock:
            return sum(1 for r in self._ref.values() if r > 1)

    def share(self, pages: Sequence[int]) -> None:
        """Add one owner to each (allocated) page."""
        with self._lock:
            for p in pages:
                ref = self._ref.get(p)
                if ref is None:
                    raise MXNetError(
                        f"share of unallocated page {p} (free or never "
                        f"handed out)")
                self._ref[p] = ref + 1

    def fork(self, page: int) -> Optional[Tuple[int, bool]]:
        """Copy-on-write: make `page` exclusively writable for ONE of its
        owners.  Exclusive already returns ``(page, False)``; shared
        returns ``(new_page, True)`` after moving one reference onto a
        fresh page (the CALLER copies the contents).  None when no page is
        free."""
        with self._lock:
            ref = self._ref.get(page)
            if ref is None:
                raise MXNetError(f"fork of unallocated page {page}")
            if ref == 1:
                return page, False
            if not self._free:
                return None
            new = self._free.pop()
            self._ref[new] = 1
            self._ref[page] = ref - 1
        return new, True


class KVPools:
    """Device-side paged K/V storage for every layer: ``k`` and ``v``,
    each (n_layers, num_pages, page_size, Hkv, D) of `dtype`."""

    def __init__(self, n_layers: int, num_pages: int, page_size: int,
                 n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                 device: torch.device):
        shape = (n_layers, num_pages, page_size, n_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.n_layers = n_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim

    def nbytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()


def make_paged_kv_fn(pools: KVPools, page_tables, start_pos, num_tokens,
                     ctx_lens, window=None, attend=ragged_paged_attention):
    """Build the `kv_fn` `transformer_step` calls per layer: write the
    chunk's new K/V into the paged pool in place (``index_copy_`` into a
    flat per-layer view), then attend over each slot's pages with
    `attend` (`ragged_paged_attention`; the plain
    `paged_attention_reference` for an oracle run).

    page_tables: (B, max_pages) int32; start_pos/num_tokens/ctx_lens: (B,)
    int32, all on the pool's device.  Chunk token c of slot b sits at
    absolute position ``start_pos[b] + c`` and is real iff
    ``c < num_tokens[b]`` — padded rows write to the null page, which is
    never read.
    """
    ps = pools.page_size
    maxp = page_tables.shape[1]
    tables = page_tables.long()

    def kv_fn(li, q, k_new, v_new):
        B, Hkv, C, D = k_new.shape
        ar = torch.arange(C, device=k_new.device)
        pos = start_pos.long()[:, None] + ar[None, :]          # (B, C)
        logical = torch.clamp(pos // ps, max=maxp - 1)
        phys = torch.gather(tables, 1, logical)
        flat = phys * ps + pos % ps
        active = ar[None, :] < num_tokens[:, None]
        idx = torch.where(active, flat, NULL_PAGE * ps).reshape(B * C)
        for pool, new in ((pools.k, k_new), (pools.v, v_new)):
            # (B, Hkv, C, D) -> per-token rows (B*C, Hkv, D)
            rows = new.transpose(1, 2).reshape(B * C, Hkv, D)
            pool[li].view(-1, Hkv, D).index_copy_(0, idx,
                                                  rows.to(pool.dtype))
        return attend(q.contiguous(), pools.k[li], pools.v[li], page_tables,
                      ctx_lens, start_pos, window=window)

    return kv_fn
