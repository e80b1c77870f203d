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

**Shared pages and copy-on-write**: every allocated page carries a
reference count.  A page with refcount > 1 is read-only — `PageAllocator.
share` adds owners (the cross-request `PrefixIndex` attaching cached
prompt blocks to a new sequence), and a writer must `fork` first: the fork
moves one reference onto a fresh physical page, the caller copies the
contents on the device (`InferenceEngine.copy_page`), and only then writes
into it.  `free` is a decref; a page returns to the free list when its
last owner lets go, so N concurrent requests attend over ONE copy of a
shared prompt prefix while each owns its divergent suffix.

The int8 pool (``kv_dtype="int8"``) stores int8 K/V rows with one f32
scale a stored vector (``k_scale`` / ``v_scale``, `contrib.quantization.
quantize_kv`): D + 4 bytes a vector against 4D in f32.  Its writes
quantize each new row and write row and scale through the same flat index;
attention reads the rows and scales as they are (K1's int8 variant).
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from ..contrib.quantization import quantize_kv
from ..ops.paged_attention import ragged_paged_attention

__all__ = ["PageAllocator", "PrefixIndex", "KVPools", "make_paged_kv_fn",
           "NULL_PAGE"]

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


class _PrefixEntry:
    """One cached token block: a single shared read-only page holding
    ``n_tokens`` (< page_size for a terminal partial block) of KV."""

    __slots__ = ("key", "page", "tokens", "n_tokens", "parent", "stamp")

    def __init__(self, key, page: int, tokens: tuple, n_tokens: int,
                 parent, stamp: int):
        self.key = key
        self.page = page
        self.tokens = tokens
        self.n_tokens = n_tokens
        self.parent = parent
        self.stamp = stamp


class PrefixIndex:
    """Cross-request prompt-prefix cache: token-block prefixes -> shared
    read-only KV page runs.

    Entries are chained per page-sized block and keyed by EXACT token
    content — ``key = (parent_key, block_tokens)`` — so a hit guarantees
    the cached KV was computed from the same tokens (no hash-collision
    risk).  Each entry owns one allocator reference on its page;
    `lookup` walks the chain for a new prompt and adds a reference per
    matched page for the requesting sequence (the scheduler then skips
    those prefill chunks entirely).  A prompt's trailing partial block
    is cached too (at most one per parent): attaching it means the new
    sequence's first write lands INSIDE a shared page, which is exactly
    the copy-on-write fork case.

    Under pool pressure `evict_pages` drops least-recently-used entries
    whose page has refcount 1 (sole owner = this index) — a page any
    live sequence still reads is never reclaimed.  Thread-safe:
    `longest_match` may be probed from submit threads while the step
    loop inserts and attaches."""

    _ROOT = ()

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._entries: Dict[tuple, _PrefixEntry] = {}
        # parent key -> the single terminal partial-block entry
        self._partials: Dict[tuple, _PrefixEntry] = {}
        # parent key -> number of child entries (full blocks + partial);
        # only childless entries are evictable (an orphaned child would
        # be unreachable but still pin its page)
        self._children: Dict[tuple, int] = {}
        self._stamp = itertools.count()
        self._lock = threading.Lock()
        self.hits = 0
        self.hit_tokens = 0
        self.insertions = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries) + len(self._partials)

    # ------------------------------------------------------------------
    def _walk(self, tokens: Sequence[int]):
        """Longest cached chain for `tokens`: yields matched entries in
        order (full blocks, then at most one terminal partial).  Caller
        holds the lock."""
        ps = self.page_size
        parent = self._ROOT
        n = 0
        out = []
        while n + ps <= len(tokens):
            block = tuple(int(t) for t in tokens[n:n + ps])
            e = self._entries.get((parent, block))
            if e is None:
                break
            out.append(e)
            parent = e.key
            n += ps
        part = self._partials.get(parent)
        if part is not None and part.n_tokens <= len(tokens) - n and \
                tuple(int(t) for t in tokens[n:n + part.n_tokens]) \
                == part.tokens:
            out.append(part)
        return out

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens`: returns ``(pages,
        n_tokens)`` with one allocator reference added per returned page
        FOR THE CALLER (released through the normal `free` path when the
        sequence lets go).  ``([], 0)`` on miss."""
        with self._lock:
            matched = self._walk(tokens)
            if not matched:
                return [], 0
            pages = [e.page for e in matched]
            n = sum(e.n_tokens for e in matched)
            self.allocator.share(pages)
            for e in matched:
                e.stamp = next(self._stamp)
            self.hits += 1
            self.hit_tokens += n
        return pages, n

    def longest_match(self, tokens: Sequence[int]) -> int:
        """Tokens a `lookup` would attach — read-only (no references
        taken, no LRU refresh)."""
        with self._lock:
            return sum(e.n_tokens for e in self._walk(tokens))

    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register a just-prefilled prompt: ``pages[i]`` holds tokens
        ``[i*ps, (i+1)*ps)`` of `tokens` (the owning slot's page table
        prefix).  Creates entries for blocks not yet cached (one shared
        reference each); existing entries are LRU-refreshed, never
        replaced (first writer wins — both pages hold identical KV by
        construction).  Returns the number of NEW entries."""
        tokens = [int(t) for t in tokens]
        ps = self.page_size
        need = math.ceil(len(tokens) / ps) if tokens else 0
        if len(pages) < need:
            raise MXNetError(
                f"prefix insert: {len(tokens)} tokens span {need} pages "
                f"but only {len(pages)} supplied")
        created = 0
        with self._lock:
            parent = self._ROOT
            for bi in range(len(tokens) // ps):
                block = tuple(tokens[bi * ps:(bi + 1) * ps])
                key = (parent, block)
                e = self._entries.get(key)
                if e is None:
                    self.allocator.share([pages[bi]])
                    e = _PrefixEntry(key, pages[bi], block, ps, parent,
                                     next(self._stamp))
                    self._entries[key] = e
                    self._children[parent] = \
                        self._children.get(parent, 0) + 1
                    self.insertions += 1
                    created += 1
                else:
                    e.stamp = next(self._stamp)
                parent = key
            r = len(tokens) % ps
            if r:
                blk = tuple(tokens[-r:])
                part = self._partials.get(parent)
                if part is not None and part.tokens == blk:
                    part.stamp = next(self._stamp)
                elif part is None or (len(part.tokens) < r
                                      and blk[:len(part.tokens)]
                                      == part.tokens):
                    # no partial yet, or the new one strictly extends it
                    if part is not None:
                        self._drop(part)
                    self.allocator.share([pages[len(tokens) // ps]])
                    self._partials[parent] = _PrefixEntry(
                        ("partial", parent), pages[len(tokens) // ps],
                        blk, r, parent, next(self._stamp))
                    self._children[parent] = \
                        self._children.get(parent, 0) + 1
                    self.insertions += 1
                    created += 1
        return created

    # ------------------------------------------------------------------
    def _drop(self, e: _PrefixEntry) -> None:
        """Remove one entry and release its page reference (lock held)."""
        if e.key[0] == "partial":
            self._partials.pop(e.parent, None)
        else:
            self._entries.pop(e.key, None)
        left = self._children.get(e.parent, 0) - 1
        if left > 0:
            self._children[e.parent] = left
        else:
            self._children.pop(e.parent, None)
        self.allocator.free([e.page])
        self.evictions += 1

    def evict_pages(self, n: int) -> int:
        """Pool pressure: reclaim up to `n` pages by dropping LRU
        childless entries whose page refcount is 1 (sole owner = this
        index).  A page a live sequence still shares is NEVER evicted.
        Returns pages actually freed."""
        freed = 0
        with self._lock:
            while freed < n:
                cands = [
                    e for e in list(self._entries.values())
                    + list(self._partials.values())
                    if self._children.get(e.key, 0) == 0
                    and self.allocator.refcount(e.page) == 1]
                if not cands:
                    break
                victim = min(cands, key=lambda e: e.stamp)
                self._drop(victim)
                freed += 1
        return freed

    def clear(self) -> int:
        """Drop every entry (engine teardown / tests); returns entries
        released.  Shared pages simply lose the index's reference."""
        with self._lock:
            all_e = list(self._entries.values()) \
                + list(self._partials.values())
            for e in all_e:
                self.allocator.free([e.page])
            self._entries.clear()
            self._partials.clear()
            self._children.clear()
            return len(all_e)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries) + len(self._partials),
                    "hits": self.hits, "hit_tokens": self.hit_tokens,
                    "insertions": self.insertions,
                    "evictions": self.evictions}


class KVPools:
    """Device-side paged K/V storage for every layer:

    - ``k`` / ``v``: (n_layers, num_pages, page_size, Hkv, D) of `dtype`;
    - ``k_scale`` / ``v_scale``: (n_layers, num_pages, page_size, Hkv)
      float32 for an int8 pool (one symmetric scale a stored vector), else
      None."""

    def __init__(self, n_layers: int, num_pages: int, page_size: int,
                 n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                 device: torch.device):
        shape = (n_layers, num_pages, page_size, n_kv_heads, head_dim)
        self.quantized = dtype == torch.int8
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
            self.v_scale = torch.zeros_like(self.k_scale)
        self.n_layers = n_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim

    def planes(self):
        """Every stored tensor: K, V, then the scale planes of an int8
        pool (what a page copy must move)."""
        return tuple(t for t in (self.k, self.v, self.k_scale, self.v_scale)
                     if t is not None)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.planes())


def make_paged_kv_fn(pools: KVPools, page_tables, start_pos, num_tokens,
                     ctx_lens, window=None, attend=ragged_paged_attention):
    """Build the `kv_fn` `transformer_step` calls per layer: write the
    chunk's new K/V into the paged pool in place (``index_copy_`` into a
    flat per-layer view; an int8 pool quantizes each row with
    `quantize_kv` and writes the row and its scale through the same index,
    as the JAX package does outside its kernel), then attend over each
    slot's pages with `attend` (`ragged_paged_attention`; the plain
    `paged_attention_reference` for an oracle run), given the scale planes
    of an int8 pool.

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
        for pool, sp, new in ((pools.k, pools.k_scale, k_new),
                              (pools.v, pools.v_scale, v_new)):
            # (B, Hkv, C, D) -> per-token rows (B*C, Hkv, D)
            rows = new.transpose(1, 2).reshape(B * C, Hkv, D)
            if sp is not None:
                rows, scales = quantize_kv(rows)
                sp[li].view(-1, Hkv).index_copy_(0, idx, scales)
            pool[li].view(-1, Hkv, D).index_copy_(0, idx,
                                                  rows.to(pool.dtype))
        if pools.quantized:
            return attend(q.contiguous(), pools.k[li], pools.v[li],
                          page_tables, ctx_lens, start_pos, window=window,
                          k_scales=pools.k_scale[li],
                          v_scales=pools.v_scale[li])
        return attend(q.contiguous(), pools.k[li], pools.v[li], page_tables,
                      ctx_lens, start_pos, window=window)

    return kv_fn
