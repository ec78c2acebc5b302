"""Host-side page-pool accounting for paged KV serving.

The port's numpy copy of ``repro/serving/paged_kv.py``; the parity tests
replay the same operations on both and compare the books.

The device side (repro_torch.models.attention / kernels.decode_attention) sees
only arrays: per-layer pools (num_pages, KV, page_size, hd) and int32
block tables.  This module owns the *allocation* story:

``PagePool``
    A REFCOUNTED free-list over physical page ids 1..num_pages-1.  Page 0
    is reserved as the null page — block-table padding, masked decode
    lanes and clamped overshoot writes all land there, so it is never
    handed out.  Pages are interchangeable (any page can back any logical
    position of any sequence), which is what makes the pool
    fragmentation-free.  ``alloc`` hands out pages at refcount 1;
    ``retain`` lets a second holder (another sequence sharing a prompt
    prefix, or the prefix cache itself) pin the same physical page, and
    ``release``/``free`` decrement — a page returns to the free list only
    when its last holder lets go, so sharing can never free memory out
    from under a live sequence.

``BlockTable``
    Per-sequence logical->physical page mapping.  ``row(width)`` pads the
    mapped pages with null-page zeros up to a fixed width so every lane's
    table has the same shape under jit; reads past the mapped range are
    masked by length, and chunked-prefill overshoot writes clamp onto the
    null padding.  A table may be constructed over a prefix of SHARED
    pages (already retained for it by the caller) followed by freshly
    allocated private pages.

``PrefixCache``
    A content-addressed index over completed full prompt blocks (the
    vLLM-style automatic-prefix-caching map).  Keys are chained block
    hashes — ``key_b = H(key_{b-1} || tokens of block b)`` — so a lookup
    walks the new prompt's blocks and reuses every page whose entire
    token-chain-so-far matches a cached one.  Each entry holds ONE pool
    reference on its page; matching sequences take their own reference on
    top (copy-free sharing), and a lane that diverges *mid-block* forks
    the partially-matching cached page copy-on-write instead (the engine
    copies the page device-side and re-prefills only the divergent tail).
    Entries are evicted leaf-first in LRU order under pool pressure;
    eviction only drops the cache's reference — a page still referenced
    by a live lane survives until that lane releases it.

The engine reserves worst-case pages at admission
(``pages_needed(prompt + max_new_tokens)``): generation length is
deterministic here, so reservation is exact and admitted requests can
never deadlock waiting for pages mid-generation.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PagePool:
    """Refcounted free-list allocator over physical KV pages.

    ``num_pages`` counts the whole pool *including* the reserved null
    page 0, matching the leading axis of the device-side pool arrays.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page + null")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO: recently freed (cache-warm) pages are reused first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def total_refs(self) -> int:
        """Sum of refcounts over allocated pages — the engine's KV-leak
        accounting: when idle, every remaining reference must belong to
        the prefix cache (one per entry), so ``total_refs - cache.size``
        is the leak."""
        return sum(self._refs.values())

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def pages_needed(self, tokens: int) -> int:
        return cdiv(max(tokens, 0), self.page_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        """Add one reference per page (prefix sharing / cache pin)."""
        for p in pages:
            if p not in self._refs:
                raise RuntimeError(f"retain of unallocated page {p}")
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the free list
        only when its LAST holder releases it."""
        for p in pages:
            if p not in self._refs:
                raise RuntimeError(f"double free / foreign page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)

    # historical name (pre-refcount API); identical to one release
    free = release

    def reset(self) -> None:
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._refs.clear()


class BlockTable:
    """One sequence's logical->physical page list.

    ``shared`` pages (a matched prompt prefix) must already carry a
    reference taken for THIS table; the remainder is allocated fresh.
    ``release`` drops one reference on every page — shared pages whose
    other holders (the prefix cache, sibling lanes) remain stay resident.
    """

    def __init__(self, pool: PagePool, tokens: int,
                 shared: Sequence[int] = ()):
        self.pool = pool
        need = pool.pages_needed(tokens)
        shared = list(shared)
        if len(shared) > need:
            raise ValueError(
                f"{len(shared)} shared pages exceed the {need}-page "
                f"mapping for {tokens} tokens")
        self.pages: List[int] = shared + pool.alloc(need - len(shared))

    def row(self, width: int) -> List[int]:
        """Fixed-width table row, null-padded (page 0) past the mapping."""
        if len(self.pages) > width:
            raise ValueError(
                f"{len(self.pages)} pages do not fit a width-{width} row")
        return self.pages + [0] * (width - len(self.pages))

    def release(self) -> None:
        if self.pages:
            self.pool.release(self.pages)
            self.pages = []


# ---------------------------------------------------------------------------
# content-addressed prefix index
# ---------------------------------------------------------------------------

_ROOT = b"repro-prefix-root"


def _position_major(prompt) -> np.ndarray:
    """(1, S) tokens or (1, K, S) audio -> (S, F) with position leading,
    so a byte prefix of j rows is exactly the first j token positions."""
    arr = np.asarray(prompt)
    arr = np.moveaxis(arr, -1, 0)
    return np.ascontiguousarray(arr.reshape(arr.shape[0], -1))


def _block_key(parent: bytes, block: np.ndarray) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(block.tobytes())
    return h.digest()


def _common_positions(a: bytes, b: bytes, bpp: int) -> int:
    """Length (in positions) of the common prefix of two position-major
    byte strings; ``bpp`` bytes per position."""
    n = min(len(a), len(b)) // bpp
    j = 0
    while j < n and a[j * bpp:(j + 1) * bpp] == b[j * bpp:(j + 1) * bpp]:
        j += 1
    return j


@dataclasses.dataclass
class _Entry:
    page: int
    key: bytes
    parent: bytes
    tok: bytes        # the block's position-major token bytes (full block)


@dataclasses.dataclass
class PrefixMatch:
    """Result of matching a prompt against the cache (a peek — nothing is
    retained or LRU-bumped until :meth:`PrefixCache.acquire`)."""

    pages: List[int]                  # fully-matched block pages, in order
    keys: List[bytes]                 # their chain keys
    cow_page: Optional[int] = None    # cached page to fork copy-on-write
    cow_key: Optional[bytes] = None
    cow_tokens: int = 0               # matched positions inside that block

    @property
    def tokens(self) -> int:
        """Total reusable prompt tokens (full blocks + partial fork)."""
        return len(self.pages) * self._page_size + self.cow_tokens

    _page_size: int = 0


class PrefixCache:
    """LRU map from token-block chains to resident KV pages.

    Each entry pins its page with one pool reference, so completed
    prompts stay resident after their request finishes; under pool
    pressure :meth:`ensure_free` evicts LEAF entries (no cached children
    — evicting mid-chain would strand descendants) in LRU order.
    Eviction drops only the cache's reference: a page still shared with
    a live lane is never freed by eviction.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._children: Dict[bytes, Set[bytes]] = {}
        self.evictions = 0
        self.insertions = 0

    @property
    def size(self) -> int:
        return len(self._entries)

    # -- lookup --------------------------------------------------------
    def match(self, prompt, max_tokens: Optional[int] = None) -> PrefixMatch:
        """Longest cached chain matching the prompt (pure peek).

        Walks full blocks while the chained hash hits; then scans the
        last matched node's cached children for the longest in-block
        token prefix — the copy-on-write fork point for a lane that
        diverges mid-block.  ``max_tokens`` caps the usable match (the
        engine passes ``prompt_len - 1`` so at least one position is
        always re-prefilled to produce next-token logits).
        """
        arr = _position_major(prompt)
        S = arr.shape[0]
        bpp = arr.shape[1] * arr.dtype.itemsize
        ps = self.pool.page_size
        limit = S if max_tokens is None else max(min(S, int(max_tokens)), 0)

        parent = _ROOT
        pages: List[int] = []
        keys: List[bytes] = []
        b = 0
        while (b + 1) * ps <= limit:
            key = _block_key(parent, arr[b * ps:(b + 1) * ps])
            e = self._entries.get(key)
            if e is None:
                break
            pages.append(e.page)
            keys.append(key)
            parent = key
            b += 1
        m = PrefixMatch(pages=pages, keys=keys, _page_size=ps)

        rem = limit - b * ps
        if rem > 0:
            tail = np.ascontiguousarray(arr[b * ps:min((b + 1) * ps, S)]
                                        ).tobytes()
            best_j, best = 0, None
            for ck in self._children.get(parent, ()):
                e = self._entries[ck]
                j = min(_common_positions(e.tok, tail, bpp), rem)
                if j > best_j:
                    best_j, best = j, e
            if best is not None:
                m.cow_page, m.cow_key, m.cow_tokens = (best.page, best.key,
                                                       best_j)
        return m

    def acquire(self, m: PrefixMatch) -> None:
        """Commit a match: retain every matched page (including the COW
        source — the engine releases it after forking) and bump LRU."""
        for k in m.keys:
            if k in self._entries:
                self._entries.move_to_end(k)
        if m.cow_key is not None and m.cow_key in self._entries:
            self._entries.move_to_end(m.cow_key)
        self.pool.retain(m.pages)
        if m.cow_page is not None:
            self.pool.retain([m.cow_page])

    def release_match(self, m: PrefixMatch) -> None:
        """Undo :meth:`acquire` for an admission that did not go through."""
        self.pool.release(m.pages)
        if m.cow_page is not None:
            self.pool.release([m.cow_page])

    # -- insertion -----------------------------------------------------
    def insert(self, prompt, pages: Sequence[int]) -> int:
        """Cache every FULL prompt block of a lane that finished
        prefilling; returns the number of new entries.  Existing keys are
        LRU-bumped and keep their original page (the lane's duplicate
        page, if it prefilled one privately, stays private and is freed
        with the lane).  The cache takes one reference per new entry, so
        cached pages outlive the inserting request.
        """
        arr = _position_major(prompt)
        ps = self.pool.page_size
        parent = _ROOT
        added = 0
        for b in range(arr.shape[0] // ps):
            blk = np.ascontiguousarray(arr[b * ps:(b + 1) * ps])
            key = _block_key(parent, blk)
            if key in self._entries:
                self._entries.move_to_end(key)
            else:
                page = pages[b]
                self.pool.retain([page])
                self._entries[key] = _Entry(page=page, key=key,
                                            parent=parent, tok=blk.tobytes())
                self._children.setdefault(parent, set()).add(key)
                added += 1
                self.insertions += 1
            parent = key
        return added

    # -- eviction ------------------------------------------------------
    def _evict_one(self) -> bool:
        """Evict the LRU LEAF entry; returns False when nothing is
        evictable.  Only the cache's reference is dropped — a page a live
        lane still shares survives until that lane releases it."""
        for key in self._entries:                 # OrderedDict = LRU order
            if self._children.get(key):
                continue                          # mid-chain: keep
            e = self._entries.pop(key)
            sibs = self._children.get(e.parent)
            if sibs is not None:
                sibs.discard(key)
                if not sibs:
                    del self._children[e.parent]
            self.pool.release([e.page])
            self.evictions += 1
            return True
        return False

    def ensure_free(self, n: int) -> bool:
        """Evict cached leaves until the pool can allocate ``n`` pages;
        False when the cache runs out of evictable entries first."""
        while self.pool.num_free < n:
            if not self._evict_one():
                return False
        return True

    def clear(self) -> None:
        """Release every cached page (reset path)."""
        for e in self._entries.values():
            self.pool.release([e.page])
        self._entries.clear()
        self._children.clear()


def paged_supported(cfg) -> bool:
    """Whether a config can be served from a shared page pool.

    Requires every block to be attention with a model-dtype cache, and
    at least one of them full (unwindowed): the pool keeps every position
    for those anyway, and windowed layers beside them read their window
    of it.  Recurrent mixers, int8 caches and configs whose every layer
    is windowed (a ring of the window per slot is smaller) keep the dense
    per-slot path.
    """
    if cfg.kv_cache_dtype == "int8":
        return False
    if getattr(cfg, "vision_patches", 0):
        return False
    blocks = cfg.layer_pattern()
    return (all(b.mixer == "attn" for b in blocks)
            and any(b.window is None for b in blocks))
