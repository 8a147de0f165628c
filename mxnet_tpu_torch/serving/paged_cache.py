"""Paged KV cache: ragged decode lengths sharing one preallocated pool.

Counterpart of ``mxnet_tpu/serving/paged_cache.py``.  Each decoder layer
keeps a fixed pool of ``(num_pages, page_size, heads, head_dim)`` K and V
blocks plus a per-slot **page table**; a request of any length owns just
the pages its tokens fill, and the decode step sees one static shape
however long each in-flight request has grown.  Freed pages return to
the pool the moment a request finishes.

Two layers live here:

  * tensor math (``page_coords`` / ``write_page`` / ``gather_pages`` /
    ``paged_attend``) and ``PagedStepCache``, one decode step's view of a
    layer's pools, whose attention is kernel K2
    (``ops.kernels.paged_decode_attention``: the CUDA kernel on the card,
    its plain version on the CPU);
  * ``PagedKVCache`` — the host-side allocator (free list, per-owner page
    ownership, per-page refcounts) and pool factory.  Page 0 is reserved
    as the trash page: empty slots' all-zero table rows route their
    discarded writes there, so inactive decode lanes never corrupt a live
    request's cache.

Unlike the JAX package, whose arrays are immutable, the pools here are
updated IN PLACE (``write_page``), which saves a copy of every pool per
step.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..models.transformer import _attend_cached
from ..ops.kernels import paged_decode_attention

__all__ = ["PagedKVCache", "PagedStepCache", "page_coords", "write_page",
           "gather_pages", "paged_attend", "pages_for", "torch_dtype"]

# the pool dtypes the engine serves with (kernel K2 reads each)
POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a pool, from its name (the JAX engine's
    ``dtype`` strings) or a torch dtype."""
    if isinstance(dtype, torch.dtype) and dtype in POOL_DTYPES.values():
        return dtype
    if dtype in POOL_DTYPES:
        return POOL_DTYPES[dtype]
    raise MXNetError(f"serving dtype {dtype!r}: expected one of "
                     f"{sorted(POOL_DTYPES)}")


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache rows."""
    return max(0, math.ceil(n_tokens / page_size))


# ---------------------------------------------------------------------------
# tensor math
# ---------------------------------------------------------------------------
def page_coords(table, pos, page_size: int):
    """Where slot ``s`` writes this step's k/v: ``pool[pages[s], rows[s]]``.

    table: (S, P) int32 page table; pos: (S,) per-slot position, or (1,)
    broadcasting one position.  Returns (pages, rows) int64.  A position
    past the table clamps to its last column, as the JAX package's gather
    does: an empty slot's position keeps counting, and its all-zero row
    sends it to the trash page."""
    S, P = table.shape
    pos = pos.long().expand(S)
    col = torch.clamp(pos // page_size, max=P - 1)
    pages = torch.gather(table.long(), 1, col[:, None])[:, 0]
    return pages, pos % page_size


def write_page(pool, pages, rows, vals) -> None:
    """Scatter one token's k (or v) per slot into the pool, IN PLACE
    (``index_put_``), cast to the pool's dtype as the JAX package's
    ``.at[].set`` casts.  pool: (N, page_size, H, hd); pages/rows: (S,);
    vals: (S, H, hd)."""
    pool.index_put_((pages, rows), vals.to(pool.dtype))


def gather_pages(pool, table):
    """Dense (S, P * page_size, H * hd) view of every slot's pages.  Rows
    beyond a slot's length hold stale or zero values; callers mask
    them."""
    S, P = table.shape
    N, ps, H, hd = pool.shape
    flat = pool.index_select(0, table.reshape(-1).long())
    return flat.reshape(S, P * ps, H * hd)


def paged_attend(q_t, k_pool, v_pool, table, keep, num_heads: int,
                 head_dim: int):
    """One-query attention over paged K/V by gather: the slots' pages
    into the dense layout, then ``models.transformer._attend_cached``
    (the JAX package's unfused path, kept as a cross-check of K2).
    q_t (S, 1, C); keep (S, P * page_size), 1 = attend."""
    K = gather_pages(k_pool, table)
    V = gather_pages(v_pool, table)
    return _attend_cached(q_t, K, V, keep, num_heads, head_dim)


class PagedStepCache:
    """One decode step's view of a single layer's paged K/V pools — the
    cache object ``TransformerDecoderCell.step`` writes and attends
    through.

    ``pages``/``rows`` (from :func:`page_coords`) and ``lengths`` ((S,)
    int32, rows valid including the one written this step) are computed
    once per step by the caller and shared across layers."""

    def __init__(self, k_pool, v_pool, table, pages, rows, lengths):
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.table = table
        self.pages = pages
        self.rows = rows
        self.lengths = lengths

    def update_and_attend(self, attn, q_t, k_t, v_t):
        """Write this step's k/v, then attend q over each slot's pages
        through K2.  q_t/k_t/v_t: (S, 1, C); returns (S, 1, C)."""
        H, hd = attn.num_heads, attn.head_dim
        S = q_t.shape[0]
        write_page(self.k_pool, self.pages, self.rows, k_t.reshape(S, H, hd))
        write_page(self.v_pool, self.pages, self.rows, v_t.reshape(S, H, hd))
        out = paged_decode_attention(q_t.reshape(S, H, hd).contiguous(),
                                     self.k_pool, self.v_pool, self.table,
                                     self.lengths)
        return out.reshape(S, 1, H * hd)


# ---------------------------------------------------------------------------
# pool + allocator
# ---------------------------------------------------------------------------
class PagedKVCache:
    """Fixed pool of KV pages per decoder layer + the host-side page
    allocator.

    ``pools`` is a list of (k_pool, v_pool) tensors of ``dtype``
    (float32, bfloat16 or float16; a torch dtype or its name) on
    ``device``; this object otherwise owns only the bookkeeping: which
    pages are free and which owner holds which pages.  Page 0 is reserved
    (the trash page inactive slots write to), so ``num_pages`` must leave
    room for it."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_heads: int, head_dim: int, device,
                 dtype=torch.float32):
        if num_pages < 2:
            raise MXNetError("PagedKVCache needs >= 2 pages (page 0 is "
                             "the reserved trash page)")
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = torch_dtype(dtype)
        shape = (self.num_pages, self.page_size, self.num_heads,
                 self.head_dim)
        self.pools = [(torch.zeros(shape, dtype=self.dtype, device=device),
                       torch.zeros(shape, dtype=self.dtype, device=device))
                      for _ in range(self.num_layers)]
        # LIFO free list: recently-freed (cache-warm) pages reused first
        self._free: List[int] = list(range(1, self.num_pages))
        self._owned: dict = {}
        self._refs: dict = {}  # page -> owner count (shared pages)
        self._notes: dict = {}  # owner -> observability metadata

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def annotate(self, owner, **attrs) -> None:
        """Attach metadata to ``owner`` (the engine stamps the request id
        at admission); cleared when the owner releases its pages."""
        if attrs:
            self._notes.setdefault(owner, {}).update(attrs)

    def annotation(self, owner) -> dict:
        """The metadata :meth:`annotate` attached (empty if none)."""
        return dict(self._notes.get(owner, ()))

    def owned(self, owner) -> List[int]:
        return list(self._owned.get(owner, ()))

    def refcount(self, page: int) -> int:
        """How many owners hold ``page`` (0 = free or never granted)."""
        return self._refs.get(int(page), 0)

    def alloc(self, owner, n_pages: int) -> Optional[List[int]]:
        """Grant ``n_pages`` more pages to ``owner``, all or nothing.
        Returns the new pages, or None when the pool cannot cover the
        request (never partial: a half-grown table would let a decode
        position land on the trash page)."""
        n_pages = int(n_pages)
        if n_pages <= 0:
            return []
        if n_pages > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n_pages)]
        self._owned.setdefault(owner, []).extend(got)
        for p in got:
            self._refs[p] = 1
        return got

    def adopt(self, owner, pages) -> None:
        """Add ``owner`` as a co-owner of already-granted ``pages``: each
        page's refcount rises by one, and it returns to the free list
        only when its last owner releases it.  Adopting a page nobody
        owns is a bookkeeping bug and raises."""
        pages = [int(p) for p in pages]
        for p in pages:
            if self._refs.get(p, 0) <= 0:
                raise MXNetError(
                    f"adopt: page {p} is not currently owned — a free "
                    "page cannot be shared (allocator bookkeeping bug)")
        self._owned.setdefault(owner, []).extend(pages)
        for p in pages:
            self._refs[p] += 1

    def free_slot(self, owner) -> int:
        """Release every page ``owner`` holds.  Pages whose refcount hits
        zero return to the pool; shared pages survive until their last
        owner lets go.  Returns how many pages came back."""
        pages = self._owned.pop(owner, [])
        self._notes.pop(owner, None)
        freed = 0
        for p in pages:
            left = self._refs.get(p, 1) - 1
            if left <= 0:
                self._refs.pop(p, None)
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = left
        return freed

    def capacity_rows(self, owner) -> int:
        """How many cache rows the owner's granted pages can hold."""
        return len(self._owned.get(owner, ())) * self.page_size

    def table_row(self, owner, max_pages: int) -> np.ndarray:
        """The owner's page-table row, zero-padded to ``max_pages``
        (numpy int32; callers copy it into the device table)."""
        pages = self._owned.get(owner, [])
        if len(pages) > max_pages:
            raise MXNetError(f"slot {owner} owns {len(pages)} pages > "
                             f"table width {max_pages}")
        row = np.zeros((max_pages,), np.int32)
        row[:len(pages)] = pages
        return row
