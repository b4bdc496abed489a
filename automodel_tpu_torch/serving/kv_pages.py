"""Paged KV cache: a global page pool + per-request page tables (port of
`automodel_tpu/serving/kv_pages.py`: GQA and MLA pools, fp or int8).

The sequence dimension is cut into fixed-size pages living in one global
pool shared by every request, and each request holds a PAGE TABLE — the
dense-prefix list of pool pages backing its sequence. Token at position p of
a request lives at `(table[p // page_size], p % page_size)`. Admission,
growth and preemption are integer page accounting on the host
(`PageAllocator`), while the device tensors keep one fixed shape.

Device layout (L = layers of a stack, N = `num_pages`, ps = `page_size`):
GQA k/v (L, N+1, ps, Hkv, D); MLA latent c (L, N+1, ps, r) and rope kr
(L, N+1, ps, dr). With kv_cache_dtype="int8" the payloads are int8 and two
(L, N+1, ps) fp32 scale planes ride beside them. Page index N is the TRASH
page that pad token rows write into and padded page-table entries point at,
keeping every gather and scatter in bounds without branching.

Pages are REFCOUNTED (prefix sharing, serving/prefix_cache.py): a page may
appear in many slots' tables and be pinned by the radix tree. `cow` gives a
slot a private copy before it appends into a shared page; `defrag_plan`
compacts live pages to a dense prefix and `apply_defrag` moves them.
"""

from __future__ import annotations

import dataclasses

import torch


def pages_for(num_tokens: int, page_size: int) -> int:
    """Pages needed to hold `num_tokens` sequence positions."""
    return -(-num_tokens // page_size)


@dataclasses.dataclass
class PageAllocator:
    """Free-list page accounting + per-slot dense-prefix page tables."""

    num_pages: int
    page_size: int

    def __post_init__(self):
        # LIFO free list: recently freed (still-warm) pages are reused first
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        self._tables: dict[int, list[int]] = {}
        # page → reference count; absent == 0 == on the free list. A page is
        # referenced once per table that lists it plus once if the prefix
        # cache's radix tree pins it (incref/decref).
        self._refs: dict[int, int] = {}
        self._remap_listeners: list = []

    @property
    def num_free(self) -> int:
        return len(self._free)

    def table(self, slot: int) -> list[int]:
        return self._tables.get(slot, [])

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def incref(self, page: int) -> None:
        """Take an extra reference on an allocated page."""
        if page not in self._refs:
            raise ValueError(f"incref of free page {page}")
        self._refs[page] += 1

    def decref(self, page: int) -> None:
        """Drop one reference; the last drop returns the page to the free
        list (LIFO, so the still-warm page is reused first)."""
        r = self._refs[page] - 1
        if r == 0:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = r

    def _alloc_page(self) -> int:
        p = self._free.pop()
        self._refs[p] = 1
        return p

    def ensure(self, slot: int, num_tokens: int, reclaim=None) -> bool:
        """Grow `slot`'s table to cover `num_tokens` positions. Returns False
        (allocating nothing) when the pool cannot cover the growth.
        `reclaim(n)`, when given, is asked to free up to n more pages ONLY
        once the free list is short."""
        table = self._tables.setdefault(slot, [])
        need = pages_for(num_tokens, self.page_size) - len(table)
        if need <= 0:
            return True
        if need > len(self._free) and reclaim is not None:
            reclaim(need - len(self._free))
        if need > len(self._free):
            return False
        table.extend(self._alloc_page() for _ in range(need))
        return True

    def adopt(self, slot: int, pages: list[int]) -> None:
        """Map already-allocated (shared) pages into the dense prefix of a
        fresh slot's table, taking a reference on each."""
        table = self._tables.setdefault(slot, [])
        if table:
            raise ValueError(f"adopt into non-empty table of slot {slot}")
        for p in pages:
            self.incref(p)
        table.extend(pages)

    def cow(self, slot: int, index: int):
        """Copy-on-write: repoint `slot`'s table entry `index` (a page
        someone else still references) at a fresh page and drop the shared
        reference. Returns (src, dst) for the one-page device copy, or None
        when the page was exclusive."""
        table = self._tables[slot]
        old = table[index]
        if self._refs[old] <= 1:
            return None
        if not self._free:
            raise RuntimeError("cow needs a free page; reclaim/preempt first")
        new = self._alloc_page()
        table[index] = new
        self.decref(old)
        return old, new

    def free_slot(self, slot: int) -> None:
        for p in self._tables.pop(slot, []):
            self.decref(p)

    def register_remap_listener(self, fn) -> None:
        """`fn(mapping: dict[old_page, new_page])` is called whenever defrag
        renumbers pages."""
        self._remap_listeners.append(fn)

    def defrag_plan(self):
        """Compact live pages to a dense prefix. Rewrites the host tables in
        place and returns (src, n_live): `src` (num_pages,) int64 tensor
        where new page i is copied from old page src[i] — feed to
        `apply_defrag`. Returns None when already compact."""
        live = sorted(self._refs)
        if live == list(range(len(live))):
            return None
        mapping = {old: new for new, old in enumerate(live)}
        for table in self._tables.values():
            table[:] = [mapping[p] for p in table]
        self._refs = {mapping[p]: r for p, r in self._refs.items()}
        src = list(range(self.num_pages))
        for old, new in mapping.items():
            src[new] = old
        self._free = list(range(self.num_pages - 1, len(live) - 1, -1))
        for fn in self._remap_listeners:
            fn(mapping)
        return torch.tensor(src, dtype=torch.int64), len(live)


def apply_defrag(pool, src: torch.Tensor):
    """Apply a defrag plan to a pool (list of per-stack tensor tuples): one
    gather along the page axis (axis 1, after the layer axis) per tensor,
    scale planes included; the trash page stays put. Returns the new pool."""
    trash = pool[0][0].shape[1] - 1
    full = torch.cat([src, torch.tensor([trash])])
    return [tuple(a[:, full.to(a.device)] for a in stack) for stack in pool]


def _stack(shapes, cfg, num_layers, num_pages, page_size, device,
           kv_cache_dtype) -> tuple:
    """Zeroed payloads of `shapes` in cfg.dtype; with kv_cache_dtype="int8"
    int8 payloads plus two (L, N+1, ps) fp32 scale planes, one scalar per
    cache row with a page's rows contiguous, so every page-axis operation
    on the pool (COW copy, defrag gather) moves a page's scales with its
    payload. The planes start at 1.0 (identity dequant for rows never
    written)."""
    if kv_cache_dtype is None:
        return tuple(torch.zeros(sh, dtype=cfg.dtype, device=device)
                     for sh in shapes)
    if kv_cache_dtype != "int8":
        raise ValueError(f"kv_cache_dtype must be None or 'int8' (got {kv_cache_dtype!r})")
    planes = (num_layers, num_pages + 1, page_size)
    return (
        *(torch.zeros(sh, dtype=torch.int8, device=device) for sh in shapes),
        *(torch.ones(planes, dtype=torch.float32, device=device) for _ in shapes),
    )


def init_gqa_pool(cfg, num_layers: int, num_pages: int, page_size: int,
                  device, kv_cache_dtype: str | None = None) -> tuple:
    """(k, v) pool tensors (L, N+1, ps, Hkv, D) in cfg.dtype for one stack;
    kv_cache_dtype="int8" → (k, v, k_scale, v_scale): int8 payloads at the
    same shapes plus the (L, N+1, ps) scale planes."""
    shape = (num_layers, num_pages + 1, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return _stack((shape, shape), cfg, num_layers, num_pages, page_size,
                  device, kv_cache_dtype)


def init_mla_pool(cfg, num_layers: int, num_pages: int, page_size: int,
                  device, kv_cache_dtype: str | None = None) -> tuple:
    """(c, kr) pool tensors for one MLA stack (the absorbed latent cache):
    c (L, N+1, ps, r) and kr (L, N+1, ps, dr); kv_cache_dtype="int8" →
    (c, kr, c_scale, kr_scale)."""
    c_shape = (num_layers, num_pages + 1, page_size, cfg.mla_kv_lora_rank)
    kr_shape = (num_layers, num_pages + 1, page_size, cfg.mla_qk_rope_head_dim)
    return _stack((c_shape, kr_shape), cfg, num_layers, num_pages, page_size,
                  device, kv_cache_dtype)


def init_pool(cfg, stack_layers: list[int], num_pages: int, page_size: int,
              device, kv_cache_dtype: str | None = None) -> list:
    """Per-stack pool tuples: a dense decoder has one stack, an MoE decoder
    a dense prefix stack and the MoE stack. GQA or MLA by
    cfg.attention_type; 2 leaves (fp) or 4 (int8 payloads + scale planes)."""
    init = init_mla_pool if cfg.attention_type == "mla" else init_gqa_pool
    return [
        init(cfg, L, num_pages, page_size, device, kv_cache_dtype)
        for L in stack_layers
    ]
