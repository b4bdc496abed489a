"""Prefix cache: a radix tree over known tokens, at page granularity.

A copy of `automodel_tpu/serving/prefix_cache.py` (host-only integer
bookkeeping), kept here so the port imports nothing of the JAX package. The
disaggregation splice (`match_pages`) and the router's affinity probe
(`peek_match_tokens`) wait for the slices that port those tiers.

The layer between the page allocator (kv_pages.py) and the scheduler that
turns re-sent prefixes into page-table entries instead of prefill work.
Real multi-tenant traffic re-prefills identical tokens constantly — shared
system prompts, few-shot templates, agent loops re-sending their whole
history — and with a paged cache the fix is almost free: the page table
already drives the attention gather (RPA-style indirection,
arXiv:2604.15464), so pointing a new request's table at pages some earlier
request filled makes cross-request KV sharing invisible to the jitted step.
Nothing device-side changes shape; compile-once survives untouched.

Structure: a radix tree keyed on token IDs in `page_size`-token chunks.
Each non-root node owns one immutable full pool page (its KV rows) plus the
exact token chunk that produced it. Requests donate pages as they complete
full pages (so even concurrent requests share) and when they finish, are
preempted, or expire. The tree holds one allocator reference per cached
page (`PageAllocator.incref`), which makes eviction ordering trivial:

- a cached page also referenced by a running slot is pinned (evicting its
  tree entry would free nothing);
- a cached-but-unreferenced page (refcount == 1, the tree's own) is
  RECLAIMABLE — `reclaim()` evicts such leaves in LRU (or FIFO) order and
  the page returns to the free list. The allocator only asks once its free
  list runs dry, so cached pages are ordered strictly BEHIND free pages
  and admission-by-free-pages / preempt-and-requeue keep working.

`lookup()` walks the tree for a request's known tokens: every fully
matching chunk contributes its page directly to the new slot's table, and
(optionally, `share_partial`) the last divergent chunk is matched by
longest common prefix — the slot adopts that page too and copy-on-writes
it before its first append (`PageAllocator.cow` + a one-page device copy
in the step). The match is capped one token short of the known sequence so
a full hit still feeds its last token — producing the logits to sample
from — which makes a full hit exactly one decode-class row: prefill is
skipped entirely.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from automodel_tpu_torch.serving.kv_pages import PageAllocator


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Typed config for the `serving.prefix_cache` section."""

    enabled: bool = False
    #: cap on cached pages (tree nodes); None → bounded only by the pool
    max_pages: Optional[int] = None
    #: reclaim order for cached-but-unreferenced pages: "lru" | "fifo"
    eviction: str = "lru"
    #: adopt a partially-matching page (divergence mid-page) via copy-on-write
    share_partial: bool = True

    def __post_init__(self):
        if self.eviction not in ("lru", "fifo"):
            raise ValueError(f"unknown eviction policy {self.eviction!r}")
        if self.max_pages is not None and self.max_pages < 1:
            raise ValueError("max_pages must be >= 1 (or None)")


@dataclasses.dataclass
class PrefixMatch:
    """One lookup result: pages to adopt into the slot's table prefix."""

    pages: list            # pool pages, table[0:len(pages)]
    fed: int               # known tokens whose KV the adopted pages provide
    matched_tokens: int    # uncapped radix match length (stats)
    cow_pending: bool      # first write lands inside an adopted page


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_used", "created")

    def __init__(self, key, page, parent, clock):
        self.key = key          # the page_size-token chunk (tuple), None=root
        self.page = page        # pool page holding this chunk's KV (-1=root)
        self.parent = parent
        self.children = {}      # chunk tuple → _Node
        self.last_used = clock
        self.created = clock


class PrefixCache:
    """Radix tree over known tokens at page granularity, pinned into a
    refcounted PageAllocator. Host-side only — integer bookkeeping."""

    def __init__(self, alloc: PageAllocator, page_size: int,
                 cfg: PrefixCacheConfig):
        self.alloc = alloc
        self.page_size = page_size
        self.cfg = cfg
        self._clock = 0
        self.root = _Node(None, -1, None, 0)
        self._nodes = 0
        # counters (engine stats surface them)
        self.n_inserted = 0
        self.n_evicted = 0
        alloc.register_remap_listener(self._remap)

    # -- bookkeeping ---------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _remap(self, mapping: dict) -> None:
        """Defrag renumbered pages — follow (kv_pages.defrag_plan)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                node.page = mapping.get(node.page, node.page)
            stack.extend(node.children.values())

    # -- lookup --------------------------------------------------------------
    def lookup(self, tokens: list) -> PrefixMatch:
        """Longest cached prefix of `tokens`, as adoptable pages. Full
        chunks match exactly; optionally the next chunk matches by longest
        common prefix (mid-page divergence → the caller copy-on-writes).
        Capped at len(tokens) - 1 so at least one token is always fed."""
        ps = self.page_size
        t = self._tick()
        node = self.root
        pages: list = []
        i = 0
        while i + ps <= len(tokens):
            child = node.children.get(tuple(tokens[i : i + ps]))
            if child is None:
                break
            node = child
            node.last_used = t
            pages.append(node.page)
            i += ps
        matched = i
        if self.cfg.share_partial and i < len(tokens) and node.children:
            rest = tuple(tokens[i : i + ps])
            best, best_node = 0, None
            for key, child in node.children.items():
                lcp = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    lcp += 1
                if lcp > best:
                    best, best_node = lcp, child
            if best_node is not None:
                best_node.last_used = t
                pages.append(best_node.page)
                matched += best
        fed = min(matched, len(tokens) - 1)
        while pages and fed <= (len(pages) - 1) * ps:
            pages.pop()  # page entirely past the capped feed start: useless
        return PrefixMatch(
            pages=pages,
            fed=fed if pages else 0,
            matched_tokens=matched if pages else 0,
            cow_pending=bool(pages) and fed < len(pages) * ps,
        )

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens: list, pages: list) -> int:
        """Donate `pages` (full pages backing `tokens`, page-aligned) into
        the tree; each NEW node pins its page with an allocator reference.
        An existing node for the same chunk wins (first writer keeps the
        canonical page — the donor still owns its copy). Returns pages newly
        cached."""
        ps = self.page_size
        t = self._tick()
        node = self.root
        added = 0
        for j in range(min(len(tokens) // ps, len(pages))):
            key = tuple(tokens[j * ps : (j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                if (
                    self.cfg.max_pages is not None
                    and self._nodes >= self.cfg.max_pages
                    and self._evict_one(protect_tick=t) == 0
                ):
                    break  # at capacity and nothing evictable: stop here
                child = _Node(key, pages[j], node, t)
                self.alloc.incref(pages[j])
                node.children[key] = child
                self._nodes += 1
                self.n_inserted += 1
                added += 1
            child.last_used = t
            node = child
        return added

    # -- eviction ------------------------------------------------------------
    def _evictable_leaves(self, protect_tick=None):
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (
                node is not self.root
                and not node.children
                and self.alloc.refcount(node.page) == 1
                and (protect_tick is None or node.last_used != protect_tick)
            ):
                out.append(node)
        return out

    def _order_key(self, node):
        return node.last_used if self.cfg.eviction == "lru" else node.created

    def _evict_node(self, victim) -> None:
        del victim.parent.children[victim.key]
        self.alloc.decref(victim.page)  # last ref → back on the free list
        self._nodes -= 1
        self.n_evicted += 1

    def _evict_one(self, protect_tick=None) -> int:
        leaves = self._evictable_leaves(protect_tick)
        if not leaves:
            return 0
        self._evict_node(min(leaves, key=self._order_key))
        return 1

    def reclaim(self, n: int) -> int:
        """Free up to `n` cached-but-unreferenced pages, coldest first.
        Victims are collected once per sweep (evicting a leaf never makes
        another collected leaf ineligible) and the tree is re-walked only
        when a sweep exposes newly leaf-like parents — O(tree + n log n),
        not O(n · tree). This is the allocator's reclaim hook — called only
        once the free list is short."""
        freed = 0
        while freed < n:
            leaves = sorted(self._evictable_leaves(), key=self._order_key)
            if not leaves:
                break
            for victim in leaves:
                if freed >= n:
                    break
                self._evict_node(victim)
                freed += 1
        return freed

    def reset(self) -> int:
        """Evict EVERY cached node (the engine-lifetime cache's explicit
        reset): each node drops its allocator reference, so pages held by
        nobody else return to the free list while pages still listed in a
        running slot's table merely lose their tree pin. Returns the number
        of nodes evicted."""
        freed = 0

        def walk(node):
            nonlocal freed
            for child in node.children.values():
                walk(child)
            if node is not self.root:
                self.alloc.decref(node.page)
                freed += 1

        walk(self.root)
        self.root.children = {}
        self._nodes = 0
        self.n_evicted += freed
        return freed

    def reclaimable(self) -> int:
        """Pages the tree could eventually return to the free list: nodes
        whose entire subtree (self included) is referenced by nobody but the
        tree. Admission counts these behind `num_free`."""
        count = 0

        def walk(node) -> bool:  # → subtree holds a pinned page
            held = False
            for child in node.children.values():
                held |= walk(child)
            if node is self.root:
                return held
            if self.alloc.refcount(node.page) > 1:
                return True
            if not held:
                nonlocal count
                count += 1
            return held

        walk(self.root)
        return count
