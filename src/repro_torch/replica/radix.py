# Copy of src/repro/replica/radix.py (no import of the JAX package).
"""Unified page-granular radix prefix cache (SGLang-RadixAttention-style):
maps token-block prefixes to resident page ids so prefill can skip
recomputation — the mechanism whose locality SkyWalker's routing protects.

This is the ONE radix implementation behind both replica backends: the JAX
paged engine runs it at its KV page size; the simulator runs it at
page_size=1, which recovers token-level semantics (the old `SimRadix`).

Each node = one FULL page (page_size tokens), keyed by that page's token
tuple. Nodes hold the page id and a last-access stamp from a PER-INSTANCE
LRU clock (a module-global clock would make eviction stamps — and any test
comparing them — depend on unrelated caches created earlier in the same
process). Pages referenced by the tree carry one allocator ref, plus one
per sequence currently using them.

Two tiers (sglang-jax's `host_value` nodes are the precedent): a node is
DEVICE-resident (`page >= 0`) or HOST-resident (`page == -1`,
`host_page >= 0` in a `HostPool`). Eviction DEMOTES refcount-1 LRU device
leaves to the host tier (or drops them outright when no host pool is
configured, or when the host pool is full and holds nothing evictable —
the drop-instead-of-demote fallback); a later match reports the host
continuation so the scheduler can admit the sequence in a LOADING state
while pages stream back in. Invariant: on any root->node path the
device-resident nodes form a contiguous prefix (leaf-first demotion,
insert-time promotion-by-claim, and whole-chain load promotion all
preserve it), so "device leaf" is the local property `page >= 0` with no
device-resident child.

Device-leaf eviction order comes from a LAZY-DELETION HEAP keyed on the
LRU stamp: restamps and structural changes push fresh entries, pops
validate against the node's live stamp/registry, and refcount-pinned pops
are re-pushed after the sweep — O(log n) per eviction instead of the old
O(#leaves) scan, with byte-identical victim order (stamps are unique).
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional

from repro_torch.replica.blocks import BlockAllocator
from repro_torch.replica.hostpool import HostPool


class _Node:
    __slots__ = ("children", "page", "stamp", "parent", "key", "host_page")

    def __init__(self, parent: Optional["_Node"], key, page: int, stamp: int):
        self.children: dict[tuple, _Node] = {}
        self.page = page
        self.stamp = stamp
        self.parent = parent
        self.key = key
        self.host_page = -1


class PagedRadix:
    def __init__(self, allocator: BlockAllocator, page_size: int,
                 host_pages: int = 0):
        self.alloc = allocator
        self.page_size = page_size
        self._clock = itertools.count()          # per-instance (determinism)
        self.root = _Node(None, None, -1, next(self._clock))
        self.cached_pages = 0                    # device pages the tree owns
        self.host_cached_pages = 0               # host pages the tree owns
        self._leaves: dict[int, _Node] = {}      # DEVICE leaves: id(node) -> node
        self._host_leaves: dict[int, _Node] = {}  # host-only leaves
        # lazy-deletion eviction heap over device leaves: (stamp, node).
        # Stamps are unique per instance, so the node never gets compared;
        # an entry is live iff the node is still a registered device leaf
        # AND its stamp still equals the entry's (restamps invalidate).
        self._heap: list[tuple[int, _Node]] = []
        self.host: Optional[HostPool] = (
            HostPool(host_pages) if host_pages > 0 else None)
        # backend hook fired BEFORE a device page demotes (while its KV is
        # still intact): (device_page, host_page) -> None. The JAX backend
        # snapshots D2H here; the cost model counts copy bytes.
        self.on_demote: Optional[Callable[[int, int], None]] = None
        # bumped whenever tree CONTENT changes (insert/evict/clear) — lets a
        # scheduler skip re-matching a blocked head against an unchanged tree
        self.content_version = 0
        # tier stats
        self.demoted_pages = 0
        self.dropped_pages = 0
        self.promoted_pages = 0

    # ---------------------------------------------------------- lookup
    def match(self, tokens: tuple) -> tuple[int, list[int]]:
        """Longest full-page DEVICE-cached prefix. Returns (n_cached_tokens,
        page_ids). Does NOT take refs — call `take_refs` on admit."""
        node = self.root
        pages: list[int] = []
        ps = self.page_size
        for i in range(0, len(tokens) - ps + 1, ps):
            child = node.children.get(tuple(tokens[i:i + ps]))
            if child is None or child.page < 0:
                break
            self._restamp(child)
            pages.append(child.page)
            node = child
        return len(pages) * ps, pages

    def match_tiered(self, tokens: tuple) -> tuple[int, list[int], list]:
        """Two-tier match: the device prefix plus the HOST-resident chain
        continuing it. Returns (n_device_tokens, device_page_ids,
        host_nodes) — host_nodes in path order; each contributes one page
        of tokens once promoted. No refs or pins are taken here."""
        node = self.root
        pages: list[int] = []
        ps = self.page_size
        i = 0
        for i in range(0, len(tokens) - ps + 1, ps):
            child = node.children.get(tuple(tokens[i:i + ps]))
            if child is None or child.page < 0:
                break
            self._restamp(child)
            pages.append(child.page)
            node = child
        host_nodes: list[_Node] = []
        if self.host is not None:
            for j in range(len(pages) * ps, len(tokens) - ps + 1, ps):
                child = node.children.get(tuple(tokens[j:j + ps]))
                if child is None or child.page >= 0:
                    break
                child.stamp = next(self._clock)
                host_nodes.append(child)
                node = child
        return len(pages) * ps, pages, host_nodes

    def _restamp(self, node: _Node) -> None:
        node.stamp = next(self._clock)
        if id(node) in self._leaves:             # keep its heap entry fresh
            heapq.heappush(self._heap, (node.stamp, node))

    def take_refs(self, pages: list[int]) -> None:
        for p in pages:
            self.alloc.incref(p)

    def release_refs(self, pages: list[int]) -> None:
        for p in pages:
            self.alloc.decref(p)

    # ----------------------------------------------------- host pins
    def pin_host(self, host_pages: list[int]) -> None:
        """Pin host pages for a load in flight: they cannot be reused (or
        their ids recycled) until `unpin_host`, even if promotion or a drop
        releases ownership first."""
        for hp in host_pages:
            self.host.pin(hp)

    def unpin_host(self, host_pages: list[int]) -> None:
        for hp in host_pages:
            self.host.unpin(hp)

    # ---------------------------------------------------------- insert
    def insert(self, tokens: tuple, pages: list[int]) -> int:
        """Claim a finished sequence's FULL pages into the tree. Page ids in
        `pages` must line up with token blocks. For pages already present the
        caller's page is NOT claimed (dedup keeps the older copy) — except a
        HOST-resident block, which promotes by claiming the caller's device
        copy (the host page is released). Returns number of pages newly
        claimed (each gains one tree ref)."""
        node = self.root
        ps = self.page_size
        claimed = 0
        for bi, i in enumerate(range(0, len(tokens) - ps + 1, ps)):
            if bi >= len(pages):
                break
            key = tuple(tokens[i:i + ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(node, key, pages[bi], next(self._clock))
                if node is not self.root:
                    self._leaves.pop(id(node), None)  # node stops being a leaf
                node.children[key] = child
                self._register_device_leaf(child)
                self.alloc.incref(pages[bi])           # tree's own ref
                claimed += 1
                self.cached_pages += 1
            elif child.page < 0:
                # host-resident block re-prefilled by this sequence: claim
                # the fresh device copy, release the (now redundant) host one
                self._promote_node(child, pages[bi])
                claimed += 1
            else:
                self._restamp(child)
            node = child
        if claimed:
            self.content_version += 1
        return claimed

    def _register_device_leaf(self, node: _Node) -> None:
        """`node` just became device-resident with no device children."""
        self._leaves[id(node)] = node
        heapq.heappush(self._heap, (node.stamp, node))

    def _promote_node(self, node: _Node, dev_page: int) -> None:
        """Host -> device: the tree claims `dev_page` (one tree ref); the
        host copy is released (reuse deferred while pinned)."""
        self.alloc.incref(dev_page)
        node.page = dev_page
        self.host.free(node.host_page)
        node.host_page = -1
        node.stamp = next(self._clock)
        self.host_cached_pages -= 1
        self.cached_pages += 1
        self.promoted_pages += 1
        self._host_leaves.pop(id(node), None)
        parent = node.parent
        if parent is not self.root:
            self._leaves.pop(id(parent), None)  # parent gained a device child
        self._register_device_leaf(node)         # children (if any) are host

    def promote(self, node: _Node, dev_page: int) -> bool:
        """Load-back completion: promote `node` onto `dev_page` (the caller
        allocated it and streamed the host page's KV in). Returns False if
        the node was already promoted by a concurrent insert — the caller
        keeps its device copy privately; the tree keeps the older one."""
        if node.page >= 0 or node.parent is None:
            return False
        self._promote_node(node, dev_page)
        self.content_version += 1
        return True

    # ---------------------------------------------------------- evict
    def evict(self, n_pages: int, freed: Optional[list] = None) -> int:
        """Demote up to n_pages LRU device leaf pages whose only ref is the
        tree's (to the host tier when configured, else drop). Returns pages
        actually freed on device; page ids are appended to `freed` when
        given (parity tracing)."""
        done = 0
        skipped: list[tuple[int, _Node]] = []
        while done < n_pages and self._heap:
            stamp, node = heapq.heappop(self._heap)
            if (self._leaves.get(id(node)) is not node
                    or node.stamp != stamp):
                continue                          # stale entry
            if self.alloc.refcount(node.page) != 1:
                skipped.append((stamp, node))     # seq-pinned: not evictable
                continue
            page = node.page
            if not self._demote_leaf(node):
                skipped.append((stamp, node))     # pinned host subtree
                continue
            if freed is not None:
                freed.append(page)
            done += 1
        for entry in skipped:
            heapq.heappush(self._heap, entry)
        if done:
            self.content_version += 1
        return done

    def _demote_leaf(self, victim: _Node) -> bool:
        """Demote one device leaf to the host tier; falls back to dropping
        it (with its host subtree) when the host pool can't take it. False
        only when a pinned host descendant blocks the drop (in-flight load:
        the ancestors' KV must survive until the pin clears)."""
        if self.host is None:
            self._drop_device_leaf(victim)
            return True
        hp = self.host.alloc()
        if hp < 0:
            # host pressure: retire the LRU unpinned HOST leaf first — the
            # host tier is itself an LRU cache, not write-once
            if self._evict_host_leaf():
                hp = self.host.alloc()
        if hp < 0:
            # full of pinned/structural pages: drop instead of demote
            return self._drop_subtree(victim)
        if self.on_demote is not None:
            self.on_demote(victim.page, hp)       # snapshot KV D2H first
        self.alloc.decref(victim.page)
        victim.page = -1
        victim.host_page = hp
        self.cached_pages -= 1
        self.host_cached_pages += 1
        self.demoted_pages += 1
        del self._leaves[id(victim)]
        if not victim.children:
            self._host_leaves[id(victim)] = victim
        parent = victim.parent
        if parent is not self.root and self._is_device_leaf(parent):
            self._register_device_leaf(parent)
        return True

    def _is_device_leaf(self, node: _Node) -> bool:
        return (node.page >= 0
                and not any(c.page >= 0 for c in node.children.values()))

    def _drop_device_leaf(self, victim: _Node) -> None:
        """No host tier: the old evict-is-forget behaviour."""
        parent = victim.parent
        del parent.children[victim.key]
        del self._leaves[id(victim)]
        victim.parent = None
        if parent is not self.root and not parent.children:
            self._register_device_leaf(parent)
        self.alloc.decref(victim.page)
        self.cached_pages -= 1

    def _drop_subtree(self, victim: _Node) -> bool:
        """Drop a device leaf AND its host-resident descendants (the
        contiguous-device-prefix invariant forbids orphaning them). Refuses
        (returns False) when any descendant host page is pinned."""
        nodes = [victim]
        stack = list(victim.children.values())
        while stack:
            nd = stack.pop()
            nodes.append(nd)
            stack.extend(nd.children.values())
        if any(nd.host_page >= 0 and self.host.pinned(nd.host_page)
               for nd in nodes):
            return False
        parent = victim.parent
        del parent.children[victim.key]
        for nd in nodes:
            nd.parent = None
            if nd.page >= 0:
                self.alloc.decref(nd.page)
                self.cached_pages -= 1
                self._leaves.pop(id(nd), None)
            if nd.host_page >= 0:
                self.host.free(nd.host_page)
                nd.host_page = -1
                self.host_cached_pages -= 1
                self._host_leaves.pop(id(nd), None)
            self.dropped_pages += 1
        if parent is not self.root and not parent.children:
            self._register_device_leaf(parent)
        return True

    def _evict_host_leaf(self) -> bool:
        """Forget the LRU unpinned host-only leaf. Host leaves are few and
        off the admission hot path, so a linear scan is fine here."""
        best: Optional[_Node] = None
        for nd in self._host_leaves.values():
            if self.host.pinned(nd.host_page):
                continue
            if best is None or nd.stamp < best.stamp:
                best = nd
        if best is None:
            return False
        parent = best.parent
        del parent.children[best.key]
        del self._host_leaves[id(best)]
        best.parent = None
        self.host.free(best.host_page)
        best.host_page = -1
        self.host_cached_pages -= 1
        self.dropped_pages += 1
        if parent.page < 0 and parent is not self.root \
                and not parent.children and parent.host_page >= 0:
            self._host_leaves[id(parent)] = parent
        return True

    def evictable_pages(self) -> int:
        return sum(1 for nd in self._leaves.values()
                   if self.alloc.refcount(nd.page) == 1)

    def clear(self) -> None:
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd.page >= 0:
                self.alloc.decref(nd.page)
            if nd.host_page >= 0:
                self.host.free(nd.host_page)
        self.root = _Node(None, None, -1, next(self._clock))
        self.cached_pages = 0
        self.host_cached_pages = 0
        self._leaves = {}
        self._host_leaves = {}
        self._heap = []
        self.content_version += 1
