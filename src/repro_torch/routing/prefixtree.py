# Copy of src/repro/routing/prefixtree.py (no import of the JAX package).
"""Prefix tree with per-node target sets — SkyLB §3.2 (prefix-trie variant).

A logical trie over token sequences, augmented per node with the set of
load-balancing targets that have served the prefix root..node. Built
incrementally from routed requests; bounded by FIFO eviction of the earliest
inserted records (each record = one routed request's path). Lookup returns
the available target with the longest matching prefix, early-terminating on
the subset property: a child's target set is always a subset of its
parent's, so once no available target matches at a node, none can deeper.
"""
from __future__ import annotations

from collections import deque
from typing import Hashable, Iterable, Optional, Sequence


class _Node:
    __slots__ = ("children", "targets", "refcount")

    def __init__(self):
        self.children: dict = {}
        self.targets: dict[Hashable, int] = {}   # target -> marking count
        self.refcount = 0


class PrefixTree:
    def __init__(self, max_tokens: int = 500_000):
        self.root = _Node()
        self.max_tokens = max_tokens
        self.total_tokens = 0
        self._records: deque[tuple[tuple, Hashable]] = deque()

    # ---------------------------------------------------------- insert

    def insert(self, tokens: Sequence, target: Hashable) -> None:
        tokens = tuple(tokens)
        if not tokens:
            return
        node = self.root
        for t in tokens:
            child = node.children.get(t)
            if child is None:
                child = _Node()
                node.children[t] = child
            child.refcount += 1
            child.targets[target] = child.targets.get(target, 0) + 1
            node = child
        self._records.append((tokens, target))
        self.total_tokens += len(tokens)
        self._evict()

    def _evict(self) -> None:
        while self.total_tokens > self.max_tokens and self._records:
            tokens, target = self._records.popleft()
            self.total_tokens -= len(tokens)
            path = [self.root]
            node = self.root
            for t in tokens:
                node = node.children[t]
                path.append(node)
            # unmark target + refcounts along the path, prune empty suffix
            for node in path[1:]:
                node.refcount -= 1
                c = node.targets.get(target)
                if c is not None:
                    if c <= 1:
                        del node.targets[target]
                    else:
                        node.targets[target] = c - 1
            for i in range(len(path) - 1, 0, -1):
                node = path[i]
                if node.refcount <= 0 and not node.children:
                    del path[i - 1].children[tokens[i - 1]]
                else:
                    break

    # ---------------------------------------------------------- lookup

    def match(self, tokens: Sequence,
              available: Optional[Iterable[Hashable]] = None
              ) -> tuple[int, Optional[Hashable]]:
        """Longest matching prefix among AVAILABLE targets.
        Returns (match_len, best_target). Early-terminates when the current
        node has no available target (subset property)."""
        avail = None if available is None else set(available)
        node = self.root
        depth = 0
        best: Optional[Hashable] = None
        best_depth = 0
        for t in tokens:
            child = node.children.get(t)
            if child is None:
                break
            cand = self._pick(child, avail)
            if cand is None:
                break                       # no available target deeper
            depth += 1
            best, best_depth = cand, depth
            node = child
        return best_depth, best

    @staticmethod
    def _pick(node: _Node, avail: Optional[set]) -> Optional[Hashable]:
        """Most-marked available target at a node (stable tie-break)."""
        best, best_count = None, -1
        for tgt, cnt in node.targets.items():
            if avail is not None and tgt not in avail:
                continue
            if cnt > best_count or (cnt == best_count and str(tgt) < str(best)):
                best, best_count = tgt, cnt
        return best

    # ---------------------------------------------------------- admin

    def remove_target(self, target: Hashable) -> None:
        """Drop every record of a target (replica/LB removed — elastic).
        Rebuilds from surviving records to keep refcounts/eviction exact."""
        survivors = [(tok, tgt) for tok, tgt in self._records if tgt != target]
        self.root = _Node()
        self._records = deque()
        self.total_tokens = 0
        for tok, tgt in survivors:
            self.insert(tok, tgt)

    def node_count(self) -> int:
        def cnt(node: _Node) -> int:
            return 1 + sum(cnt(c) for c in node.children.values())
        return cnt(self.root) - 1
