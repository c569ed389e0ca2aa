# Copy of src/repro/routing/hashring.py (no import of the JAX package).
"""Consistent hashing (ring hash with virtual nodes) — SkyLB-CH §3.2.

Two SkyLB extensions over classic ring hash (Karger et al. / Chord):
  1. applied at BOTH layers (LB->LB and LB->replica);
  2. virtual nodes whose target is unavailable are SKIPPED, continuing
     clockwise (Listing 1, line 26).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Hashable, Iterable, Optional


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, targets: Iterable[Hashable] = (), vnodes: int = 100):
        self.vnodes = vnodes
        self._ring: list[tuple[int, Hashable]] = []
        self._targets: set[Hashable] = set()
        for t in targets:
            self.add(t)

    def add(self, target: Hashable) -> None:
        if target in self._targets:
            return
        self._targets.add(target)
        for i in range(self.vnodes):
            bisect.insort(self._ring, (_hash(f"{target}#{i}"), target))

    def remove(self, target: Hashable) -> None:
        if target not in self._targets:
            return
        self._targets.discard(target)
        self._ring = [(h, t) for h, t in self._ring if t != target]

    @property
    def targets(self) -> set:
        return set(self._targets)

    def __len__(self) -> int:
        return len(self._targets)

    def lookup(self, key: str,
               available: Optional[set] = None) -> Optional[Hashable]:
        """First clockwise virtual node whose target is available."""
        if not self._ring:
            return None
        avail = self._targets if available is None else (self._targets & set(available))
        if not avail:
            return None
        h = _hash(key)
        idx = bisect.bisect_right(self._ring, (h, "￿"))
        n = len(self._ring)
        for off in range(n):
            _, target = self._ring[(idx + off) % n]
            if target in avail:
                return target
        return None
