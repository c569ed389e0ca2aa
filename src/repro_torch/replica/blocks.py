# Copy of src/repro/replica/blocks.py (no import of the JAX package).
"""Paged-KV block allocator (vLLM-style): a fixed pool of page ids with a
free list; pages are reference-counted so the radix prefix cache can share
pages between sequences with a common prefix.

Shared by both replica backends: the JAX paged engine allocates real KV
pages from it, the simulator's analytic backend runs it at page_size=1 so
"pages" are tokens — one accounting path for both.
"""
from __future__ import annotations


class BlockAllocator:
    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))   # pop() -> ascending ids
        self._refs = [0] * n_pages

    # ---- queries -----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    # ---- alloc / ref / free -------------------------------------------
    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"need {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, page: int) -> None:
        assert self._refs[page] > 0, f"incref on free page {page}"
        self._refs[page] += 1

    def decref(self, page: int) -> None:
        assert self._refs[page] > 0, f"decref on free page {page}"
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)

    def free_all(self, pages: list[int]) -> None:
        for p in pages:
            self.decref(p)
