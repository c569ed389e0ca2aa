# Copy of src/repro/replica/hostpool.py (no import of the JAX package).
"""Host-memory page pool: the second tier under `PagedRadix`.

Device pages evicted from the KV pool demote here instead of vanishing
(sglang-jax's `host_value` nodes are the precedent); a later prefix hit
promotes them back through an async device<->host copy path while the
sequence sits in a LOADING state. The pool is pure BOOKKEEPING — which host
page ids exist, who owns them, which are pinned by an in-flight load — so
both replica backends share it: the analytic `CostModelBackend` never
materializes bytes, while `JaxPagedBackend` keeps a numpy mirror indexed by
the same page ids.

Pins vs ownership: a page is OWNED by exactly one radix node (the owner
frees it on promotion or drop) and PINNED by each sequence whose load-back
copy is still conceptually in flight. A freed-while-pinned page only
returns to the free list when the last pin drops — the guard that a page
demoted to host while still referenced cannot be reused under it.
"""
from __future__ import annotations


class HostPool:
    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))   # pop() -> ascending ids
        self._owned = [False] * n_pages
        self._pins = [0] * n_pages

    # ---- queries -----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def pinned(self, page: int) -> int:
        return self._pins[page]

    def total_pins(self) -> int:
        return sum(self._pins)

    # ---- alloc / pin / free -------------------------------------------
    def alloc(self) -> int:
        """One host page, or -1 when the pool is full (the caller falls
        back to dropping the demotion candidate outright)."""
        if not self._free:
            return -1
        p = self._free.pop()
        self._owned[p] = True
        return p

    def pin(self, page: int) -> None:
        assert self._owned[page] or self._pins[page] > 0, \
            f"pin on free host page {page}"
        self._pins[page] += 1

    def unpin(self, page: int) -> None:
        assert self._pins[page] > 0, f"unpin on unpinned host page {page}"
        self._pins[page] -= 1
        if self._pins[page] == 0 and not self._owned[page]:
            self._free.append(page)      # orphaned while pinned: reuse now

    def free(self, page: int) -> None:
        """Owner releases the page (promotion completed, or the node was
        dropped). Reuse waits for the last pin: a loader that staged its
        copy at dispatch no longer needs the bytes, but an id must never be
        handed out twice while anyone still names it."""
        assert self._owned[page], f"free on unowned host page {page}"
        self._owned[page] = False
        if self._pins[page] == 0:
            self._free.append(page)
