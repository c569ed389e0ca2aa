# Copy of src/repro/tenancy/discipline.py (no import of the JAX package).
"""Replica queue disciplines: who gets the next admission slot.

`ReplicaCore.begin_step` asks the discipline which PENDING sequence to try
next; FCFS always answers "the head", which preserves today's decision
streams byte-for-byte. The Virtual Token Counter (VTC) disciplines answer
"the earliest request of the least-served tenant": every tenant carries a
monotone service counter charged for the tokens actually served on its
behalf — uncached prefill at full price, cache hits at `cache_discount`
(locality still pays, but a tenant cannot weaponize shared prefixes into
priority), one unit per decoded token — and admission goes to the lowest
counter first, FCFS within a tenant.

Charges are never refunded: a cancelled or deadline-aborted request keeps
whatever it was already charged (work the replica really did) and is
charged nothing further. Counters therefore only move forward, which is
what makes the scheme starvation-free.

The lift rule: a tenant going from idle to active re-enters at
`max(own counter, min over currently-active tenants)` — an idle tenant
does not bank credit while others are served, and a brand-new tenant does
not get to lap everyone from zero. Activity is tracked by live rid, so
every exit path (finish, reject, cancel, shed) retires a request with one
idempotent `on_leave(rid)`.

Everything here is a pure function of calls made by the core — no clocks,
no randomness — so the cost-model and JAX backends replay identical
admission orders and the `("admit_fair", rid, tenant)` decision records
stay parity-testable exactly like the base stream.
"""
from __future__ import annotations

from typing import Dict, Protocol, Sequence, Set, runtime_checkable


def tenant_of(req) -> str:
    """A request's tenant is its `user_id` (anonymous traffic pools)."""
    return getattr(req, "user_id", "") or "_anon"


def tenant_weight_of(req) -> float:
    """Per-tenant weight (>= epsilon); malformed/absent weights mean 1.0."""
    try:
        w = float(getattr(req, "tenant_weight", 1.0))
    except (TypeError, ValueError):
        return 1.0
    return w if w > 0.0 else 1.0


@runtime_checkable
class QueueDiscipline(Protocol):
    """The pluggable surface `ReplicaCore` schedules through.

    `select` returns the INDEX into `pending` to try admitting next (the
    core moves it to the head; the blocked-head memo keys on head identity,
    so a reorder naturally invalidates it). The remaining hooks are
    bookkeeping: `on_enqueue`/`on_leave` bracket a request's residence,
    `on_admit`/`on_tokens` charge service actually rendered.
    """

    name: str

    def select(self, pending: Sequence) -> int: ...

    def on_enqueue(self, tenant: str, rid: int, weight: float = 1.0) -> None: ...

    def on_admit(self, tenant: str, uncached: int, cached: int,
                 weight: float = 1.0) -> None: ...

    def on_tokens(self, tenant: str, n: int, weight: float = 1.0) -> None: ...

    def on_leave(self, rid: int) -> None: ...

    def counters(self) -> Dict[str, float]: ...


class FCFSDiscipline:
    """The default: head-of-line admission, no accounting. `ReplicaCore`
    with this discipline is byte-identical to the pre-tenancy core."""

    name = "fcfs"

    def select(self, pending: Sequence) -> int:
        return 0

    def on_enqueue(self, tenant: str, rid: int, weight: float = 1.0) -> None:
        pass

    def on_admit(self, tenant: str, uncached: int, cached: int,
                 weight: float = 1.0) -> None:
        pass

    def on_tokens(self, tenant: str, n: int, weight: float = 1.0) -> None:
        pass

    def on_leave(self, rid: int) -> None:
        pass

    def counters(self) -> Dict[str, float]:
        return {}


class VTCDiscipline:
    """Virtual Token Counter fair queueing (unweighted)."""

    name = "vtc"
    uses_weights = False

    def __init__(self, cache_discount: float = 0.25):
        self.cache_discount = float(cache_discount)
        self._counters: Dict[str, float] = {}
        self._active: Dict[str, Set[int]] = {}   # tenant -> live rids
        self._owner: Dict[int, str] = {}         # rid -> tenant

    # ------------------------------------------------------------ internals
    def _floor(self) -> float:
        """Min counter over currently-active tenants (0.0 when none)."""
        live = [self._counters[t] for t, rids in self._active.items() if rids]
        return min(live) if live else 0.0

    def _charge(self, tenant: str, amount: float, weight: float) -> None:
        if tenant not in self._counters:
            self._counters[tenant] = self._floor()
        w = weight if self.uses_weights else 1.0
        self._counters[tenant] += amount / w

    # ------------------------------------------------------------ protocol
    def select(self, pending: Sequence) -> int:
        best, best_c = 0, None
        for i, seq in enumerate(pending):
            c = self._counters.get(tenant_of(seq.req), self._floor())
            if best_c is None or c < best_c:   # strict < : FCFS within ties
                best, best_c = i, c
        return best

    def on_enqueue(self, tenant: str, rid: int, weight: float = 1.0) -> None:
        if not self._active.get(tenant):       # idle (or new) -> active: lift
            self._counters[tenant] = max(
                self._counters.get(tenant, 0.0), self._floor())
        self._active.setdefault(tenant, set()).add(rid)
        self._owner[rid] = tenant

    def on_admit(self, tenant: str, uncached: int, cached: int,
                 weight: float = 1.0) -> None:
        self._charge(tenant, uncached + self.cache_discount * cached, weight)

    def on_tokens(self, tenant: str, n: int, weight: float = 1.0) -> None:
        self._charge(tenant, float(n), weight)

    def on_leave(self, rid: int) -> None:
        tenant = self._owner.pop(rid, None)
        if tenant is not None:
            self._active.get(tenant, set()).discard(rid)

    def counters(self) -> Dict[str, float]:
        return dict(self._counters)


class WeightedVTCDiscipline(VTCDiscipline):
    """VTC with per-tenant weights: a weight-w tenant is charged 1/w per
    token, i.e. it is entitled to w shares of service."""

    name = "wvtc"
    uses_weights = True


def make_discipline(name: str, *, cache_discount: float = 0.25):
    """Factory keyed by `ReplicaCoreConfig.discipline`."""
    if name == "fcfs":
        return FCFSDiscipline()
    if name == "vtc":
        return VTCDiscipline(cache_discount=cache_discount)
    if name == "wvtc":
        return WeightedVTCDiscipline(cache_discount=cache_discount)
    raise ValueError(f"unknown queue discipline: {name!r}")
