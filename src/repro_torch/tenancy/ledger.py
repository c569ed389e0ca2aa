# Copy of src/repro/tenancy/ledger.py (no import of the JAX package).
"""Router-level per-tenant service counters.

The replica disciplines are exact (they charge tokens actually served);
the routing layer needs only a coarse, CONVERGENT view — enough to notice
that one tenant is consuming a region and stop letting its cache affinity
override regional fairness. So LBs charge the EXPECTED tokens of each
dispatch (prompt + output budget), publish their counters in heartbeats,
and merge peers' views element-wise-max: counters are monotone per
publisher, so max-merge is a CRDT join and every LB converges on the same
ledger regardless of gossip order or loss.

No refunds here either — a cancelled request's expected charge stands.
That errs on the side of under-serving heavy tenants, which is the safe
direction for an anti-starvation mechanism, and it keeps the merge
monotone (a refund would need tombstones to survive max-merge).
"""
from __future__ import annotations

from typing import Dict, Optional


class TenantLedger:
    """Monotone per-tenant counters with CRDT-style max-merge."""

    def __init__(self):
        self.counters: Dict[str, float] = {}

    def charge(self, tenant: str, amount: float, weight: float = 1.0) -> None:
        w = weight if weight and weight > 0.0 else 1.0
        self.counters[tenant] = self.counters.get(tenant, 0.0) + amount / w

    def merge(self, counters: Optional[Dict[str, float]]) -> None:
        """Fold a peer's published counters in (element-wise max)."""
        if not counters:
            return
        for tenant, c in counters.items():
            if c > self.counters.get(tenant, 0.0):
                self.counters[tenant] = float(c)

    def snapshot(self) -> Dict[str, float]:
        return dict(self.counters)

    def mean(self) -> float:
        if not self.counters:
            return 0.0
        return sum(self.counters.values()) / len(self.counters)

    def is_heavy(self, tenant: str, factor: float = 2.0) -> bool:
        """A tenant is heavy when its counter exceeds `factor` x the mean.
        Needs at least two tenants — a lone tenant is never 'heavy', it is
        just the workload."""
        if len(self.counters) < 2:
            return False
        return self.counters.get(tenant, 0.0) > factor * self.mean()
