# Copy of src/repro/routing/failover.py (no import of the JAX package).
"""Origin bookkeeping for controller-style LB failover (paper §4.2),
shared by the simulator's `Controller` and the engine path's
`InProcessRouter`.

The subtle part of failover is not moving targets off a dead LB — it is
unwinding CASCADES on recovery: if us dies (targets adopted by eu) and
then eu dies (everything moves on to asia), a recovering us must reclaim
its targets from asia, and a later-recovering eu must not claw them back.
`FailoverTracker` records each target's home LB at its first move and
answers "what does this LB reclaim" regardless of how many hops the
target made since.  Hosts keep deciding WHERE dead targets go and how
queued requests travel; the tracker only owns the ownership ledger.
"""
from __future__ import annotations

from typing import Iterable


class FailoverTracker:
    def __init__(self):
        # target id -> (home LB id, target object); first failover wins, so
        # adopted targets moving on in a cascade keep their original home
        self._origin: dict[str, tuple[str, object]] = {}
        self._failed_over: set[str] = set()

    def needs_failover(self, lb_id: str, alive: bool) -> bool:
        return not alive and lb_id not in self._failed_over

    def needs_restore(self, lb_id: str, alive: bool) -> bool:
        return alive and lb_id in self._failed_over

    def record_failover(self, lb_id: str,
                        targets: Iterable[tuple[str, object]]) -> None:
        """A dead LB's current targets are about to move off it."""
        for tid, obj in targets:
            self._origin.setdefault(tid, (lb_id, obj))
        self._failed_over.add(lb_id)

    def reclaimable(self, lb_id: str) -> list[tuple[str, object]]:
        """Targets whose HOME the recovering LB is, wherever they live now."""
        return [(tid, obj) for tid, (home, obj) in self._origin.items()
                if home == lb_id]

    def mark_restored(self, lb_id: str) -> None:
        self._failed_over.discard(lb_id)
