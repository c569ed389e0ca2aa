# Copy of src/repro/routing/hedging.py (no import of the JAX package).
"""Hedged dispatch policy: when to duplicate a `latency`-class request to
a second region (beyond-paper tail-TTFT insurance).

Like `repro.routing.kvtransfer`, this is a PURE decision module: the rule
reads only snapshot state the routing core already replicates (probe views,
prompt length, the request's deadline) — never clocks or transport
internals — so the simulator and the real-engine router reach identical
hedge/no-hedge verdicts from identical snapshots. The mechanics of racing
the two legs (first token wins, loser reaped through the exactly-once
cancel path) live in the transports.

The TTFT prediction is deliberately coarse — queueing + decode interference
+ uncached prefill from the same calibration the cost model uses — because
a hedge only needs to fire when the PRIMARY region is visibly saturated;
precision beyond "will clearly blow the budget" buys nothing and costs
duplicated work.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HedgeParams:
    ttft_budget_s: float = 0.25      # budget when the request has no deadline
    deadline_frac: float = 0.5       # hedge when pred TTFT > frac * deadline
    prefill_tps: float = 1700.0      # uncached prefill throughput
    queue_wait_s: float = 0.05       # wait per request already pending
    per_outstanding_s: float = 0.003  # decode interference per running seq


def predict_ttft(prompt_len: int, pending: int, outstanding: int,
                 params: HedgeParams) -> float:
    """Snapshot-only TTFT estimate at one replica: queueing behind its
    pending admissions, decode interference from its running batch, then
    the request's own (worst-case: uncached) prefill."""
    return (pending * params.queue_wait_s
            + outstanding * params.per_outstanding_s
            + prompt_len / params.prefill_tps)


def should_hedge(req, view, params: HedgeParams) -> bool:
    """Hedge iff the request is `latency`-class, arrived here directly
    (forwards/clones never re-hedge — one duplicate max), and the chosen
    replica's predicted TTFT exceeds the budget: `deadline_frac` of its
    deadline when it has one, else the flat `ttft_budget_s`."""
    if getattr(req, "slo_class", "standard") != "latency":
        return False
    if getattr(req, "forwarded", False):
        return False
    deadline = getattr(req, "deadline_s", None)
    budget = (deadline * params.deadline_frac if deadline is not None
              else params.ttft_budget_s)
    pred = predict_ttft(len(getattr(req, "prompt_tokens", ()) or ()),
                        view.pending, view.outstanding, params)
    return pred > budget
