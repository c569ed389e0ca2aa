# Copy of src/repro/tenancy/admission.py (no import of the JAX package).
"""Deadline-aware admission control: shed what cannot possibly make it.

Reuses `repro.routing.hedging.predict_ttft` — the same snapshot-only TTFT
estimate the hedging policy trusts — but draws the opposite conclusion:
where hedging DUPLICATES a salvageable request, shedding REFUSES an
unsalvageable one. When the predicted queueing + prefill delay already
exceeds a request's deadline at admission time, burning prefill on it
only makes every other request later; the request is resolved immediately
with `FinishReason.SHED` so the client can retry elsewhere.

Pure snapshot decision (queue depths + prompt length + deadline — no
clocks), so the LB-level shed and the replica-level shed reach identical
verdicts in the sim, the tick router, and the socket plane, and the
replica's `("shed", rid)` decision records parity-test across backends.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AdmissionParams:
    """Calibration for the shed predictor (same knobs as `HedgeParams`,
    which is what lets `predict_ttft` accept either)."""
    prefill_tps: float = 1700.0       # uncached prefill throughput
    queue_wait_s: float = 0.05        # wait per request already pending
    per_outstanding_s: float = 0.003  # decode interference per running seq
    slack_frac: float = 1.0           # shed when pred > slack_frac * deadline


DEFAULT_ADMISSION = AdmissionParams()


def should_shed(prompt_len: int, pending: int, outstanding: int,
                deadline_s: Optional[float],
                params: AdmissionParams = DEFAULT_ADMISSION) -> bool:
    """Shed iff the request has a deadline and the snapshot-predicted TTFT
    already exceeds it (scaled by `slack_frac`). Deadline-free requests
    are never shed — they have nothing to blow."""
    if deadline_s is None:
        return False
    # imported lazily: repro.routing.core imports this module at load time,
    # and pulling repro.routing.hedging here would run repro.routing's
    # package __init__ mid-import (circular); by first call, routing is up
    from repro_torch.routing.hedging import predict_ttft
    pred = predict_ttft(int(prompt_len), int(pending), int(outstanding),
                        params)
    return pred > params.slack_frac * float(deadline_s)
