# Copy of src/repro/serving/request.py (no import of the JAX package).
"""Request/response types for the serving engine (OpenAI-completions-ish,
token-level: the LB layer and the engine both speak token ids).

These are also the types of the unified front API (`repro.frontend`): a
`GenRequest` carries the full request lifecycle contract — per-request
`deadline_s` (seconds after admission; expired requests abort with
`FinishReason.DEADLINE`), an `slo_class` label, and the internal callback
slots (`on_admit` / `on_token` / `on_done`) the hosts use to feed a
`repro.frontend.RequestHandle` its token-event stream and terminal
`GenResult`.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, Optional

_rid = itertools.count()


def next_rid() -> int:
    """The ONE process-wide request-id source. `GenRequest` draws from it
    by default; the simulator's internal clients draw from it too, so a
    frontend request and a sim-workload request can never collide in the
    rid-keyed cancel/deadline registries."""
    return next(_rid)


# `GenRequest.slo_class` labels -> scheduling priority (higher may preempt
# lower when the replica runs with preemption enabled). "standard" is 0 —
# the same priority a request gets on the legacy surfaces — so entering
# through the frontend Client never changes how default traffic schedules;
# "batch" yields to it, "interactive" may preempt it; "latency" sits above
# all of them AND is the one class eligible for cross-region hedged
# dispatch (repro.routing.hedging). Unknown labels map to "standard".
SLO_CLASSES = {"batch": -1, "standard": 0, "interactive": 1, "latency": 2}


def slo_priority(slo_class: str) -> int:
    return SLO_CLASSES.get(slo_class, SLO_CLASSES["standard"])


def cancel_finish_reason(reason: str) -> "FinishReason":
    """The FinishReason a travelling cancel flag ("cancelled"|"deadline"|
    "shed") resolves to — one mapping for every host."""
    if reason == "deadline":
        return FinishReason.DEADLINE
    if reason == "shed":
        return FinishReason.SHED
    return FinishReason.CANCELLED


class FinishReason(str, enum.Enum):
    LENGTH = "length"
    STOP = "stop"
    ABORT = "abort"
    CANCELLED = "cancelled"       # client called handle.cancel()
    DEADLINE = "deadline"         # deadline_s expired before completion
    SHED = "shed"                 # refused at admission: predicted queueing
                                  # delay already exceeded deadline_s


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 64
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => disabled
    stop_token: Optional[int] = None  # eos
    seed: int = 0


@dataclasses.dataclass
class GenRequest:
    prompt_tokens: tuple
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    rid: int = dataclasses.field(default_factory=next_rid)
    user_id: str = ""
    session_key: str = ""
    priority: int = 0                 # higher may preempt lower (replica core)
    # weighted fairness (repro.tenancy): a weight-w tenant is charged 1/w
    # per served token under the weighted VTC discipline. Content, not
    # lifecycle — it rides clones and wire frames with the request.
    tenant_weight: float = 1.0
    # Lifecycle (the unified front API):
    deadline_s: Optional[float] = None   # relative to admission; <= 0 at
                                         # submit aborts before any dispatch
    slo_class: str = "standard"
    # stamped at SUBMIT time by the accepting transport's clock (wall for
    # the engine/router, sim seconds for sim-driven requests) — never at
    # dataclass construction, which measured the wrong thing on the wrong
    # clock for sim requests
    arrival_s: Optional[float] = None
    # a cancel that raced the request onto the WAN travels as this flag
    # ("cancelled" | "deadline"); the next host to see the request resolves
    # it exactly once
    cancelled: Optional[str] = None
    # filled by the engine:
    cached_tokens: int = 0
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    # host -> frontend notification slots (set by repro.frontend / callers;
    # excluded from equality so requests still compare by content)
    on_admit: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)   # (req, t)
    on_token: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)   # (req, token, index, t)
    on_done: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)   # (GenResult)

    def clone_for_dispatch(self, *, fresh_rid: bool = True) -> "GenRequest":
        """A copy safe to dispatch as a SEPARATE request (hedge clones, wire
        re-dispatch): same content (prompt/sampling/identity/priority/
        slo_class), but every lifecycle field is reset — fresh rid (unless
        `fresh_rid=False`), no deadline, no travelling-cancel flag, no
        clocks, no engine progress, and NO callbacks (a clone that inherited
        `on_token`/`on_done` would double-fire the primary's handle; one
        that inherited `deadline_s` would race two deadline owners). New
        GenRequest fields default to leaking into clones via
        `dataclasses.replace` — add them to the reset list here if they are
        per-dispatch state, so they can't silently ride along."""
        clone = dataclasses.replace(
            self, rid=(next_rid() if fresh_rid else self.rid),
            deadline_s=None, cancelled=None, arrival_s=None,
            cached_tokens=0, first_token_s=None, finished_s=None,
            on_admit=None, on_token=None, on_done=None)
        # predetermined completion (cost-backend replay) is content, not
        # lifecycle: it rides along when present
        out = getattr(self, "output_tokens", None)
        if out is not None:
            clone.output_tokens = out
        return clone


@dataclasses.dataclass
class GenResult:
    rid: int
    output_tokens: tuple
    finish_reason: FinishReason
    cached_tokens: int
    prompt_len: int
    ttft_s: Optional[float] = None
    e2e_s: Optional[float] = None
    error: Optional[str] = None       # set on ABORT (oversized rejection)
