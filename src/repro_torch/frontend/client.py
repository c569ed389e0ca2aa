# Copy of src/repro/frontend/client.py (no import of the JAX package).
"""One `Client`, two clocks: the transport-agnostic front door.

`Client.submit(GenRequest) -> RequestHandle` drives whichever substrate the
host wraps:

  SimHost(ServingSystem)       virtual time — requests become sim
                               `Request`s, token events ride the event
                               clock, pump = one discrete event
  RouterHost(InProcessRouter)  wall clock over real JAX engines behind the
                               two-layer SkyLB router, pump = one tick
  EngineHost(Engine)           wall clock, single replica, pump = one
                               continuous-batching iteration

The Client owns the substrate-independent parts of the lifecycle: mapping
`slo_class` to a scheduling priority, handle bookkeeping, and cancel
fan-in. Everything that needs a clock or a wire lives in the host —
including the expired-at-submit deadline check: every host aborts a
`deadline_s <= 0` request with `FinishReason.DEADLINE` before any
dispatch (a new host implementation must do the same).
"""
from __future__ import annotations

import time
from typing import Dict

from repro_torch.frontend.api import RequestHandle, RequestState
from repro_torch.serving.request import FinishReason, GenRequest, slo_priority

_REASON_STATE = {
    FinishReason.LENGTH: RequestState.FINISHED,
    FinishReason.STOP: RequestState.FINISHED,
    FinishReason.ABORT: RequestState.ABORT,
    FinishReason.CANCELLED: RequestState.CANCELLED,
    FinishReason.DEADLINE: RequestState.DEADLINE,
    FinishReason.SHED: RequestState.SHED,
}


def state_of(reason: FinishReason) -> RequestState:
    return _REASON_STATE[reason]


def wire_gen_request(req: GenRequest, handle: RequestHandle) -> None:
    """Point a GenRequest's host-notification slots at a handle (the
    engine/router hosts speak these directly; the sim host converts)."""
    req.on_admit = lambda r, t: handle._admit(t)
    req.on_token = lambda r, tok, idx, t: handle._token(tok, idx, t)
    req.on_done = lambda res: handle._finish(res, state_of(res.finish_reason))


class Client:
    """The unified streaming request API over any host."""

    def __init__(self, host):
        self.host = host
        self.handles: Dict[int, RequestHandle] = {}   # live (non-terminal)

    # ------------------------------------------------------------ submit
    def submit(self, req: GenRequest, region: str = "us",
               **host_kw) -> RequestHandle:
        if req.priority == 0:       # an explicit priority wins over the class
            req.priority = slo_priority(req.slo_class)
        handle = RequestHandle(req, canceller=self._cancel, pump=self.poll)
        self.handles[req.rid] = handle
        handle.on_done(lambda _res, rid=req.rid: self.handles.pop(rid, None))
        # an already-expired deadline (deadline_s <= 0) is the HOST's to
        # resolve — every transport aborts it before any dispatch, and the
        # sim host also counts it in RunMetrics like the legacy path does
        self.host.submit(req, region, handle, **host_kw)
        return handle

    # ------------------------------------------------------------ control
    def _cancel(self, handle: RequestHandle) -> bool:
        return bool(self.host.cancel(handle.rid, "cancelled"))

    def poll(self) -> bool:
        """Advance the host one unit (event / tick). False when idle."""
        return bool(self.host.pump())

    def drain(self, max_pumps: int = 10_000_000) -> None:
        """Pump until every outstanding handle is terminal (or the host
        goes idle — lost work then shows as non-terminal handles)."""
        for _ in range(max_pumps):
            if not self.handles:
                return
            if not self.host.pump():
                return

    def now(self) -> float:
        return self.host.now()


# ---------------------------------------------------------------- hosts

class SimHost:
    """Virtual-time host over `repro.core.system.ServingSystem`: the
    GenRequest becomes a sim `Request` (predetermined completion via
    `output_tokens=`, else analytic filler tokens), and the system's
    handle-native submit path does the event wiring."""

    def __init__(self, system):
        self.system = system

    def now(self) -> float:
        return self.system.sim.now

    def submit(self, req: GenRequest, region: str, handle: RequestHandle,
               output_tokens: tuple = ()) -> None:
        from repro_torch.core.simulator import Request as SimRequest
        sreq = SimRequest(
            rid=req.rid, user_id=req.user_id,
            session_key=req.session_key or req.user_id, region=region,
            prompt_tokens=tuple(req.prompt_tokens),
            output_len=req.sampling.max_new_tokens,
            output_tokens=tuple(output_tokens),
            priority=req.priority, deadline_s=req.deadline_s,
            slo_class=req.slo_class, tenant_weight=req.tenant_weight)
        self.system.submit(sreq, handle=handle)

    def cancel(self, rid: int, reason: str) -> bool:
        return self.system.cancel(rid, reason)

    def pump(self) -> bool:
        return self.system.sim.run(max_events=1) > 0


class RouterHost:
    """Wall-clock host over `repro.serving.router.InProcessRouter` (real
    JAX engines, tick-delayed WAN): one pump = one router tick."""

    def __init__(self, router):
        self.router = router

    def now(self) -> float:
        return time.monotonic()

    def submit(self, req: GenRequest, region: str,
               handle: RequestHandle) -> None:
        wire_gen_request(req, handle)
        self.router.submit(region, req)

    def cancel(self, rid: int, reason: str) -> bool:
        return self.router.cancel(rid, reason)

    def pump(self) -> bool:
        if self.router.idle():
            return False
        self.router.step()
        return True


class EngineHost:
    """Wall-clock host over a single `repro.serving.engine.Engine`
    (no router layer); `region` is accepted and ignored."""

    def __init__(self, engine):
        self.engine = engine

    def now(self) -> float:
        return time.monotonic()

    def submit(self, req: GenRequest, region: str,
               handle: RequestHandle) -> None:
        wire_gen_request(req, handle)
        self.engine.submit(req)

    def cancel(self, rid: int, reason: str) -> bool:
        return self.engine.cancel(rid, reason)

    def pump(self) -> bool:
        if (not self.engine.pending and not self.engine.running
                and not self.engine.loading):
            return False
        self.engine.step()
        return True
