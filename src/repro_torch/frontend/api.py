# Copy of src/repro/frontend/api.py (no import of the JAX package).
"""The unified request-lifecycle surface: `TokenEvent`, `RequestState`,
`RequestHandle`.

One front door for every serving substrate in the repo: submitting a
request returns a `RequestHandle` whose incremental token-event stream,
terminal `GenResult`, and `cancel()` work identically whether the tokens
come from the discrete-event simulator (virtual time) or the JAX paged
engine behind the in-process router (wall clock). Hosts feed the handle
through three internal notifications — `_admit` / `_token` / `_finish` —
emitted at continuous-batching STEP granularity (one drain per iteration;
on the JAX path the tokens are already host-resident from the step's
single sync, so streaming adds zero extra device dispatches).

Lifecycle state machine:

    QUEUED -> PREFILL -> DECODE -> { FINISHED, CANCELLED, DEADLINE, ABORT,
                                     SHED }

`QUEUED` covers LB queues + the replica pending queue; `PREFILL` starts at
replica admission; `DECODE` at the first emitted token (the prefill
boundary token). Any non-terminal state may jump straight to `CANCELLED`
(client called `handle.cancel()`), `DEADLINE` (`GenRequest.deadline_s`
expired), `ABORT` (replica rejected an oversized request), or `SHED`
(deadline-aware admission control refused it: the predicted queueing
delay already exceeded its deadline — see `repro.tenancy.admission`).

This module deliberately imports nothing heavy: hosts (`repro.core.system`,
`repro.serving.engine`, `repro.serving.router`) can depend on it without
cycles, and the sim path stays importable without JAX.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Iterator, List, Optional


class RequestState(str, enum.Enum):
    QUEUED = "queued"          # submitted; waiting at an LB or replica queue
    PREFILL = "prefill"        # admitted; prompt KV being (re)computed
    DECODE = "decode"          # first token out; decoding
    FINISHED = "finished"      # terminal: stop token / length budget
    CANCELLED = "cancelled"    # terminal: handle.cancel()
    DEADLINE = "deadline"      # terminal: deadline_s expired
    ABORT = "abort"            # terminal: rejected (oversized)
    SHED = "shed"              # terminal: refused at admission (predicted
                               # queueing delay exceeded deadline_s)

    @property
    def terminal(self) -> bool:
        return self in _TERMINAL


_TERMINAL = {RequestState.FINISHED, RequestState.CANCELLED,
             RequestState.DEADLINE, RequestState.ABORT, RequestState.SHED}


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One generated token, as observed by the client."""
    rid: int
    token: int
    index: int      # position in the output stream (0 = prefill boundary)
    t: float        # host clock: sim seconds (sim) / monotonic s (engine)


class RequestHandle:
    """Live view of one submitted request.

    The handle is a passive accumulator — both substrates are
    single-threaded event/tick loops, so progress happens when the host is
    pumped (`Client.poll()` / `Client.drain()` / `ServingSystem.run()` /
    `InProcessRouter.step()`), and the handle fills up as a side effect.
    `stream()` interleaves pumping with yielding, giving the familiar
    "iterate tokens as they arrive" shape on either clock.
    """

    def __init__(self, request, *, canceller: Optional[Callable] = None,
                 pump: Optional[Callable] = None):
        self.request = request
        self.rid = request.rid
        self.state = RequestState.QUEUED
        self.events: List[TokenEvent] = []
        self.result = None                    # terminal payload (GenResult)
        self._canceller = canceller           # (handle) -> bool
        self._pump = pump                     # () -> bool (False = idle)
        self._done_cbs: List[Callable] = []
        self._event_cbs: List[Callable] = []

    # ------------------------------------------------------------ queries
    @property
    def done(self) -> bool:
        return self.state.terminal

    @property
    def tokens(self) -> tuple:
        return tuple(e.token for e in self.events)

    def __repr__(self) -> str:
        return (f"RequestHandle(rid={self.rid}, state={self.state.value}, "
                f"tokens={len(self.events)})")

    # ------------------------------------------------------------ control
    def cancel(self) -> bool:
        """Ask the host to abandon this request. Returns False when already
        terminal (cancel-after-finish is a no-op). Resolution — freed pages,
        the terminal CANCELLED result — lands on the host's clock; pump the
        host (or `wait()`) to observe it."""
        if self.done or self._canceller is None:
            return False
        return bool(self._canceller(self))

    def wait(self, max_pumps: int = 1_000_000):
        """Pump the host until this request reaches a terminal state, the
        host goes idle, or `max_pumps` host advances have run (a bound for
        hosts that never idle, e.g. a sim with open-loop arrivals).
        Returns the terminal result (None if not terminal yet)."""
        for _ in range(max_pumps):
            if self.done or self._pump is None or not self._pump():
                break
        return self.result

    def stream(self, max_pumps: int = 1_000_000) -> Iterator[TokenEvent]:
        """Yield token events as they arrive, pumping the host between
        arrivals; ends when the request is terminal (`self.result` holds
        the GenResult)."""
        cursor = 0
        pumps = 0
        while True:
            while cursor < len(self.events):
                yield self.events[cursor]
                cursor += 1
            if self.done:
                return
            if self._pump is None or pumps >= max_pumps or not self._pump():
                return
            pumps += 1

    # ------------------------------------------------------------ wiring
    def on_event(self, cb: Callable) -> "RequestHandle":
        """Register cb(TokenEvent); replayed for already-received events."""
        for e in self.events:
            cb(e)
        self._event_cbs.append(cb)
        return self

    def on_done(self, cb: Callable) -> "RequestHandle":
        """Register cb(result); fires immediately if already terminal."""
        if self.done:
            cb(self.result)
        else:
            self._done_cbs.append(cb)
        return self

    # ---- host-side notifications (not part of the public surface)
    def _admit(self, t: float) -> None:
        if self.state == RequestState.QUEUED:
            self.state = RequestState.PREFILL

    def _token(self, token: int, index: int, t: float) -> None:
        if self.done:
            return
        ev = TokenEvent(self.rid, token, index, t)
        self.events.append(ev)
        self.state = RequestState.DECODE
        for cb in self._event_cbs:
            cb(ev)

    def _finish(self, result, state: RequestState) -> None:
        if self.done:
            return
        self.state = state
        self.result = result
        cbs, self._done_cbs = self._done_cbs, []
        for cb in cbs:
            cb(result)
