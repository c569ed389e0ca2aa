# Copy of src/repro/serving/router.py over the port's Engine (no import of
# the JAX package).
"""In-process SkyLB router over REAL engines, driven by the same
transport-agnostic `repro_torch.routing.RoutingCore` as the JAX package's
discrete-event simulator: the TargetViews are probed from live Engine
instances and routing drives actual PyTorch prefill / decode steps.

Time is ticks (one `step()` = one continuous-batching iteration everywhere).
The WAN is modeled as tick-delayed delivery queues: a cross-region forward,
steal, or failover handoff arrives `wan_delay_ticks` later, and heartbeats
refresh every `probe_every` (local) / `remote_probe_every` (remote) ticks —
so the engine path sees the same stale-snapshot regime, work stealing, and
controller-style LB failover the simulator models, just with real tokens
moving through real paged KV caches.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import deque
from typing import Callable, Optional

from repro_torch.routing import (RoutingConfig, RoutingCore, RoutingSpec,
                                 SP_P, LeastLoad, Policy, TargetView,
                                 build_routing)
from repro_torch.routing.failover import FailoverTracker
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import (GenRequest, GenResult,
                                         cancel_finish_reason)


class _TickTransport:
    """Transport for RoutingCore over in-process engines: latency = ticks,
    delivery via the router's mailbox heap."""

    def __init__(self, router: "InProcessRouter", lb: "_RegionLB"):
        self.router = router
        self.lb = lb

    def now(self) -> float:
        return self.router.now()

    def target_alive(self, target_id: str) -> bool:
        return target_id in self.lb.engines

    def peer_alive(self, peer_id: str) -> bool:
        peer = self.router.lbs.get(peer_id)
        return peer is not None and peer.alive

    def deliver(self, req: GenRequest, target_id: str) -> None:
        self.router._after(
            self.router.local_delay_ticks,
            lambda: self.router._deliver_engine(self.lb, target_id, req))

    def forward(self, req: GenRequest, peer_id: str) -> None:
        self.router._after(self.router.wan_delay_ticks,
                           lambda: self.router._arrive(peer_id, req))

    def pull_pages(self, req: GenRequest, peer_id: str, target_id: str,
                   prefix_len: int, pull_tokens: int) -> None:
        """Pull-prefix: after a full WAN round trip (request out, KV pages
        back) the peer's best cached prefix lands in `target_id`'s paged KV
        pool via export_prefix/import_prefix — REAL bytes move between real
        engines — then the request starts locally over the warmed cache."""
        del pull_tokens     # tick transport: latency is ticks, not bytes
        prefix = tuple(req.prompt_tokens)[:prefix_len]

        def _xfer():
            eng = self.lb.engines.get(target_id)
            if eng is None:                   # engine moved by failover
                home = self.router._engine_home.get(target_id)
                if home is not None:
                    eng = home.engines.get(target_id)
            if eng is None:                   # target gone: route again
                self.router._arrive(self.lb.region, req)
                return
            peer = self.router.lbs.get(peer_id)
            if peer is not None and peer.alive:
                best = None
                for pe in peer.engines.values():
                    n, ks, vs = pe.export_prefix(prefix)
                    if n and (best is None or n > best[0]):
                        best = (n, ks, vs)
                if best is not None:
                    eng.import_prefix(prefix[:best[0]], best[1], best[2])
            eng.submit(req)

        self.router._after(2 * self.router.wan_delay_ticks, _xfer)

    def steal_request(self, peer_id: str, n: int) -> None:
        self.router._after(
            self.router.wan_delay_ticks,
            lambda: self.router._serve_steal(peer_id, self.lb.region, n))

    def shed(self, req: GenRequest) -> None:
        """Admission-control shed: terminal SHED result, no engine ever
        sees the request."""
        self.router._resolve_front(req, "shed")

    # ---- hedged dispatch (tail-TTFT insurance for the `latency` class)
    def hedge(self, req: GenRequest, peer_id: str) -> None:
        """Duplicate `req` to `peer_id`: a clone (fresh rid, no deadline,
        marked forwarded so it can't re-forward or re-hedge) races the
        primary over a real second engine, FIRST TOKEN WINS, and the loser
        is reaped through the exactly-once cancel path. The clone's stream
        and terminal result — re-keyed to the primary rid — surface through
        the primary's callbacks when it wins, so the frontend handle sees
        one rid-consistent lifecycle either way."""
        rt = self.router
        clone = req.clone_for_dispatch()
        clone.forwarded = True
        rt.hedged += 1
        rt._hedge_clone_rids.add(clone.rid)
        orig_token = req.on_token
        orig_done = req.on_done
        state: dict = {"winner": None}

        def decide(who) -> None:
            if state["winner"] is not None:
                return
            state["winner"] = who
            if who is clone:
                rt.hedge_wins += 1
            self._reap_hedge_loser(req if who is clone else clone)

        def primary_token(r, tok, idx, t):
            decide(req)
            if state["winner"] is req:
                if orig_token is not None:
                    orig_token(req, tok, idx, t)
            else:
                rt.wasted_work_tok += 1

        def clone_token(r, tok, idx, t):
            decide(clone)
            if state["winner"] is clone:
                if orig_token is not None:
                    orig_token(req, tok, idx, t)
            else:
                rt.wasted_work_tok += 1

        def primary_done(res: GenResult):
            if state["winner"] is None:
                decide(req)         # finished without a token (error path)
            if state["winner"] is req:
                if orig_done is not None:
                    orig_done(res)
            # else: the primary lost; its cancel result is overridden by
            # the clone's completion in `results()` / `clone_done`

        def clone_done(res: GenResult):
            if state["winner"] is None:
                decide(clone)
            if state["winner"] is clone:
                req.cached_tokens = clone.cached_tokens
                req.first_token_s = clone.first_token_s
                req.finished_s = clone.finished_s
                out = dataclasses.replace(res, rid=req.rid)
                rt._hedge_overrides[req.rid] = out
                if orig_done is not None:
                    orig_done(out)
            # clone lost: its cancel resolution ends here, exactly once

        req.on_token, req.on_done = primary_token, primary_done
        clone.on_token, clone.on_done = clone_token, clone_done
        rt._after(rt.wan_delay_ticks, lambda: rt._arrive(peer_id, clone))

    def _reap_hedge_loser(self, loser: GenRequest) -> None:
        """Cancel the losing leg wherever it is: an LB queue, an engine
        (pending / running / loading), or the WAN — where the travelling
        `cancelled` flag resolves it at the next arrival."""
        loser.cancelled = "cancelled"
        for lb in self.router.lbs.values():
            got = lb.core.cancel(loser.rid)
            if got is not None:
                self.router._resolve_front(got, "cancelled")
                return
        for lb in self.router.lbs.values():
            for e in lb.engines.values():
                ran = any(s.req.rid == loser.rid for s in e.core.running)
                if e.cancel(loser.rid, "cancelled"):
                    # compute the loser burned before the reap: uncached
                    # prefill (if it was admitted) + any decoded tokens —
                    # all spent, none delivered
                    res = e.results.get(loser.rid)
                    if res is not None:
                        waste = len(res.output_tokens)
                        if ran:
                            waste += max(0, res.prompt_len
                                         - res.cached_tokens)
                        self.router.wasted_work_tok += waste
                    return


class _RegionLB:
    """One region's LB: a RoutingCore probing live Engine instances."""

    def __init__(self, router: "InProcessRouter", region: str, policy: Policy,
                 remote_policy: Optional[Policy], cfg: RoutingConfig):
        self.router = router
        self.region = region
        self.policy = policy
        self.alive = True
        self.engines: dict[str, Engine] = {}
        self.core = RoutingCore(region, policy, remote_policy, cfg,
                                _TickTransport(router, self))

    @property
    def queue(self) -> deque:
        return self.core.queue

    @property
    def forwarded_out(self) -> int:
        return self.core.forwarded_out

    def add_engine(self, eid: str, engine: Engine) -> None:
        self.engines[eid] = engine
        self.router._engine_home[eid] = self
        self.core.target_added(self._view_of(eid, engine))

    def remove_engine(self, eid: str) -> Optional[Engine]:
        e = self.engines.pop(eid, None)
        self.core.target_removed(eid)
        self.router._engine_home.pop(eid, None)
        return e

    # ---- what probes see
    def _view_of(self, eid: str, e: Engine) -> TargetView:
        return TargetView(id=eid, outstanding=e.outstanding(),
                          pending=e.pending_count(), available=e.available(),
                          tenant_counters=(e.tenant_counters() or None
                                           if self.core.cfg.fairness
                                           else None))

    def views(self) -> list[TargetView]:
        return [self._view_of(eid, e) for eid, e in self.engines.items()]

    def n_avail(self) -> int:
        return sum(1 for e in self.engines.values() if e.available())

    def as_remote_view(self) -> TargetView:
        if not self.alive:
            return TargetView.unavailable(self.region)
        return TargetView(
            id=self.region, n_avail_replicas=self.n_avail(),
            n_replicas=len(self.engines),
            queue_len=len(self.queue),
            outstanding=sum(e.outstanding() for e in self.engines.values()),
            tenant_counters=self.core.tenant_snapshot())


class InProcessRouter:
    """Two-layer SkyLB over in-process engines (one LB per region)."""

    def __init__(self, remote_policy: Optional[Policy] = None,
                 pushing: str = SP_P, cross_region: bool = True, *,
                 work_stealing: bool = False,
                 cfg: Optional[RoutingConfig] = None,
                 wan_delay_ticks: int = 1, local_delay_ticks: int = 0,
                 probe_every: int = 1, remote_probe_every: int = 2,
                 clock: str = "tick"):
        self.remote_policy = remote_policy
        self.cfg = (dataclasses.replace(cfg) if cfg is not None
                    else RoutingConfig(pushing=pushing,
                                       cross_region=cross_region,
                                       work_stealing=work_stealing))
        self.lbs: dict[str, _RegionLB] = {}
        self.wan_delay_ticks = wan_delay_ticks
        self.local_delay_ticks = local_delay_ticks
        self.probe_every = max(1, probe_every)
        self.remote_probe_every = max(1, remote_probe_every)
        # what RoutingCore sees as time: "tick" (the deterministic default
        # — one step() == one unit) or "wall" (time.monotonic(), matching
        # the socket plane's SocketTransport so the same core runs on
        # either substrate without caring which)
        if clock not in ("tick", "wall"):
            raise ValueError(f"clock must be 'tick' or 'wall', got {clock!r}")
        self.clock = clock
        self.tick = 0
        self._mail: list[tuple[int, int, Callable]] = []   # (due, seq, fn)
        self._seq = itertools.count()
        self._engine_home: dict[str, _RegionLB] = {}
        self.tracker = FailoverTracker()
        self._spec: Optional[RoutingSpec] = None
        self.events: list[tuple[int, str]] = []
        self._inflight: dict[int, GenRequest] = {}
        # terminal results for requests that never reached an engine
        # (cancelled / deadline-aborted while queued or on the WAN)
        self._front_results: dict[int, GenResult] = {}
        # hedged dispatch (repro.routing.hedging): clone rids are internal
        # artifacts hidden from results(); a clone win overrides the
        # primary rid's (cancelled) engine result with the real completion
        self.hedged = 0
        self.hedge_wins = 0
        self.wasted_work_tok = 0
        self._hedge_clone_rids: set[int] = set()
        self._hedge_overrides: dict[int, GenResult] = {}

    @classmethod
    def from_spec(cls, spec: RoutingSpec | str,
                  cfg_overrides: Optional[dict] = None,
                  **kw) -> "InProcessRouter":
        """Build from a `build_routing()` spec (or variant name): the same
        policies/pushing/stealing wiring the simulator's ServingSystem uses.
        `cfg_overrides` tweaks RoutingConfig fields (e.g. a tighter
        `max_inflight_per_probe` for tick-granularity heartbeats).
        """
        if isinstance(spec, str):
            spec = build_routing(spec)
        router = cls(cfg=spec.make_config(**(cfg_overrides or {})), **kw)
        router._spec = spec
        return router

    def add_region(self, region: str,
                   policy: Optional[Policy] = None) -> _RegionLB:
        if policy is None:
            policy = (self._spec.local_policy() if self._spec is not None
                      else LeastLoad())
        # spec-built routers give each region its OWN remote policy instance
        # (matching the simulator's per-LB wiring); the legacy constructor
        # arg shares one instance across regions, as the old router did
        if self._spec is not None and self._spec.remote_policy is not None:
            remote_policy = self._spec.remote_policy()
        else:
            remote_policy = self.remote_policy
        lb = _RegionLB(self, region, policy, remote_policy,
                       dataclasses.replace(self.cfg))
        self.lbs[region] = lb
        for other in self.lbs.values():
            if other is not lb:
                other.core.peer_added(region)
                lb.core.peer_added(other.region)
        return lb

    def now(self) -> float:
        """RoutingCore's clock: ticks by default, wall seconds when built
        with clock="wall" (message latency stays tick-counted either way —
        only what the core's decisions OBSERVE as `transport.now()`
        changes)."""
        return time.monotonic() if self.clock == "wall" else float(self.tick)

    # ------------------------------------------------------------ mailbox
    def _after(self, delay_ticks: int, fn: Callable) -> None:
        if delay_ticks <= 0:
            fn()
            return
        heapq.heappush(self._mail,
                       (self.tick + delay_ticks, next(self._seq), fn))

    def _run_mail(self) -> None:
        while self._mail and self._mail[0][0] <= self.tick:
            _, _, fn = heapq.heappop(self._mail)
            fn()

    # ------------------------------------------------------------ arrival
    def _live_fallback(self) -> Optional[_RegionLB]:
        return next((x for x in self.lbs.values() if x.alive), None)

    def _arrive(self, region: str, req: GenRequest) -> None:
        """A request reaches a region LB (forward, steal, or failover)."""
        if req.cancelled is not None:
            # cancel raced the request onto the WAN: resolve at arrival,
            # exactly once (there is one request object; nobody queues it)
            self._resolve_front(req, req.cancelled)
            return
        lb = self.lbs.get(region)
        if lb is None or not lb.alive:
            lb = self._live_fallback() or lb
        if lb is not None:
            lb.core.on_request(req)

    def _deliver_engine(self, lb: _RegionLB, eid: str,
                        req: GenRequest) -> None:
        eng = lb.engines.get(eid)
        if eng is None:                       # engine moved by failover
            home = self._engine_home.get(eid)
            if home is not None:
                eng = home.engines.get(eid)
        if eng is not None:
            eng.submit(req)
        else:                                 # engine gone: route again
            lb.core.on_request(req)

    def _serve_steal(self, victim_region: str, thief_region: str,
                     n: int) -> None:
        victim = self.lbs.get(victim_region)
        if victim is None or not victim.alive:
            return
        for req in victim.core.release_for_steal(n, thief_region):
            self._after(self.wan_delay_ticks,
                        lambda q=req: self._arrive(thief_region, q))

    # ------------------------------------------------------------ failover
    def fail_lb(self, region: str) -> None:
        self.lbs[region].alive = False

    def recover_lb(self, region: str) -> None:
        self.lbs[region].alive = True

    def _controller_check(self) -> None:
        """Controller-style LB failover (paper §4.2) on the engine path:
        a dead LB's engines and queue move to a live host; on recovery the
        LB reclaims the engines whose HOME region it is, from wherever
        cascading failures moved them."""
        for region, lb in self.lbs.items():
            if self.tracker.needs_failover(region, lb.alive):
                host = self._live_fallback()
                if host is None:
                    continue
                self.tracker.record_failover(region,
                                             list(lb.engines.items()))
                for eid in list(lb.engines):
                    e = lb.remove_engine(eid)
                    if e is not None:
                        host.add_engine(eid, e)
                while lb.core.queue:
                    req = lb.core.queue.popleft()
                    self._after(self.wan_delay_ticks,
                                lambda q=req: self._arrive(host.region, q))
                self.events.append(
                    (self.tick, f"failover {region} -> {host.region}"))
            elif self.tracker.needs_restore(region, lb.alive):
                for eid, _e in self.tracker.reclaimable(region):
                    home = self._engine_home.get(eid)
                    if home is None or home is lb:
                        continue
                    e = home.remove_engine(eid)
                    if e is not None:
                        lb.add_engine(eid, e)
                self.tracker.mark_restored(region)
                self.events.append((self.tick, f"restore {region}"))

    # ------------------------------------------------------------ routing
    def submit(self, region: str, req: GenRequest) -> None:
        if req.arrival_s is None:       # admission stamp, this clock
            req.arrival_s = time.monotonic()
        prev_done = req.on_done

        def _done(res, _prev=prev_done, rid=req.rid):
            self._inflight.pop(rid, None)
            if _prev is not None:
                _prev(res)
        req.on_done = _done
        self._inflight[req.rid] = req
        if req.deadline_s is not None and req.deadline_s <= 0:
            # expired at submit: immediate DEADLINE abort, nothing reaches
            # any LB queue or engine
            self._resolve_front(req, "deadline")
            return
        lb = self.lbs[region]
        if not lb.alive:
            lb = self._live_fallback() or lb
        lb.core.on_request(req)

    # ------------------------------------------------------------ cancel
    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Propagate a cancel to wherever the request is: an LB queue, an
        engine (pending or mid-decode), or the WAN (forward/steal/failover
        message in flight — the flag travels on the request and the next
        host resolves it, so a cancel racing a steal resolves exactly
        once). False when already terminal (cancel after finish: no-op)."""
        req = self._inflight.get(rid)
        if req is None or req.cancelled is not None:
            return False
        req.cancelled = reason
        for lb in self.lbs.values():
            got = lb.core.cancel(rid)
            if got is not None:                 # still queued at this LB
                self._resolve_front(got, reason)
                return True
        for lb in self.lbs.values():
            for e in lb.engines.values():
                if e.cancel(rid, reason):
                    return True
        return True     # on the WAN: resolved once, at the next arrival

    def _resolve_front(self, req: GenRequest, reason: str) -> None:
        """Terminal result for a request that never reached an engine."""
        if req.rid in self._front_results:
            return
        now = time.monotonic()
        res = GenResult(
            rid=req.rid, output_tokens=(),
            finish_reason=cancel_finish_reason(reason),
            cached_tokens=0, prompt_len=len(req.prompt_tokens),
            e2e_s=(now - req.arrival_s
                   if req.arrival_s is not None else None))
        self._front_results[req.rid] = res
        if req.on_done is not None:
            req.on_done(res)

    def _sweep_deadlines(self) -> None:
        """Reap LB-queued requests whose deadline expired (engine-side
        expiry is swept by each Engine.step)."""
        now = time.monotonic()
        for lb in self.lbs.values():
            expired = [r.rid for r in lb.core.queue
                       if r.deadline_s is not None
                       and r.arrival_s is not None
                       and now - r.arrival_s > r.deadline_s]
            for rid in expired:
                self.cancel(rid, "deadline")

    # ------------------------------------------------------------ driving
    def step(self) -> int:
        """One global tick: deliver in-flight WAN messages, fire due
        heartbeats (which dispatch), run failover, then step every engine
        one continuous-batching iteration."""
        self._run_mail()
        self._sweep_deadlines()
        if self.tick % self.probe_every == 0:
            for lb in self.lbs.values():
                if lb.alive:
                    lb.core.refresh_local(lb.views())
        if self.tick % self.remote_probe_every == 0:
            for lb in self.lbs.values():
                if lb.alive:
                    lb.core.refresh_remote(
                        [o.as_remote_view() for o in self.lbs.values()
                         if o is not lb])
        for lb in self.lbs.values():
            if lb.alive:
                lb.core.maybe_steal()
        self._controller_check()
        done = 0
        for lb in self.lbs.values():
            for e in lb.engines.values():
                done += e.step()
        self.tick += 1
        return done

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            self.step()
            if self.idle():
                break

    def idle(self) -> bool:
        return (not self._mail
                and all(not lb.queue and all(
                    not e.pending and not e.running and not e.loading
                    for e in lb.engines.values())
                    for lb in self.lbs.values()))

    def results(self) -> dict[int, GenResult]:
        out: dict[int, GenResult] = dict(self._front_results)
        for lb in self.lbs.values():
            for e in lb.engines.values():
                out.update(e.results)
        for rid in self._hedge_clone_rids:      # internal artifacts
            out.pop(rid, None)
        out.update(self._hedge_overrides)       # clone-won completions
        return out
