# Copy of src/repro/core/simulator.py (no import of the JAX package).
"""Discrete-event multi-region serving simulator.

Models: WAN RTTs between regions, per-replica continuous batching with a KV
token budget + radix prefix cache (TTFT = queueing + uncached prefill +
iteration), regional LBs with FCFS queues / heartbeat probes / two-layer
forwarding, a fault-tolerant controller (LB failover per paper §4.2),
stragglers and elastic scale-out.

The replica scheduler itself lives in the backend-agnostic
`repro.replica.ReplicaCore` — shared verbatim with the real JAX paged
engine — here driven with an analytic `CostModelBackend` at page_size=1
(pages == tokens). `ReplicaSim` is only the Sim-event host: it schedules
one event per continuous-batching iteration and puts the iteration's
analytic latency between the core's admission and decode phases.

Timing constants are calibrated to the paper's setup (Llama-3.1-8B on one
L4 via SGLang): ~1.7k tok/s prefill, ~30 tok/s/stream decode, KV budget
~32k tokens.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import warnings
from collections import deque
from typing import Callable, Optional

from repro_torch.replica import CostModelBackend, ReplicaCore, ReplicaCoreConfig
from repro_torch.routing.core import RoutingConfig, RoutingCore
from repro_torch.routing.failover import FailoverTracker
from repro_torch.routing.policies import BP, SP_O, SP_P, Policy, TargetView  # noqa: F401 — BP/SP_O/SP_P re-exported for callers


# ------------------------------------------------------------------ engine

class Sim:
    def __init__(self):
        self.now = 0.0
        self._heap: list = []
        self._seq = itertools.count()

    def at(self, t: float, fn: Callable) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def after(self, dt: float, fn: Callable) -> None:
        self.at(self.now + dt, fn)

    def run(self, until: float = float("inf"), max_events: int = 50_000_000):
        n = 0
        while self._heap and n < max_events:
            if self._heap[0][0] > until:     # peek — keep future events
                break
            t, _, fn = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            fn()
            n += 1
        return n


# ------------------------------------------------------------------ request

@dataclasses.dataclass
class Request:
    rid: int
    user_id: str
    session_key: str
    region: str
    prompt_tokens: tuple
    output_len: int
    output_tokens: tuple = ()       # deterministic completion (for reuse)
    priority: int = 0               # DEPRECATED when explicit: use slo_class
    tenant_weight: float = 1.0      # weighted fairness (repro.tenancy)
    arrival: float = 0.0            # at first LB
    issued: float = 0.0             # at client
    ttft: Optional[float] = None    # absolute time of first token
    finished: Optional[float] = None
    done_cb: Optional[Callable] = None
    cached_tokens: int = 0
    replica: Optional[str] = None
    forwarded: bool = False
    origin_lb: Optional[str] = None
    error: Optional[str] = None     # set when the replica rejects (oversized)
    # ---- lifecycle (unified front API; see repro.frontend) ----
    deadline_s: Optional[float] = None   # relative to `issued`
    slo_class: str = "standard"
    # a cancel that raced the request onto the WAN travels as this flag
    # ("cancelled" | "deadline"); the next host to see it resolves it once
    cancelled: Optional[str] = None
    # terminal disposition when not a plain completion
    finish_reason: Optional[str] = None
    # host -> frontend notifications (set by ServingSystem.submit)
    admit_cb: Optional[Callable] = None  # (req, t)
    token_cb: Optional[Callable] = None  # (req, token, index, t)

    def __post_init__(self):
        # The sim's integer `priority` used to be a second, parallel
        # priority notion next to `slo_class`. An EXPLICIT priority with
        # the default class now maps onto the matching SLO lane (and warns)
        # so there is one notion; requests that set both (the frontend
        # SimHost does, consistently) pass through untouched, and the
        # priority value itself is preserved, so replica-core scheduling
        # is identical either way.
        if self.priority != 0 and self.slo_class == "standard":
            warnings.warn(
                "Request.priority with a default slo_class is deprecated; "
                "set slo_class ('batch'|'interactive'|'latency') instead — "
                "mapping the priority onto the matching SLO lane",
                DeprecationWarning, stacklevel=3)
            if self.priority >= 2:
                self.slo_class = "latency"
            elif self.priority == 1:
                self.slo_class = "interactive"
            else:                   # priority < 0 yields to standard
                self.slo_class = "batch"


def resolve_cancelled(req: Request, now: float,
                      reason: Optional[str] = None) -> None:
    """Terminal resolution of a cancelled/deadline-aborted request — the
    ONE implementation every sim-side site uses (LB queue pull, replica
    reap, WAN-arrival of a travelling cancel flag), so 'resolves exactly
    once' bookkeeping can never diverge per location. Callers guard on
    `req.finished is None`."""
    req.finish_reason = reason or req.cancelled or "cancelled"
    req.finished = now
    if req.done_cb:
        req.done_cb(req)


# ------------------------------------------------------------------ replica

@dataclasses.dataclass
class ReplicaConfig:
    kv_budget: int = 32768          # tokens resident (running + cache)
    prefill_tps: float = 1700.0
    decode_base: float = 0.03       # s per iteration
    decode_per_seq: float = 0.0008  # s per running sequence
    speed_factor: float = 1.0       # >1 = straggler
    max_batch: int = 0              # max concurrent sequences; 0 = unbounded
    max_seq_len: int = 0            # prompt+output token cap; 0 = unbounded
    prefill_chunk: int = 0          # tokens per prefill chunk; 0 = unchunked
    preemption: bool = False        # priority preemption (recompute on resume)
    host_kv_budget: int = 0         # host-memory KV tier tokens; 0 = tier off
    kv_page_bytes: float = 131072.0  # bytes per KV page (page_size=1: token)
    host_copy_gbps: float = 20.0    # PCIe-class host<->device bandwidth
    # Speculative decoding (draft-k/verify-1), mirrored analytically by
    # CostModelBackend.decode_many; spec_k = 0 keeps the plain decode path.
    spec_k: int = 0                 # drafted tokens per decode iteration
    spec_accept_rate: float = 1.0   # per-draft acceptance probability
    spec_draft_cost: float = 0.15   # drafter fwd cost as fraction of target
    # Multi-tenant fairness + admission control (repro.tenancy); "fcfs"
    # keeps replica decision streams byte-identical to pre-tenancy.
    discipline: str = "fcfs"        # "fcfs" | "vtc" | "wvtc"
    cache_discount: float = 0.25    # VTC charge rate for cache-hit tokens
    shed_deadline: bool = False     # deadline-aware admission shedding


class ReplicaSim:
    """Thin Sim-event host around the shared `repro.replica.ReplicaCore`
    (CostModelBackend, page_size=1 so pages == tokens): one event per
    continuous-batching iteration, with the analytic iteration latency
    between the core's admission (`begin_step`) and decode (`finish_step`)
    phases. All admission / KV / radix / rejection / preemption decisions
    live in the core — shared with the real JAX `Engine`."""

    def __init__(self, sim: Sim, rid: str, region: str,
                 cfg: ReplicaConfig = ReplicaConfig()):
        self.sim = sim
        self.id = rid
        self.region = region
        # copy; backend reads it LIVE so straggler demotion applies at once
        self.cfg = dataclasses.replace(cfg)
        self.backend = CostModelBackend(self.cfg)
        self.core = ReplicaCore(ReplicaCoreConfig(
            page_size=1, n_pages=cfg.kv_budget, max_batch=cfg.max_batch,
            max_seq_len=cfg.max_seq_len, prefill_chunk=cfg.prefill_chunk,
            preemption=cfg.preemption,
            host_pages=cfg.host_kv_budget,
            discipline=cfg.discipline, cache_discount=cfg.cache_discount,
            shed_deadline=cfg.shed_deadline), self.backend)
        self._stepping = False
        self.alive = True
        self.draining = False
        self._drained_cb: Optional[Callable] = None
        # where rejected-at-the-door requests go while draining (the fleet
        # system points this back at a live LB so nothing is dropped)
        self.on_bounce: Optional[Callable] = None
        # tokens appended by the core this iteration, synthesized into
        # per-token events on the event clock when the iteration completes
        self._tokbuf: list = []
        self.core.token_sink = (
            lambda seq, tok, idx: self._tokbuf.append((seq, tok, idx)))

    # ---- introspection (what probes see)
    def pending_count(self) -> int:
        return self.core.pending_count()

    def outstanding(self) -> int:
        return self.core.outstanding()

    def kv_utilization(self) -> float:
        return self.core.kv_utilization()

    # ---- core state / stats pass-throughs
    @property
    def pending(self):
        return self.core.pending

    @property
    def running(self):
        return self.core.running

    @property
    def radix(self):
        return self.core.radix

    @property
    def peak_outstanding(self) -> int:
        return self.core.peak_outstanding

    @property
    def total_prefill_tokens(self) -> int:
        return self.core.total_prefill_tokens

    @property
    def total_cached_tokens(self) -> int:
        return self.core.total_cached_tokens

    @property
    def completions(self) -> int:
        return self.core.completions

    # ---- request entry
    def enqueue(self, req: Request) -> None:
        if req.cancelled is not None:
            # the cancel raced this request onto the wire: resolve it here,
            # exactly once (it is in nobody's queue anymore)
            if req.finished is None:
                resolve_cancelled(req, self.sim.now)
            return
        if self.draining or not self.alive:
            # a drained replica finishes what it HAS but admits nothing new;
            # requests already on the wire when the drain began bounce back
            # for re-routing instead of being dropped
            if self.on_bounce is not None:
                self.on_bounce(req)
                return
            req.error = f"replica {self.id} is draining"
            req.finished = self.sim.now
            if req.done_cb:
                req.done_cb(req)
            return
        self.core.submit(req)
        self._kick()

    # ---- cancellation (unified front API)
    def cancel(self, rid: int):
        """Abandon a request queued or running here: the core frees its
        pages/radix pins, and the request resolves with the finish_reason
        carried in `req.cancelled` ("cancelled" | "deadline"). Returns the
        reaped Seq, or None if `rid` is not on this replica."""
        seq = self.core.cancel(rid)
        if seq is not None and seq.req.finished is None:
            resolve_cancelled(seq.req, self.sim.now)
        return seq

    # ---- elastic membership (repro.provision)
    def drain(self, on_drained: Optional[Callable] = None) -> None:
        """Graceful decommission: stop admitting, let every in-flight
        request (pending + running) finish, then go dead and fire
        `on_drained(self)`. Contrast `kill()`, which drops in-flight."""
        self.draining = True
        self._drained_cb = on_drained
        # already idle: complete on a fresh event so same-tick enqueues
        # that were delivered before the drain still land first
        self.sim.after(0.0, self._maybe_finish_drain)

    def kill(self) -> None:
        """Hard stop: in-flight work is lost (crash semantics). A drain
        already in progress completes vacuously — its callback must still
        fire, or the caller (fleet controller lease, cost meter) waits
        forever on a replica that will never go idle."""
        self.alive = False
        if self.draining:
            self.sim.after(0.0, self._maybe_finish_drain)

    def _maybe_finish_drain(self) -> None:
        if not self.draining:
            return
        # a dead replica drains vacuously (its in-flight work is already
        # lost) — the callback must still fire or callers wait forever
        if self.alive and (self._stepping or self.core.outstanding() > 0):
            return
        self.alive = False
        self.draining = False
        cb, self._drained_cb = self._drained_cb, None
        if cb is not None:
            cb(self)

    def _kick(self) -> None:
        if not self._stepping and self.alive:
            self._stepping = True
            self.sim.after(0.0, self._step)

    # ---- continuous batching iteration
    def _step(self) -> None:
        if not self.alive:
            self._stepping = False
            return
        plan = self.core.begin_step()
        now = self.sim.now
        for seq in plan.admitted:
            seq.req.replica = self.id
            if seq.req.admit_cb is not None:
                seq.req.admit_cb(seq.req, now)
        for seq in plan.rejected:       # oversized: error result, not HOL wedge
            req: Request = seq.req
            req.error = seq.error
            req.finished = now
            if req.done_cb:
                req.done_cb(req)
        for seq in plan.shed:           # deadline-aware admission refusal
            if seq.req.finished is None:
                resolve_cancelled(seq.req, now, "shed")
        if not self.core.running and not self.core.loading:
            if self.core.pending:       # a rejection callback re-enqueued
                self.sim.after(0.0, self._step)
            else:
                self._stepping = False
                self._maybe_finish_drain()
            return
        dt = self.backend.step_cost(len(self.core.running))
        self.sim.after(dt, lambda a=plan.admitted: self._finish_step(a))

    def _finish_step(self, admitted: list) -> None:
        finished = self.core.finish_step()
        now = self.sim.now
        # synthesize this iteration's token events on the event clock (one
        # drain per step, mirroring the engine's one-host-sync-per-step)
        if self._tokbuf:
            buf, self._tokbuf = self._tokbuf, []
            for seq, tok, idx in buf:
                req = seq.req
                if req.token_cb is not None and req.finished is None:
                    req.token_cb(req, tok, idx, now)
        for seq in admitted:
            if seq.req.ttft is None:
                seq.req.ttft = now
        for seq in finished:
            req: Request = seq.req
            req.finished = now
            if req.done_cb:
                req.done_cb(req)
        if self.core.running or self.core.pending or self.core.loading:
            self.sim.after(0.0, self._step)
        else:
            self._stepping = False
            self._maybe_finish_drain()


# ------------------------------------------------------------------ network

class Network:
    """One-way latencies; RTT matrix keyed by region pairs."""
    DEFAULT_RTT = {
        ("us", "eu"): 0.140, ("us", "asia"): 0.180, ("eu", "asia"): 0.200,
    }

    def __init__(self, rtt: Optional[dict] = None, local_rtt: float = 0.004,
                 wan_gbps: float = 1.0):
        self.rtt = dict(self.DEFAULT_RTT)
        if rtt:
            self.rtt.update(rtt)
        self.local_rtt = local_rtt
        self.wan_gbps = wan_gbps        # inter-region KV transfer bandwidth
        self._warned_pairs: set = set()

    def one_way(self, a: str, b: str) -> float:
        if a == b:
            return self.local_rtt / 2
        key = (a, b) if (a, b) in self.rtt else (b, a)
        if key not in self.rtt:
            pair = frozenset((a, b))        # direction-independent dedup
            if pair not in self._warned_pairs:
                self._warned_pairs.add(pair)
                warnings.warn(
                    f"Network: no RTT configured for region pair {a}<->{b}; "
                    f"assuming 0.15 s RTT", stacklevel=2)
            return 0.15 / 2
        return self.rtt[key] / 2

    def kv_transfer_s(self, a: str, b: str, nbytes: float) -> float:
        """Latency of pulling `nbytes` of KV pages from region b to a: one
        request/response round trip, then the payload at WAN bandwidth."""
        return 2 * self.one_way(a, b) + nbytes / (self.wan_gbps * 1e9)


# ------------------------------------------------------------------ LB

# LB behaviour is configured by the transport-agnostic RoutingConfig; the
# old name stays as an alias for existing callers/tests.
LBConfig = RoutingConfig

# hedge clones get rids from a range no workload generator uses, so a
# clone's cancel can never pull someone else's request out of a queue
_HEDGE_RID = itertools.count(1_000_000_000)


class _SimTransport:
    """WAN transport for RoutingCore: one-way latencies from `Network`,
    delivery as discrete events on the shared `Sim` clock."""

    def __init__(self, lb: "LoadBalancerSim"):
        self.lb = lb

    def now(self) -> float:
        return self.lb.sim.now

    def target_alive(self, target_id: str) -> bool:
        r = self.lb.replicas.get(target_id)
        return r is not None and r.alive

    def peer_alive(self, peer_id: str) -> bool:
        p = self.lb.remote_lbs.get(peer_id)
        return p is not None and p.alive

    def deliver(self, req: Request, target_id: str) -> None:
        r = self.lb.replicas.get(target_id)
        if r is None:
            # target decommissioned between the eligibility check and the
            # send (elastic membership): requeue instead of crashing
            self.lb.sim.after(0.0, lambda: self.lb.on_request(req))
            return
        self.lb.sim.after(self.lb.net.one_way(self.lb.region, r.region),
                          lambda: r.enqueue(req))

    def forward(self, req: Request, peer_id: str) -> None:
        peer = self.lb.remote_lbs[peer_id]
        if self.lb.metrics is not None:
            self.lb.metrics.forwards.append(
                (self.lb.sim.now, self.lb.id, peer_id))
        self.lb.sim.after(self.lb.net.one_way(self.lb.region, peer.region),
                          lambda: peer.on_request(req))

    def steal_request(self, peer_id: str, n: int) -> None:
        victim = self.lb.remote_lbs[peer_id]
        lat = self.lb.net.one_way(self.lb.region, victim.region)
        self.lb.sim.after(lat, lambda: victim.on_steal_request(self.lb, n))

    def shed(self, req: Request) -> None:
        """LB-level deadline-aware admission refusal: resolve immediately
        with finish_reason "shed" — no replica ever sees the request."""
        if req.finished is None:
            resolve_cancelled(req, self.lb.sim.now, "shed")

    def pull_pages(self, req: Request, peer_id: str, target_id: str,
                   prefix_len: int, pull_tokens: int) -> None:
        """Pull-prefix: after the WAN round trip + KV bytes at bandwidth,
        install the prefix into the local replica's radix and deliver the
        request there. The sim models the transferred pages by injecting
        the token prefix directly (page_size=1: tokens are pages); the
        replica's next admission then matches them as device-cached.
        Optimistic in one way the real router is not: the peer's pages are
        assumed still resident at arrival (its trie said so one remote
        heartbeat ago)."""
        peer = self.lb.remote_lbs[peer_id]
        cost = self.lb.cfg.kv_params
        bytes_per = (cost.kv_bytes_per_token if cost is not None
                     else 131072.0)
        lat = self.lb.net.kv_transfer_s(self.lb.region, peer.region,
                                        pull_tokens * bytes_per)
        prefix = tuple(req.prompt_tokens)[:prefix_len]

        def _land() -> None:
            r = self.lb.replicas.get(target_id)
            if r is None or not r.alive:
                # target died while the pages were on the WAN: requeue
                self.lb.on_request(req)
                return
            if prefix:
                r.core.inject_prefix(prefix)
            r.enqueue(req)

        self.lb.sim.after(lat, _land)

    # ---- hedged dispatch (tail-TTFT insurance for the `latency` class)
    def hedge(self, req: Request, peer_id: str) -> None:
        """Duplicate `req` to a second region: a clone (fresh rid, no
        deadline, marked forwarded so it can't re-forward) races the
        primary, FIRST TOKEN WINS, and the loser is reaped through the
        exactly-once cancel path (the travelling `cancelled` flag covers
        a loser caught mid-WAN / mid-steal / mid-pull). If the clone wins,
        its stream and terminal state surface through the PRIMARY request
        object, so the frontend sees one rid-consistent lifecycle either
        way. The loser's burned compute (uncached prefill + decoded
        tokens) is charged to `RunMetrics.wasted_work_tok`."""
        peer = self.lb.remote_lbs[peer_id]
        clone = dataclasses.replace(
            req, rid=next(_HEDGE_RID), deadline_s=None, forwarded=True,
            arrival=0.0, origin_lb=None, ttft=None, finished=None,
            cached_tokens=0, replica=None, error=None, cancelled=None,
            finish_reason=None, admit_cb=None, token_cb=None, done_cb=None)
        m = self.lb.metrics
        if m is not None:
            m.hedged += 1
        orig_token = req.token_cb
        orig_done = req.done_cb
        state = {"winner": None}

        def decide(who: Request) -> None:
            if state["winner"] is not None:
                return
            state["winner"] = who
            if who is clone and m is not None:
                m.hedge_wins += 1
            self._reap_hedge_loser(req if who is clone else clone)

        def primary_token(r, tok, idx, t):
            decide(req)
            if state["winner"] is req:
                if orig_token is not None:
                    orig_token(req, tok, idx, t)
            elif m is not None:
                m.wasted_work_tok += 1

        def clone_token(r, tok, idx, t):
            decide(clone)
            if state["winner"] is clone:
                if orig_token is not None:
                    orig_token(req, tok, idx, t)
            elif m is not None:
                m.wasted_work_tok += 1

        def primary_done(r):
            if state["winner"] is None:
                decide(req)         # finished without a token (error path)
            if state["winner"] is req:
                if orig_done is not None:
                    orig_done(req)
            else:
                # the primary was reaped as the hedge loser; the clone's
                # completion surfaces through this object, so clear the
                # bogus terminal state the cancel path stamped on it
                req.finished = None
                req.finish_reason = None

        def clone_done(r):
            if state["winner"] is None:
                decide(clone)
            if state["winner"] is clone:
                req.ttft = clone.ttft
                req.finished = clone.finished
                req.cached_tokens = clone.cached_tokens
                req.replica = clone.replica
                req.error = clone.error
                req.finish_reason = clone.finish_reason
                if orig_done is not None:
                    orig_done(req)
            # clone lost: its cancel resolution ends here, exactly once

        req.token_cb, req.done_cb = primary_token, primary_done
        clone.token_cb, clone.done_cb = clone_token, clone_done
        self.lb.sim.after(self.lb.net.one_way(self.lb.region, peer.region),
                          lambda: peer.on_request(clone))

    def _reap_hedge_loser(self, loser: Request) -> None:
        """Cancel the losing leg wherever it is: some LB queue, some
        replica (pending/running/loading), or the WAN. The `cancelled`
        flag is set FIRST so a loser in flight (forward, steal handoff,
        pull-prefix landing) resolves itself at arrival."""
        loser.cancelled = "hedge"
        if loser.finished is not None:
            return
        lbs = [self.lb] + list(self.lb.remote_lbs.values())
        for lb in lbs:
            if lb.core.cancel(loser.rid):
                if loser.finished is None:
                    resolve_cancelled(loser, self.lb.sim.now)
                return
            for r in lb.replicas.values():
                seq = r.cancel(loser.rid)
                if seq is not None:
                    # compute the loser burned before the reap: uncached
                    # prefill (if it was admitted) + any decoded tokens —
                    # all spent, none delivered
                    if self.lb.metrics is not None:
                        waste = len(seq.out)
                        if seq.admit_index >= 0:
                            waste += max(0, seq.prompt_len
                                         - seq.req.cached_tokens)
                        self.lb.metrics.wasted_work_tok += waste
                    return


class LoadBalancerSim:
    """Simulator host for the shared `repro.routing.RoutingCore`: schedules
    heartbeat probes as discrete events, builds TargetViews from live
    ReplicaSims / peer LBs, and moves requests over the simulated WAN.
    All routing DECISIONS (eligibility, two-layer dispatch, optimism
    accounting, stealing) live in the core — shared with the real-engine
    `InProcessRouter`."""

    def __init__(self, sim: Sim, lid: str, region: str, net: Network,
                 policy: Policy, remote_policy: Optional[Policy] = None,
                 cfg: Optional[LBConfig] = None, metrics=None):
        self.sim = sim
        self.id = lid
        self.region = region
        self.net = net
        self.policy = policy
        self.remote_policy = remote_policy
        # copy: a caller-held (or default) config instance must never be
        # shared mutable state between LBs
        self.cfg = dataclasses.replace(cfg) if cfg is not None else LBConfig()
        self.replicas: dict[str, ReplicaSim] = {}
        self.remote_lbs: dict[str, "LoadBalancerSim"] = {}
        self.alive = True
        self.metrics = metrics
        self.core = RoutingCore(lid, policy, remote_policy, self.cfg,
                                _SimTransport(self))
        # heartbeat chains die while the LB is dead; each revive() bumps the
        # epoch so stale chains can't double-fire after recovery
        self._hb_epoch = 0
        self._start_probes()

    def _start_probes(self) -> None:
        epoch = self._hb_epoch
        self.sim.after(0.0, lambda: self._probe(epoch))
        self.sim.after(0.0, lambda: self._probe_remote(epoch))

    def revive(self) -> None:
        """Bring a dead LB back: restart the heartbeat loops (they exited
        while alive was False, so flipping the flag alone leaves snapshots
        permanently stale)."""
        self.alive = True
        self._hb_epoch += 1
        self._start_probes()

    # ---- routing state lives in the core
    @property
    def queue(self) -> deque:
        return self.core.queue

    @property
    def forwarded_out(self) -> int:
        return self.core.forwarded_out

    @property
    def peak_queue(self) -> int:
        return self.core.peak_queue

    # ---- topology
    def add_replica(self, r: ReplicaSim) -> None:
        self.replicas[r.id] = r
        self.core.target_added(self._view_of(r))

    def remove_replica(self, rid: str) -> Optional[ReplicaSim]:
        """Idempotent: routing state (prefix-trie records, hashring vnodes,
        probe snapshot) is forgotten exactly once, on the removal that
        actually owned the replica — repeated removals are no-ops."""
        r = self.replicas.pop(rid, None)
        if r is not None:
            self.core.target_removed(rid)
        return r

    def peer(self, lb: "LoadBalancerSim") -> None:
        if lb.id != self.id:
            self.remote_lbs[lb.id] = lb
            self.core.peer_added(lb.id)

    # ---- availability monitor (Alg.1 MonitorAvailability)
    def _view_of(self, r: ReplicaSim) -> TargetView:
        return TargetView(id=r.id, outstanding=r.outstanding(),
                          pending=r.pending_count(),
                          available=r.pending_count() == 0 and r.alive,
                          tenant_counters=(r.core.tenant_counters() or None
                                           if self.cfg.fairness else None))

    def n_avail_replicas(self) -> int:
        return sum(1 for r in self.replicas.values()
                   if r.pending_count() == 0 and r.alive)

    def _probe(self, epoch: int = 0) -> None:
        if not self.alive or epoch != self._hb_epoch:
            return
        self.core.refresh_local(
            [self._view_of(r) for r in self.replicas.values()])
        self.core.maybe_steal()
        self.sim.after(self.cfg.probe_interval, lambda: self._probe(epoch))

    def _probe_remote(self, epoch: int = 0) -> None:
        """WAN heartbeat: refresh peer-LB snapshots (slower than local)."""
        if not self.alive or epoch != self._hb_epoch:
            return
        self.core.refresh_remote([
            TargetView(
                id=lid, available=True,
                n_avail_replicas=lb.n_avail_replicas(),
                n_replicas=len(lb.replicas),
                queue_len=len(lb.queue),
                outstanding=sum(x.outstanding()
                                for x in lb.replicas.values()),
                tenant_counters=lb.core.tenant_snapshot())
            if lb.alive else TargetView.unavailable(lid)
            for lid, lb in self.remote_lbs.items()])
        self.sim.after(self.cfg.remote_probe_interval,
                       lambda: self._probe_remote(epoch))

    # ---- work stealing (beyond-paper; receiver-initiated rebalancing)
    def on_steal_request(self, thief: "LoadBalancerSim", n: int) -> None:
        if not self.alive:
            return
        lat = self.net.one_way(self.region, thief.region)
        for req in self.core.release_for_steal(n, thief.id):
            if self.metrics is not None:
                self.metrics.forwards.append((self.sim.now, self.id,
                                              f"steal->{thief.id}"))
            self.sim.after(lat, lambda q=req: thief.on_request(q))

    # ---- request path (Alg.1 HandleRequest)
    def on_request(self, req: Request) -> None:
        if req.cancelled is not None:
            # cancel raced the request onto the WAN (forward / steal /
            # failover handoff): resolve at arrival, exactly once
            if req.finished is None:
                resolve_cancelled(req, self.sim.now)
            return
        if req.arrival == 0.0:
            req.arrival = self.sim.now
        if req.origin_lb is None:
            req.origin_lb = self.id
        self.core.on_request(req)


# ------------------------------------------------------------------ controller

class Controller:
    """Centralized controller (§4.2): health-probes LBs, reassigns a dead
    LB's replicas to the geographically closest live LB, returns them on
    recovery; demotes stragglers."""

    def __init__(self, sim: Sim, net: Network, lbs: list[LoadBalancerSim],
                 probe_interval: float = 0.2):
        self.sim = sim
        self.net = net
        self.lbs = {lb.id: lb for lb in lbs}
        self.probe_interval = probe_interval
        self.tracker = FailoverTracker()
        self.events: list[tuple[float, str]] = []
        sim.after(probe_interval, self._probe)

    def _closest_live(self, region: str) -> Optional[LoadBalancerSim]:
        live = [lb for lb in self.lbs.values() if lb.alive]
        if not live:
            return None
        return min(live, key=lambda lb: self.net.one_way(region, lb.region))

    def _probe(self) -> None:
        for lb in self.lbs.values():
            if self.tracker.needs_failover(lb.id, lb.alive):
                self._failover(lb)
            elif self.tracker.needs_restore(lb.id, lb.alive):
                self._restore(lb)
        self.sim.after(self.probe_interval, self._probe)

    def _failover(self, dead: LoadBalancerSim) -> None:
        host = self._closest_live(dead.region)
        if host is None:
            return
        self.tracker.record_failover(dead.id, list(dead.replicas.items()))
        for rid in list(dead.replicas):
            r = dead.remove_replica(rid)
            if r is not None:
                host.add_replica(r)
        # drain the dead LB's queue to the host as well
        while dead.queue:
            req = dead.queue.popleft()
            self.sim.after(self.net.one_way(dead.region, host.region),
                           lambda q=req: host.on_request(q))
        self.events.append((self.sim.now, f"failover {dead.id} -> {host.id}"))

    def _restore(self, lb: LoadBalancerSim) -> None:
        """Reclaim the replicas whose HOME this LB is, from wherever
        cascading failovers moved them since."""
        for rid, r in self.tracker.reclaimable(lb.id):
            owner = next((x for x in self.lbs.values()
                          if rid in x.replicas), None)
            if owner is None or owner is lb:   # removed meanwhile / already home
                continue
            owner.remove_replica(rid)
            lb.add_replica(r)
        self.tracker.mark_restored(lb.id)
        self.events.append((self.sim.now, f"restore {lb.id}"))

    def fail_lb(self, lbid: str) -> None:
        self.lbs[lbid].alive = False

    def recover_lb(self, lbid: str) -> None:
        self.lbs[lbid].revive()

    def mark_straggler(self, replica: ReplicaSim, factor: float) -> None:
        replica.cfg.speed_factor = factor
