# Copy of src/repro/routing/core.py (no import of the JAX package).
"""Transport-agnostic routing brain (paper §3.2-§3.3, Alg. 1).

One `RoutingCore` per load balancer holds everything that makes SkyLB's
decisions: heartbeat snapshots of local replicas and peer LBs, pushing-mode
eligibility, the two-layer dispatch loop, snapshot-optimism accounting
between probes (`max_inflight_per_probe`), cross-region forwarding, and
receiver-initiated work stealing.  What it deliberately does NOT know is how
requests move or time passes — that lives behind the `Transport` protocol,
so the discrete-event simulator (`repro.core.simulator.LoadBalancerSim`) and
the real-engine router (`repro.serving.router.InProcessRouter`) run the
byte-identical decision procedure over different substrates.

Hosts drive the core through four entry points:

  on_request(req)        a request arrives at this LB (local client, a
                         peer's forward, or a stolen request)
  refresh_local(views)   a heartbeat probe of local replicas completed
  refresh_remote(views)  a WAN heartbeat of peer LBs completed
  maybe_steal()          after a local probe, consider pulling peer work

Requests only need `rid` plus a writable `forwarded` attribute slot (both
the simulator's `Request` and the engine's `GenRequest` qualify); policies
additionally read `session_key` / `prompt_tokens`.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Protocol, Sequence, runtime_checkable

from repro_torch.routing.hedging import HedgeParams, should_hedge
from repro_torch.routing.kvtransfer import (PULL, PUSH, RECOMPUTE, KVTransferParams,
                                      decide)
from repro_torch.routing.policies import SP_P, Policy, TargetView, eligible
from repro_torch.serving.request import slo_priority
from repro_torch.tenancy.admission import (DEFAULT_ADMISSION, AdmissionParams,
                                     should_shed)
from repro_torch.tenancy.discipline import tenant_of, tenant_weight_of
from repro_torch.tenancy.ledger import TenantLedger


@runtime_checkable
class Transport(Protocol):
    """How a RoutingCore's decisions reach the world.

    Implementations own latency (WAN one-way delays, tick queues, zero),
    liveness, and the clock; the core owns the decisions.
    """

    def now(self) -> float:
        """Current time (simulated seconds, ticks — any monotonic unit)."""
        ...

    def target_alive(self, target_id: str) -> bool:
        """Is this local replica/engine currently usable?"""
        ...

    def peer_alive(self, peer_id: str) -> bool:
        """Is this peer LB currently usable?"""
        ...

    def deliver(self, req, target_id: str) -> None:
        """Hand `req` to a local replica/engine (transport adds latency)."""
        ...

    def forward(self, req, peer_id: str) -> None:
        """Hand `req` to a peer LB (transport adds WAN latency)."""
        ...

    def steal_request(self, peer_id: str, n: int) -> None:
        """Ask a peer LB to release up to n queued requests to us."""
        ...

    def pull_pages(self, req, peer_id: str, target_id: str,
                   prefix_len: int, pull_tokens: int) -> None:
        """Fetch the KV for `req`'s first `prefix_len` prompt tokens from
        `peer_id`'s region (only ~pull_tokens of them actually cross the
        WAN — the rest are already local) and deliver `req` to local
        `target_id` once the pages land (transport adds the WAN round trip
        + bytes/bandwidth latency)."""
        ...


@dataclasses.dataclass
class RoutingConfig:
    pushing: str = SP_P             # BP | SP-O | SP-P
    spo_limit: int = 24
    tau: int = 4                    # remote-forward queue buffer
    probe_interval: float = 0.05
    # cross-region heartbeats ride the WAN: they are refreshed slower than
    # local probes (>= one RTT; the paper's regions are 140-200 ms apart)
    remote_probe_interval: float = 0.2
    cross_region: bool = True       # two-layer forwarding enabled
    # SP-P optimism bound: between heartbeats the LB may send at most this
    # many requests to a replica last seen with an empty pending queue.
    # Alg. 1 is unbounded between probes (availability only refreshes at
    # heartbeats), so the default is high — a backstop, not a throttle;
    # lowering it trades burst absorption for stricter queue control.
    max_inflight_per_probe: int = 64
    # BEYOND-PAPER work stealing (paper §6 cites stealing > shedding for
    # CPU loads): an idle LB PULLS from the most-backlogged peer instead of
    # waiting for that peer to push. Complements SP-P forwarding, which is
    # sender-initiated (shedding-style).
    work_stealing: bool = False
    steal_threshold: int = 4        # only steal from queues deeper than this
    steal_batch: int = 2            # requests pulled per steal
    # BEYOND-PAPER cross-region KV-page transfer: on a strong remote prefix
    # hit, weigh pulling the KV pages over the WAN (serve locally) against
    # pushing the request (forward, the paper's only option) against plain
    # local recompute, via repro.routing.kvtransfer.decide. Needs prefix-
    # aware local AND remote policies (their tries estimate hit lengths).
    kv_transfer: bool = False
    kv_params: Optional[KVTransferParams] = None    # default params if None
    # BEYOND-PAPER hedged dispatch: duplicate a `latency`-class request to a
    # second region when the chosen replica's predicted TTFT blows the
    # request's budget (repro.routing.hedging). First token wins; the
    # transport reaps the loser through the exactly-once cancel path.
    hedging: bool = False
    hedge_params: Optional[HedgeParams] = None      # default params if None
    # Multi-tenant fairness (repro.tenancy): per-tenant service counters
    # folded into dispatch/steal scoring, carried in heartbeats so every LB
    # converges on the same view. A HEAVY tenant (counter > factor * mean)
    # loses its cache-affinity preference — it is routed least-load — and
    # its queued work is released to thieves first.
    fairness: bool = False
    fairness_factor: float = 2.0
    # SLO lanes: `slo_class`es with positive priority ("interactive",
    # "latency") enqueue in a fast-lane PREFIX of the queue (FCFS within a
    # lane); off by default — plain FCFS, byte-identical to pre-tenancy.
    slo_lanes: bool = False
    # Deadline-aware admission shedding at the LB: when the chosen
    # replica's snapshot-predicted TTFT already exceeds the head request's
    # deadline, resolve it as FinishReason.SHED instead of dispatching
    # (repro.tenancy.admission; transports without a `shed` method opt out).
    admission: bool = False
    admission_params: Optional[AdmissionParams] = None  # None = defaults
    # Record ("local"|"forward"|"steal"|"pull", rid, target) tuples for
    # parity tests / tracing. Off by default (unbounded list).
    record_decisions: bool = False


class RoutingCore:
    """The single implementation of SkyLB eligibility + two-layer dispatch."""

    def __init__(self, lb_id: str, policy: Policy,
                 remote_policy: Optional[Policy] = None,
                 cfg: Optional[RoutingConfig] = None,
                 transport: Optional[Transport] = None):
        if transport is None:
            raise ValueError("RoutingCore requires a Transport")
        self.id = lb_id
        self.policy = policy
        self.remote_policy = remote_policy
        self.cfg = cfg if cfg is not None else RoutingConfig()
        self.transport = transport
        self.queue: deque = deque()
        # probe snapshots (stale between probes — like real heartbeats)
        self._replica_snap: dict[str, TargetView] = {}
        self._lb_snap: dict[str, TargetView] = {}
        self._sent_since_probe: dict[str, int] = {}
        self.forwarded_out = 0
        self.peak_queue = 0
        # KV-transfer accounting (all zero with kv_transfer off)
        self.kv_decisions = {PULL: 0, PUSH: 0, RECOMPUTE: 0}
        self.pulled_tokens = 0
        self.hedges = 0
        # per-tenant EXPECTED service (prompt + output budget per dispatch),
        # max-merged with peers' heartbeat snapshots (repro.tenancy.ledger)
        self.tenants = TenantLedger()
        self.sheds = 0
        self.decisions: Optional[list[tuple]] = (
            [] if self.cfg.record_decisions else None)

    # ---- topology
    def target_added(self, view: TargetView) -> None:
        """A local replica joined (fresh view, routable before next probe)."""
        self.policy.on_target_added(view.id)
        self._replica_snap[view.id] = view

    def target_removed(self, target_id: str) -> None:
        self.policy.on_target_removed(target_id)
        self._replica_snap.pop(target_id, None)

    def peer_added(self, peer_id: str) -> None:
        if self.remote_policy is not None:
            self.remote_policy.on_target_added(peer_id)

    # ---- availability monitor (Alg.1 MonitorAvailability)
    def refresh_local(self, views: Sequence[TargetView]) -> None:
        """A local heartbeat completed: replace snapshots, reset the
        between-probe optimism budget, and drain what became routable."""
        self._sent_since_probe.clear()
        for v in views:
            self._replica_snap[v.id] = v
            if self.cfg.fairness:
                # replica-side VTC counters (tokens actually served) fold
                # into the router's expected-service ledger via max-merge
                self.tenants.merge(v.tenant_counters)
        self.try_dispatch()

    def refresh_remote(self, views: Sequence[TargetView]) -> None:
        """A WAN heartbeat of peer LBs completed."""
        for v in views:
            self._lb_snap[v.id] = v
            if self.cfg.fairness:
                self.tenants.merge(v.tenant_counters)
        self.try_dispatch()

    def tenant_snapshot(self) -> Optional[dict]:
        """This LB's ledger for heartbeat publication (None when fairness
        is off — keeps wire frames lean and old peers decodable)."""
        return self.tenants.snapshot() if self.cfg.fairness else None

    def n_avail_local(self) -> int:
        return sum(1 for v in self._replica_snap.values()
                   if v.available and self.transport.target_alive(v.id))

    # ---- request path (Alg.1 HandleRequest)
    def on_request(self, req) -> None:
        if (self.cfg.slo_lanes
                and slo_priority(getattr(req, "slo_class", "standard")) > 0):
            # fast lane: join behind other fast-class work but ahead of the
            # slow lane (the queue's invariant is fast-prefix-then-slow, so
            # the insertion point is the end of the fast prefix)
            pos = 0
            for q in self.queue:
                if slo_priority(getattr(q, "slo_class", "standard")) <= 0:
                    break
                pos += 1
            self.queue.insert(pos, req)
        else:
            self.queue.append(req)
        self.peak_queue = max(self.peak_queue, len(self.queue))
        self.try_dispatch()

    # ---- cancellation
    def cancel(self, rid):
        """Pull a still-queued request out of the FCFS queue. Returns the
        request (the host resolves it as cancelled) or None if it already
        left this LB — dispatched to a replica, forwarded, released to a
        thief, or on the WAN. For those, the host sets `req.cancelled` and
        the next host to see the request resolves it exactly once (there is
        ONE request object, so a cancel racing a steal can't double-fire)."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                if self.decisions is not None:
                    self.decisions.append(("cancel", rid, self.id))
                return req
        return None

    def _local_views(self) -> list[TargetView]:
        return [v for v in self._replica_snap.values()
                if self.transport.target_alive(v.id)]

    def try_dispatch(self) -> None:
        """Two-layer dispatch: drain the FCFS queue head while some local
        replica is eligible; else forward the head once across regions;
        else the head waits for capacity (later arrivals wait behind it)."""
        cfg = self.cfg
        while self.queue:
            req = self.queue[0]
            local_views = self._local_views()
            locals_ok = eligible(local_views, cfg.pushing,
                                 cfg.spo_limit, cfg.tau)
            if locals_ok:
                heavy = (cfg.fairness and self.tenants.is_heavy(
                    tenant_of(req), cfg.fairness_factor))
                if heavy:
                    # a heavy tenant's cache affinity stops overriding
                    # regional fairness: route least-load, not by prefix
                    tid = min(locals_ok,
                              key=lambda v: (v.outstanding, v.id)).id
                    if self.decisions is not None:
                        self.decisions.append(("fair", req.rid,
                                               tenant_of(req)))
                else:
                    tid = self.policy.select(req, locals_ok)
                if tid is None or not any(v.id == tid for v in locals_ok):
                    # a policy may answer from its own state (trie records,
                    # hashring) that still names a target removed between
                    # probes — never dispatch outside the eligible set
                    tid = locals_ok[0].id
                if cfg.admission and self._should_shed(req, tid):
                    self.queue.popleft()
                    self._shed(req)
                    continue
                # a heavy tenant also forfeits the KV-pull privilege — a
                # WAN page transfer is exactly the locality subsidy being
                # withdrawn
                act = None if heavy else self._kv_consult(req, locals_ok)
                if act is not None:
                    kind, peer, pull_spec = act
                    self.queue.popleft()
                    if kind == PULL:
                        self._send_pull(req, peer, tid, *pull_spec)
                    else:                           # PUSH on a remote hit
                        self.kv_decisions[PUSH] += 1
                        self._forward(req, peer)
                    continue
                self.queue.popleft()
                self._send_local(req, tid)
                self._maybe_hedge(req, tid)
                continue
            # one WAN hop normally — but an LB that owns ZERO live targets
            # (elastic scale-to-zero, region outage) can never serve the
            # head itself, so already-forwarded work may hop again rather
            # than head-of-line-block the queue forever
            reforward = bool(getattr(req, "forwarded", False))
            if (cfg.cross_region and self._lb_snap
                    and self.remote_policy is not None
                    and (not reforward or not local_views)):
                remotes_ok = eligible(list(self._lb_snap.values()),
                                      cfg.pushing, cfg.spo_limit, cfg.tau)
                remotes_ok = [v for v in remotes_ok
                              if self.transport.peer_alive(v.id)]
                if reforward:
                    # a re-forward must land where replicas EXIST (busy is
                    # fine — n_replicas, not the idle n_avail_replicas
                    # count), or two emptied regions could ping-pong it
                    # indefinitely under BP/SP-O eligibility
                    remotes_ok = [v for v in remotes_ok
                                  if v.n_replicas > 0]
                if remotes_ok:
                    lbid = self.remote_policy.select(req, remotes_ok)
                    if (lbid is not None
                            and not any(v.id == lbid for v in remotes_ok)):
                        lbid = remotes_ok[0].id     # same stale-state guard
                    if lbid is not None:
                        self.queue.popleft()
                        self._forward(req, lbid)
                        continue
            break   # head-of-line waits for capacity

    def _kv_consult(self, req, locals_ok) -> Optional[tuple]:
        """Bytes-vs-recompute consult for the head request. Returns
        (PULL, peer_id, pulled_tokens) or (PUSH, peer_id, 0) when moving KV
        or the request beats local recompute; None to serve locally as
        usual. Hit lengths come from the policies' PREFIX TRIES — the same
        state both hosts replicate deterministically — never from clocks or
        queue depths, so decisions are parity-safe."""
        cfg = self.cfg
        if not cfg.kv_transfer or getattr(req, "forwarded", False):
            return None
        ltree = getattr(self.policy, "tree", None)
        rtree = getattr(self.remote_policy, "tree", None)
        if ltree is None or rtree is None or not self._lb_snap:
            return None
        prompt = tuple(getattr(req, "prompt_tokens", ()) or ())
        if not prompt:
            return None
        local_hit, _ = ltree.match(prompt, [v.id for v in locals_ok])
        peers = [pid for pid, v in self._lb_snap.items()
                 if v.n_replicas > 0 and self.transport.peer_alive(pid)]
        remote_hit, peer = rtree.match(prompt, peers)
        if peer is None or remote_hit <= local_hit:
            return None
        params = cfg.kv_params if cfg.kv_params is not None \
            else KVTransferParams()
        choice, costs = decide(len(prompt), local_hit, remote_hit, params)
        if choice == PULL:
            return PULL, peer, (remote_hit, int(costs["pulled_tokens"]))
        if choice == PUSH:
            return PUSH, peer, None
        self.kv_decisions[RECOMPUTE] += 1
        return None

    def _should_shed(self, req, tid: str) -> bool:
        """Deadline-aware admission verdict for the head request against
        the chosen replica's snapshot (pure: queue depths + prompt length +
        deadline — parity-safe across hosts)."""
        snap = self._replica_snap.get(tid)
        if snap is None:
            return False
        params = (self.cfg.admission_params
                  if self.cfg.admission_params is not None
                  else DEFAULT_ADMISSION)
        return should_shed(len(getattr(req, "prompt_tokens", ()) or ()),
                           snap.pending, snap.outstanding,
                           getattr(req, "deadline_s", None), params)

    def _shed(self, req) -> None:
        """Resolve a shed request through the transport (FinishReason.SHED
        at the host). Transports without a `shed` method opt out — the
        request is dropped from the queue either way, so fixtures just see
        the decision record."""
        self.sheds += 1
        if self.decisions is not None:
            self.decisions.append(("shed", req.rid, self.id))
        shed_fn = getattr(self.transport, "shed", None)
        if shed_fn is not None:
            shed_fn(req)

    def _charge(self, req) -> None:
        """Charge the tenant the EXPECTED tokens of this dispatch (prompt +
        output budget). Coarser than the replica's exact VTC charge, but
        available at decision time and monotone — no refunds on cancel."""
        if not self.cfg.fairness:
            return
        sp = getattr(req, "sampling", None)
        budget = (sp.max_new_tokens if sp is not None
                  else getattr(req, "output_len", 0))
        prompt = getattr(req, "prompt_tokens", ()) or ()
        self.tenants.charge(tenant_of(req), len(prompt) + int(budget),
                            tenant_weight_of(req))

    def _send_pull(self, req, peer_id: str, tid: str, prefix_len: int,
                   pull_tokens: int) -> None:
        """Serve locally after pulling the prefix KV from `peer_id`'s
        region: the transport replays the remote pages into `tid`'s replica
        cache and delivers the request there after the WAN transfer."""
        self.policy.on_routed(req, tid)     # the prefix now lives HERE
        snap = self._replica_snap.get(tid)
        if snap:
            snap.pending += 1
            snap.outstanding += 1
            sent = self._sent_since_probe.get(tid, 0) + 1
            self._sent_since_probe[tid] = sent
            if sent >= self.cfg.max_inflight_per_probe:
                snap.available = False
        self.kv_decisions[PULL] += 1
        self.pulled_tokens += pull_tokens
        self._charge(req)
        if self.decisions is not None:
            self.decisions.append(("pull", req.rid, peer_id))
        self.transport.pull_pages(req, peer_id, tid, prefix_len, pull_tokens)

    def _send_local(self, req, rid: str) -> None:
        self.policy.on_routed(req, rid)
        # bump snapshot counts so least-load tie-breaks shift between probes;
        # availability refreshes at probes (Alg. 1), with optimistic sends
        # between heartbeats bounded by max_inflight_per_probe
        snap = self._replica_snap.get(rid)
        if snap:
            snap.pending += 1
            snap.outstanding += 1
            sent = self._sent_since_probe.get(rid, 0) + 1
            self._sent_since_probe[rid] = sent
            if sent >= self.cfg.max_inflight_per_probe:
                snap.available = False
        self._charge(req)
        if self.decisions is not None:
            self.decisions.append(("local", req.rid, rid))
        self.transport.deliver(req, rid)

    def _maybe_hedge(self, req, tid: str) -> None:
        """After a local send, consider duplicating a `latency`-class
        request to the healthiest remote region (pure snapshot rule in
        repro.routing.hedging). The transport owns the race: first token
        wins, the loser is cancelled exactly once. Transports without a
        `hedge` method (plain fixtures) silently opt out."""
        cfg = self.cfg
        if not cfg.hedging or not self._lb_snap:
            return
        hedge_fn = getattr(self.transport, "hedge", None)
        if hedge_fn is None:
            return
        snap = self._replica_snap.get(tid)
        if snap is None:
            return
        params = cfg.hedge_params if cfg.hedge_params is not None \
            else HedgeParams()
        if not should_hedge(req, snap, params):
            return
        # a hedge must land where replicas EXIST (busy is fine) — same
        # guard as re-forwarding, or it would bounce off an empty region
        peers = [v for v in self._lb_snap.values()
                 if v.n_replicas > 0 and self.transport.peer_alive(v.id)]
        if not peers:
            return
        peer = max(peers,
                   key=lambda v: (v.n_avail_replicas, -v.queue_len)).id
        self.hedges += 1
        if self.decisions is not None:
            self.decisions.append(("hedge", req.rid, peer))
        hedge_fn(req, peer)

    def _forward(self, req, lbid: str) -> None:
        req.forwarded = True
        self.forwarded_out += 1
        if self.remote_policy:
            self.remote_policy.on_routed(req, lbid)
        snap = self._lb_snap.get(lbid)
        if snap:
            snap.queue_len += 1
        if self.decisions is not None:
            self.decisions.append(("forward", req.rid, lbid))
        self.transport.forward(req, lbid)

    # ---- work stealing (beyond-paper; receiver-initiated rebalancing)
    def maybe_steal(self) -> None:
        """Idle here + deep queue there => pull work (one steal per probe)."""
        if not self.cfg.work_stealing:
            return
        if self.queue or self.n_avail_local() == 0 or not self._lb_snap:
            return
        # dead peers advertise sentinel (10**9) queue lengths; skip them or
        # one downed LB would monopolize (and void) every steal attempt
        victim = max((v for v in self._lb_snap.values()
                      if self.transport.peer_alive(v.id)),
                     key=lambda v: v.queue_len, default=None)
        if victim is None or victim.queue_len <= self.cfg.steal_threshold:
            return
        self.transport.steal_request(victim.id, self.cfg.steal_batch)

    def release_for_steal(self, n: int,
                          thief_id: Optional[str] = None) -> list:
        """A peer with idle capacity asks for up to n TAIL requests (the
        head keeps local FCFS fairness). Never re-steal forwarded work.
        Returns the released requests; the host delivers them.

        With fairness on, HEAVY tenants' queued work leaves first (tail-
        ward, head excluded): moving their backlog to the idle region both
        balances load and un-crowds the tenants they were starving."""
        out = []
        if self.cfg.fairness and len(self.queue) > self.cfg.steal_threshold:
            picks = []      # descending indices -> deletions stay valid
            for i in range(len(self.queue) - 1, 0, -1):
                if (len(picks) >= n or len(self.queue) - len(picks)
                        <= self.cfg.steal_threshold):
                    break
                req = self.queue[i]
                if getattr(req, "forwarded", False):
                    continue
                if self.tenants.is_heavy(tenant_of(req),
                                         self.cfg.fairness_factor):
                    picks.append(i)
            for i in picks:
                req = self.queue[i]
                del self.queue[i]
                req.forwarded = True
                self.forwarded_out += 1
                if self.decisions is not None:
                    self.decisions.append(("steal", req.rid, thief_id))
                out.append(req)
            n -= len(out)
        for _ in range(n):
            if len(self.queue) <= self.cfg.steal_threshold:
                break
            req = self.queue.pop()          # tail
            if getattr(req, "forwarded", False):
                self.queue.append(req)      # don't bounce; put it back
                break
            req.forwarded = True            # one WAN hop max, like _forward
            self.forwarded_out += 1
            if self.decisions is not None:
                self.decisions.append(("steal", req.rid, thief_id))
            out.append(req)
        return out
