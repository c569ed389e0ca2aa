# Copy of src/repro/plane/lb.py (no import of the JAX package), with one
# repair: `LBServer.__init__` rebuilds a `kv_params` override that
# arrives as a dict.
"""`LBProcess` — one region's load balancer in its own OS process.

Hosts exactly one `repro_torch.routing.RoutingCore` (byte-identical to
the one the simulator and the tick router run) over a `SocketTransport`.
The process owns:

    the accept loop      clients submit/cancel here; peer LBs and the
                         launcher's control channel attach here too
    heartbeat state      replica ``hb`` frames and peer ``rhb`` frames land
                         in freshness tables; the PROBE TIMERS feed them to
                         `core.refresh_local` / `core.refresh_remote` — so
                         the core sees the same stale-snapshot regime as on
                         every other transport, just against real clocks
    deadline ownership   the accepting LB stamps `arrival_s` on ITS clock
                         and keeps an absolute-expiry table for queued and
                         dispatched requests; expiry fires an explicit
                         ``cancel`` frame (replicas never judge deadlines —
                         the cross-process clock-skew rule in
                         repro_torch.plane.wire)
    in-flight tracking   every deliver is recorded; when a replica's
                         heartbeats go stale (kill -9) or its socket drops,
                         the LB removes the target and RE-DISPATCHES the
                         in-flight requests — the paper's failover path on
                         real PIDs
    the hedge race       clones raced to a peer region; first token wins,
                         the loser leg is reaped through the idempotent
                         cancel path, and the clone's stream/result are
                         re-keyed to the primary rid before reaching the
                         client
    KV pull relay        ``kvpull`` -> best local replica ``kvfetch`` ->
                         ``kvpages`` back to the requester; the requester
                         parks the request and attaches the payload to the
                         eventual deliver frame

Reply routing: token/admit/result frames carry the ORIGIN region (the LB
that accepted the request from a client).  A replica sends to its own LB;
an LB relays anything whose origin is not itself to that peer — so a
forwarded request's stream finds its way home across regions without
replicas ever dialing foreign LBs.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import Optional

from repro_torch.plane import wire
from repro_torch.plane.mailbox import Node
from repro_torch.plane.transport import SocketTransport
from repro_torch.routing import RoutingCore, TargetView, build_routing
from repro_torch.routing.kvtransfer import KVTransferParams
from repro_torch.serving.request import (GenRequest, GenResult,
                                         cancel_finish_reason)


@dataclasses.dataclass(frozen=True)
class LBSpec:
    """Everything an LB child needs, picklable for mp spawn."""
    region: str
    variant: str = "skylb"
    replicas: tuple = ()                # ((rid, [host, port]), ...)
    probe_interval_s: float = 0.05
    remote_probe_interval_s: float = 0.1
    stale_after_s: float = 0.4
    partition_grace_s: float = 0.4      # stale-but-connected peers get this
                                        # long for heartbeats to resume
    local_delay_ms: float = 0.0
    pull_timeout_s: float = 2.0
    resend_interval_s: float = 0.25     # unacked result/cancel retry pace
    cfg_overrides: tuple = ()           # (("max_inflight_per_probe", 2), ..)


class LBServer:
    """The event loop around one RoutingCore + SocketTransport."""

    def __init__(self, spec: LBSpec):
        self.spec = spec
        self.region = spec.region
        self.node = Node()
        rspec = build_routing(spec.variant)
        self.policy = rspec.local_policy()
        remote = rspec.remote_policy() if rspec.remote_policy else None
        # `ServingPlane.start` ships the spec through `dataclasses.asdict`,
        # which turns a `KVTransferParams` override into a plain dict:
        # rebuild it, or the first KV decision reads a dict's attributes
        cfg = rspec.make_config(**{
            k: (KVTransferParams(**v)
                if k == "kv_params" and isinstance(v, dict) else v)
            for k, v in dict(spec.cfg_overrides).items()})
        self.transport = SocketTransport(
            self.node, self.region, stale_after_s=spec.stale_after_s,
            partition_grace_s=spec.partition_grace_s,
            on_dispatch=self._track_dispatch, on_pull=self._park_pull,
            on_hedge=self._hedge_start, origin_of=self._origin_of)
        self.transport.on_forward = self._track_forward
        self.transport.gen_of = self._gen_of
        # admission-control shed: terminal SHED result from THIS LB (the
        # deadline owner); replicas never see the request
        self.transport.on_shed = (
            lambda req: self._resolve_front(req, "shed"))
        self.core = RoutingCore(self.region, self.policy, remote, cfg,
                                self.transport)
        self.running = True
        # ---- state tables
        self.hb_views: dict[str, dict] = {}       # replica -> latest view
        self.peer_views: dict[str, dict] = {}     # region -> latest rhb
        self.peers: dict[str, float] = {}         # region -> link delay_s
        self.inflight: dict[int, tuple] = {}      # rid -> (req, target)
        self.origin_map: dict[int, str] = {}      # rid -> origin region
        self.client_of: dict[int, object] = {}    # rid -> client Conn
        self.fwd_to: dict[int, str] = {}          # rid -> peer forwarded to
        self.expiry: dict[int, float] = {}        # rid -> abs deadline (my
                                                  # clock — I own it)
        self.pulls: dict[int, tuple] = {}         # rid -> (req, peer,
                                                  # target, plen, ptok, due)
        self.hedge_state: dict[int, dict] = {}    # primary rid -> race
        self.clone_of: dict[int, int] = {}        # clone rid -> primary rid
        self.known_replicas: set[str] = set()
        self.dead_targets: set[str] = set()
        self.events: list[tuple[float, str]] = []
        # ---- partition tolerance
        self.gen: dict[str, int] = {}             # target -> epoch; bumped
                                                  # on every _declare_dead
        self.seen_results: set[tuple] = set()     # (src, rid): hop-local
                                                  # dedupe of RESENT results
                                                  # (cross-source dups are
                                                  # the fence's job)
        self.unacked_results: dict[int, dict] = {}  # rid -> parked frame
        self.pending_cancels: dict[int, dict] = {}  # rid -> parked frame
        self.degraded = False                     # all peer links down
        # ---- counters
        self.issued = 0
        self.resolved = 0
        self.redispatched = 0
        self.hedge_wins = 0
        self.wasted_work_tok = 0
        self.fenced_frames = 0                    # zombie-generation drops
        self.dup_suppressed = 0                   # same-source retries
        self.send_drops = 0                       # frames lost to dead links
        self.kv_pull_timeouts = 0                 # pulls fallen to recompute
        self.degraded_transitions = 0
        self._t0 = time.monotonic()
        self._probe_due = 0.0
        self._rprobe_due = 0.0
        self._publish_due = 0.0
        self._sweep_due = 0.0
        self._resend_due = 0.0
        self._reattach_due = 0.0
        # dial local replicas (routable as soon as their heartbeats land;
        # seed freshness so the first dispatch needn't wait a full probe)
        for rid, addr in spec.replicas:
            self._add_replica(rid, addr)

    # ------------------------------------------------------------ topology
    def _add_replica(self, rid: str, addr) -> None:
        try:
            self.node.connect(addr, rid,
                              delay_s=self.spec.local_delay_ms / 1e3,
                              hello=wire.msg("attach", id=self.region,
                                             kind="lb"))
        except OSError:
            return          # already dead (e.g. adopting a killed region)
        self.transport.saw(rid)
        self.core.target_added(TargetView(id=rid))
        self.known_replicas.add(rid)
        self.dead_targets.discard(rid)

    def _dial_peers(self, peers: list[dict]) -> None:
        """Launcher control: the peer table. Only the lexicographically
        SMALLER region dials (one paced conn per pair; the acceptor learns
        the symmetric link delay from the hello)."""
        for p in peers:
            region, delay = p["region"], float(p.get("delay_ms", 0.0)) / 1e3
            if region == self.region:
                continue
            self.peers[region] = delay
            self.core.peer_added(region)
            if self.region < region and region not in self.node.by_id:
                self.node.connect(
                    p["addr"], region, delay_s=delay,
                    hello=wire.msg("hello", kind="lb", id=self.region,
                                   delay_ms=p.get("delay_ms", 0.0)))
            self.transport.saw(region)   # optimistic until first rhb lapse

    # --------------------------------------------------- transport hooks
    def _track_dispatch(self, req: GenRequest, target: str) -> None:
        self.inflight[req.rid] = (req, target)

    def _track_forward(self, req: GenRequest, peer: str) -> None:
        """Ownership transfers with the request: the receiving LB re-stamps
        arrival and owns the (remaining) deadline from its own clock."""
        self.fwd_to[req.rid] = peer
        self.expiry.pop(req.rid, None)

    def _origin_of(self, req: GenRequest) -> str:
        return self.origin_map.get(req.rid, self.region)

    def _gen_of(self, target: str) -> int:
        return self.gen.get(target, 1)

    def _park_pull(self, req: GenRequest, peer: str, target: str,
                   prefix_len: int, pull_tokens: int) -> None:
        self.pulls[req.rid] = (req, peer, target, prefix_len, pull_tokens,
                               time.monotonic() + self.spec.pull_timeout_s)

    def _hedge_start(self, clone: GenRequest, primary: GenRequest,
                     peer: str) -> None:
        self.hedge_state[primary.rid] = {"clone": clone.rid, "winner": None}
        self.clone_of[clone.rid] = primary.rid
        self.origin_map[clone.rid] = self.region

    # ------------------------------------------------------------ requests
    def _accept(self, req: GenRequest, origin: str,
                client_conn=None) -> None:
        """A request enters (or re-enters) THIS LB: stamp arrival on MY
        clock, take deadline ownership, queue into the core."""
        now = time.monotonic()
        req.arrival_s = now
        self.origin_map[req.rid] = origin
        if client_conn is not None:
            self.client_of[req.rid] = client_conn
        if req.cancelled is not None:
            # a cancel raced the request over the WAN — resolve at arrival
            self._resolve_front(req, req.cancelled)
            return
        if req.deadline_s is not None:
            if req.deadline_s <= 0:
                self._resolve_front(req, "deadline")
                return
            self.expiry[req.rid] = now + req.deadline_s
        self.core.on_request(req)

    def _resolve_front(self, req: GenRequest, reason: str) -> None:
        """Terminal result for a request that never reached a replica."""
        res = GenResult(
            rid=req.rid, output_tokens=(),
            finish_reason=cancel_finish_reason(reason), cached_tokens=0,
            prompt_len=len(req.prompt_tokens),
            e2e_s=(time.monotonic() - req.arrival_s
                   if req.arrival_s is not None else None))
        self._emit_result(wire.msg("result", res=wire.encode_result(res),
                                   origin=self.origin_map.get(
                                       req.rid, self.region)))

    # ----------------------------------------------------------- reply path
    def _route_back(self, m: dict) -> None:
        """Send a token/admit/result frame toward the request's origin."""
        origin = m.get("origin") or self.region
        if origin != self.region:
            if not self.node.send_to(origin, m):
                self.send_drops += 1
            return
        rid = m["rid"] if "rid" in m else m["res"]["rid"]
        conn = self.client_of.get(rid)
        if conn is not None and conn.alive:
            conn.send(m)
        elif m.get("t") in ("token", "admit"):
            self.send_drops += 1

    def _race(self, primary_rid: int, who: str) -> str:
        """First signal wins; reap the loser leg exactly once."""
        st = self.hedge_state.get(primary_rid)
        if st is None:
            return "primary"
        if st["winner"] is None:
            st["winner"] = who
            if who == "clone":
                self.hedge_wins += 1
                self._cancel_request(primary_rid, "cancelled")
            else:
                self._cancel_request(st["clone"], "cancelled")
        return st["winner"]

    def _on_token(self, m: dict) -> None:
        if m.get("origin") and m["origin"] != self.region:
            self.node.send_to(m["origin"], m)
            return
        rid = m["rid"]
        is_token = m.get("t") == "token"
        primary = self.clone_of.get(rid)
        if primary is not None:                       # a hedge clone's frame
            if not is_token:
                # admit: don't arbitrate the race (first TOKEN wins) and
                # don't count it as wasted work — relay re-keyed only if
                # the clone has already won
                st = self.hedge_state.get(primary)
                if st is not None and st["winner"] == "clone":
                    self._route_back(dict(m, rid=primary))
                return
            if self._race(primary, "clone") == "clone":
                m = dict(m, rid=primary)
                self._route_back(m)
            else:
                self.wasted_work_tok += 1
            return
        st = self.hedge_state.get(rid)
        if st is not None:
            if not is_token:
                # primary's admit: pass through unless the clone already won
                if st["winner"] != "clone":
                    self._route_back(m)
                return
            if self._race(rid, "primary") != "primary":
                self.wasted_work_tok += 1
                return
        self._route_back(m)

    def _on_result(self, m: dict) -> None:
        rid = m["res"]["rid"]
        # local bookkeeping happens at the LB that DISPATCHED the request
        self.inflight.pop(rid, None)
        self.expiry.pop(rid, None)
        self.pending_cancels.pop(rid, None)
        if m.get("origin") and m["origin"] != self.region:
            # relay hop toward the origin LB: results are required frames,
            # so park them for resend until the peer resacks
            self._send_reliable(m["origin"], m, rid)
            return
        primary = self.clone_of.get(rid)
        if primary is not None:                       # a hedge clone's result
            winner = self._race(primary, "clone")
            if winner == "clone":
                res = dict(m["res"], rid=primary)
                self._finish_hedge(primary)
                self._emit_result(wire.msg("result", res=res,
                                           origin=self.region))
            else:                                     # losing clone reaped
                self.wasted_work_tok += len(m["res"]["output_tokens"])
                self.clone_of.pop(rid, None)
            return
        st = self.hedge_state.get(rid)
        if st is not None:
            winner = self._race(rid, "primary")
            if winner != "primary":
                # losing primary's cancel-result: swallow; the clone's
                # completion (re-keyed to this rid) is the real terminal
                self.wasted_work_tok += len(m["res"]["output_tokens"])
                return
            self._finish_hedge(rid)
        self._emit_result(m)

    def _finish_hedge(self, primary_rid: int) -> None:
        st = self.hedge_state.pop(primary_rid, None)
        if st is not None:
            self.clone_of.pop(st["clone"], None)

    def _emit_result(self, m: dict) -> None:
        rid = m["res"]["rid"]
        self.resolved += 1
        self.pending_cancels.pop(rid, None)
        origin = m.get("origin") or self.region
        if origin != self.region:
            self._send_reliable(origin, m, rid)
        else:
            conn = self.client_of.get(rid)
            if conn is not None and conn.alive:
                conn.send(m)
                self.unacked_results[rid] = {
                    "dest": conn, "frame": m, "attempts": 0,
                    "due": time.monotonic() + self.spec.resend_interval_s}
            else:
                self.send_drops += 1
        self.client_of.pop(rid, None)
        self.origin_map.pop(rid, None)
        self.fwd_to.pop(rid, None)
        self.expiry.pop(rid, None)

    # ------------------------------------------------- reliable delivery
    def _send_reliable(self, dest_id: str, frame: dict, rid: int) -> None:
        """Send a required frame (result) and park it until a `resack`
        for `rid` comes back; `_resend_unacked` retries on the redialed
        conn after a link heals."""
        if not self.node.send_to(dest_id, frame):
            self.send_drops += 1
        self.unacked_results[rid] = {
            "dest": dest_id, "frame": frame, "attempts": 0,
            "due": time.monotonic() + self.spec.resend_interval_s}

    def _resend_unacked(self, now: float) -> None:
        for rid, ent in list(self.unacked_results.items()):
            if now < ent["due"]:
                continue
            ent["attempts"] += 1
            if ent["attempts"] > 40:           # ~10s: give up, count it
                del self.unacked_results[rid]
                self.send_drops += 1
                continue
            dest = ent["dest"]
            if isinstance(dest, str):
                ok = self.node.send_to(dest, ent["frame"])
            else:
                ok = bool(dest.alive and dest.send(ent["frame"]))
            if not ok:
                self.send_drops += 1
            ent["due"] = now + self.spec.resend_interval_s
        for rid, ent in list(self.pending_cancels.items()):
            if now < ent["due"]:
                continue
            ent["attempts"] += 1
            if ent["attempts"] > 40:
                del self.pending_cancels[rid]
                self.send_drops += 1
                continue
            if not self.node.send_to(ent["dest"], ent["frame"]):
                self.send_drops += 1
            ent["due"] = now + self.spec.resend_interval_s

    # ------------------------------------------------------------- cancel
    def _cancel_request(self, rid: int, reason: str,
                        relay: bool = True) -> None:
        got = self.core.cancel(rid)
        if got is not None:                       # still queued here
            self._resolve_front(got, reason)
            return
        if rid in self.pulls:                     # parked on a KV pull
            req, *_ = self.pulls.pop(rid)
            self._resolve_front(req, reason)
            return
        if rid in self.inflight:                  # at one of my replicas
            req, target = self.inflight[rid]
            req.cancelled = reason
            self._send_cancel(target, wire.msg("cancel", rid=rid,
                                               reason=reason))
            return
        peer = self.fwd_to.get(rid)
        if peer is not None and relay:            # forwarded: relay once
            self._send_cancel(peer, wire.msg("cancel", rid=rid,
                                             reason=reason, relay=False))

    def _send_cancel(self, dest_id: str, frame: dict) -> None:
        """Cancels are droppable-but-required: park for resend (cancel is
        idempotent per rid at the replica) until the rid's result clears
        the entry."""
        if not self.node.send_to(dest_id, frame):
            self.send_drops += 1
        self.pending_cancels[frame["rid"]] = {
            "dest": dest_id, "frame": frame, "attempts": 0,
            "due": time.monotonic() + self.spec.resend_interval_s}

    # ------------------------------------------------------------ failover
    def _declare_dead(self, rid_replica: str) -> None:
        if rid_replica in self.dead_targets \
                or rid_replica not in self.known_replicas:
            return
        self.dead_targets.add(rid_replica)
        # epoch bump: every frame the zombie sends for pre-death work now
        # fails the generation fence (discarded exactly once, with a
        # resack so resent terminals stop)
        self.gen[rid_replica] = self.gen.get(rid_replica, 1) + 1
        self.core.target_removed(rid_replica)
        self.transport.forget(rid_replica)
        self.hb_views.pop(rid_replica, None)
        self.node.drop(rid_replica)
        self.node.schedule_redial(rid_replica)    # heal path: redial +
                                                  # re-attach until hb resumes
        stranded = [(rid, req) for rid, (req, tgt) in self.inflight.items()
                    if tgt == rid_replica]
        for rid, req in stranded:
            self.inflight.pop(rid, None)
            self.redispatched += 1
            # progress restarts from zero on the new replica; the client
            # dedupes token events by index
            req.first_token_s = None
            req.cached_tokens = 0
            self.core.on_request(req)
        self.events.append((time.monotonic(),
                            f"failover {rid_replica} "
                            f"({len(stranded)} re-dispatched)"))

    # ------------------------------------------------------------ handlers
    def _fenced(self, conn, m: dict) -> bool:
        """Drop frames stamped with a pre-death generation (a healed
        zombie streaming for work that was already re-dispatched).  Fenced
        TERMINALS still get a resack so the zombie stops resending."""
        if conn.id is None or conn.id not in self.known_replicas:
            return False                  # fence applies at the dispatch hop
        g = m.get("gen")
        if g is None or g == self.gen.get(conn.id, 1):
            return False
        self.fenced_frames += 1
        if m.get("t") == "result":
            conn.send(wire.msg("resack", rid=m["res"]["rid"]))
        return True

    def handle(self, conn, m: dict) -> None:
        t = m.get("t")
        if t == "hb":
            self.transport.saw(m["id"])
            self.hb_views[m["id"]] = m["view"]
            if m["id"] in self.dead_targets:
                # a presumed-dead replica's heartbeats resumed (healed
                # partition or successful redial): revive it as a target;
                # its stale generation keeps zombie frames fenced
                self.dead_targets.discard(m["id"])
                self.known_replicas.add(m["id"])
                self.core.target_added(TargetView(**m["view"]))
                self.events.append((time.monotonic(),
                                    f"revived {m['id']}"))
        elif t == "rhb":
            self.transport.saw(m["id"])
            self.peer_views[m["id"]] = m["view"]
        elif t == "token" or t == "admit":
            if self._fenced(conn, m):
                return
            self._on_token(m)
        elif t == "result":
            if self._fenced(conn, m):
                return
            rid = m["res"]["rid"]
            conn.send(wire.msg("resack", rid=rid))   # ack the hop sender
            # hop-local dedupe of RESENT copies of one computation: the
            # key pins (source, rid, origin, generation) so a legitimate
            # re-computation of the same rid (re-homed after adoption:
            # new origin; re-dispatched after declare-dead: new gen) is
            # never mistaken for a resend
            key = (conn.id, rid, m.get("origin"), m.get("gen"))
            if key in self.seen_results:
                self.dup_suppressed += 1   # a resend crossed our resack
                return
            self.seen_results.add(key)
            self._on_result(m)
        elif t == "resack":
            self.unacked_results.pop(m["rid"], None)
        elif t == "ping":
            conn.send(wire.msg("pong", nonce=m.get("nonce"),
                               id=self.region))
        elif t == "chaos":
            target, fault = wire.decode_chaos(m)
            if target == "*":
                ids = {i for i in self.node.by_id if i != "ctl"}
                ids |= set(self.node.faults)         # heal covers all faults
                for i in ids:
                    self.node.set_fault(i, fault)
            else:
                self.node.set_fault(target, fault)
            self.events.append((time.monotonic(),
                                f"chaos {target}: "
                                f"{'heal' if fault is None else fault}"))
        elif t == "submit":
            req = wire.decode_request(m["req"])
            self.issued += 1
            self._accept(req, self.region, client_conn=conn)
        elif t == "forward":
            req = wire.decode_request(m["req"])
            self._accept(req, m.get("origin", self.region))
        elif t == "redispatch":
            req = wire.decode_request(m["req"])
            self.redispatched += 1
            self.origin_map[req.rid] = m.get("origin", self.region)
            # drop the stale inflight entry (the draining replica bounced
            # this back) so a later _declare_dead can't re-dispatch it twice
            self.inflight.pop(req.rid, None)
            self.core.on_request(req)
        elif t == "steal":
            for req in self.core.release_for_steal(m["n"], m["thief"]):
                # ownership transfers to the thief, same as _track_forward:
                # a later client cancel must relay there
                self.fwd_to[req.rid] = m["thief"]
                self.expiry.pop(req.rid, None)
                self.node.send_to(m["thief"], wire.msg(
                    "forward",
                    req=wire.encode_request(req, deadline=wire.REMAINING,
                                            now=time.monotonic()),
                    origin=self.origin_map.get(req.rid, self.region)))
        elif t == "cancel":
            self._cancel_request(m["rid"], m.get("reason", "cancelled"),
                                 relay=m.get("relay", True))
        elif t == "kvpull":
            self._serve_kvpull(m)
        elif t == "kvpages":
            self._kv_arrived(m)
        elif t == "hello":
            if conn.id is None:
                conn.id = m["id"]
            if m.get("kind") == "lb":
                if m["id"] not in self.node.by_id:
                    self.node.by_id[m["id"]] = conn
                conn.delay_s = float(m.get("delay_ms", 0.0)) / 1e3
                self.transport.saw(m["id"])
            else:
                self.node.by_id.setdefault(m["id"], conn)
        elif t == "peers":
            self._dial_peers(m["peers"])
        elif t == "adopt":
            for rid, addr in m["replicas"]:
                if rid not in self.node.by_id:
                    self._add_replica(rid, addr)
            self.events.append((time.monotonic(),
                                f"adopted {len(m['replicas'])} replicas"))
        elif t == "bye":
            if m.get("id"):
                self._declare_dead(m["id"])
        elif t == "metrics?":
            conn.send(wire.msg("metrics", id=f"lb:{self.region}",
                               data=self.snapshot()))
        elif t == "drain" or t == "shutdown":
            self.running = False
        elif t == "_lost":
            if conn.id and conn.id in self.known_replicas:
                self._declare_dead(conn.id)
            elif conn.id and conn.id in self.peers:
                # peer LB link dropped: if we were the dialer, redial with
                # backoff (the peer may be alive behind a transient fault)
                self.node.schedule_redial(conn.id)

    # ------------------------------------------------------------ KV pulls
    def _serve_kvpull(self, m: dict) -> None:
        """A peer wants our cached KV for a prefix: ask the best local
        replica (the policy trie knows who served it) to export."""
        tokens = tuple(m["tokens"])
        target = None
        tree = getattr(self.policy, "tree", None)
        live = [r for r in self.hb_views if self.transport.target_alive(r)]
        if tree is not None and live:
            _, target = tree.match(tokens, live)
        if target is None and live:
            target = live[0]
        if target is None:          # nothing alive: empty reply unblocks
            self.node.send_to(m["requester"], wire.msg(
                "kvpages", rid=m["rid"], requester=m["requester"],
                kv={"tokens": list(tokens), "n": 0}))
            return
        self.node.send_to(target, wire.msg(
            "kvfetch", rid=m["rid"], tokens=list(tokens),
            requester=m["requester"]))

    def _kv_arrived(self, m: dict) -> None:
        if m.get("requester") != self.region:      # relay leg (peer's LB)
            self.node.send_to(m["requester"], m)
            return
        parked = self.pulls.pop(m["rid"], None)
        if parked is None:
            return
        req, _peer, target, _plen, _ptok, _due = parked
        self._deliver_with_kv(req, target, m.get("kv"))

    def _deliver_with_kv(self, req: GenRequest, target: str,
                         kv: Optional[dict]) -> None:
        if not self.transport.target_alive(target):
            self.core.on_request(req)              # target died mid-pull
            return
        self._track_dispatch(req, target)
        d = wire.msg("deliver",
                     req=wire.encode_request(req, deadline=wire.STRIP),
                     origin=self._origin_of(req), gen=self._gen_of(target))
        if kv and kv.get("n", 0) > 0:
            d["kv"] = kv
        if not self.node.send_to(target, d):
            self.send_drops += 1

    # -------------------------------------------------------------- timers
    def _local_probe(self) -> None:
        views = [TargetView(**self.hb_views[r]) for r in self.hb_views
                 if self.transport.target_alive(r)]
        self.core.refresh_local(views)
        self.core.maybe_steal()

    def _remote_probe(self) -> None:
        views = []
        for p in self.peers:
            if self.transport.peer_alive(p) and p in self.peer_views:
                views.append(TargetView(**self.peer_views[p]))
            else:
                views.append(TargetView.unavailable(p))
        if views:
            self.core.refresh_remote(views)

    def _publish_remote(self) -> None:
        live = [r for r in self.hb_views
                if self.transport.target_alive(r)]
        view = {
            "id": self.region,
            "n_avail_replicas": sum(
                1 for r in live if self.hb_views[r].get("available")),
            "n_replicas": len(live),
            "queue_len": len(self.core.queue),
            "outstanding": sum(self.hb_views[r].get("outstanding", 0)
                               for r in live),
        }
        tc = self.core.tenant_snapshot()
        if tc:
            view["tenant_counters"] = tc
        for p in self.peers:
            self.node.send_to(p, wire.msg("rhb", id=self.region, view=view))

    def _sweep(self) -> None:
        now = time.monotonic()
        # deadlines I own (queued or dispatched here), on MY clock only
        for rid in [r for r, due in self.expiry.items() if now > due]:
            self.expiry.pop(rid, None)
            self._cancel_request(rid, "deadline")
        # presumed-dead replicas -> failover.  EOF + stale is a dead
        # process (no grace); stale-but-connected gets partition_grace_s
        # for heartbeats to resume before inflight work is re-dispatched.
        # Checked over KNOWN replicas, not hb_views: a replica whose link
        # faulted before its first heartbeat landed must still be
        # declarable (its freshness was seeded at dial time).
        for r in list(self.known_replicas):
            if r not in self.dead_targets and self.transport.presumed_dead(r):
                self._declare_dead(r)
        # KV pulls: a pull parked on a DEAD peer link aborts to recompute
        # immediately; a timed-out pull falls back the same way instead of
        # wedging the request
        for rid, p in list(self.pulls.items()):
            _req, peer, _target, _plen, _ptok, due = p
            if now > due or not self.transport.peer_alive(peer):
                req, _peer, target, _plen, _ptok, _due = self.pulls.pop(rid)
                self.kv_pull_timeouts += 1
                self._deliver_with_kv(req, target, None)
        # degraded mode: all peer links down -> serve local-only (the core
        # already filters peers by liveness; this makes the state explicit)
        if self.peers:
            degraded = not any(self.transport.peer_alive(p)
                               for p in self.peers)
            if degraded != self.degraded:
                self.degraded = degraded
                self.degraded_transitions += 1
                self.events.append((now, "degraded: serving local-only"
                                    if degraded else "degraded: recovered"))
        # reconnect machinery: due redials, then re-attach nudges for
        # dead-but-connected replicas (their attach hello may have been
        # blackholed; resend until heartbeats resume)
        self.node.maybe_redial(now)
        if now >= self._reattach_due:
            self._reattach_due = now + 0.5
            for r in list(self.dead_targets):
                c = self.node.by_id.get(r)
                if c is not None and c.alive:
                    c.send(wire.msg("attach", id=self.region, kind="lb"))
        # unacked required frames (results, cancels)
        if now >= self._resend_due:
            self._resend_due = now + self.spec.resend_interval_s
            self._resend_unacked(now)

    # ------------------------------------------------------------- metrics
    def snapshot(self) -> dict:
        return {
            "kind": "lb", "id": self.region, "pid": os.getpid(),
            "uptime_s": time.monotonic() - self._t0,
            "issued": self.issued, "resolved": self.resolved,
            "queue_len": len(self.core.queue),
            "inflight": len(self.inflight),
            "forwarded_out": self.core.forwarded_out,
            "peak_queue": self.core.peak_queue,
            "redispatched": self.redispatched,
            "hedged": self.core.hedges, "hedge_wins": self.hedge_wins,
            "sheds": self.core.sheds,
            "wasted_work_tok": self.wasted_work_tok,
            "kv_decisions": dict(self.core.kv_decisions),
            "pulled_tokens": self.core.pulled_tokens,
            "fenced_frames": self.fenced_frames,
            "dup_suppressed": self.dup_suppressed,
            "send_drops": self.send_drops,
            "kv_pull_timeouts": self.kv_pull_timeouts,
            "degraded_transitions": self.degraded_transitions,
            "degraded": self.degraded,
            "reconnects": self.node.reconnects,
            "fault_dropped_send": self.node.fault_dropped_send,
            "fault_dropped_recv": self.node.fault_dropped_recv,
            "unacked_results": len(self.unacked_results),
            "events": [e for _, e in self.events],
        }

    # ----------------------------------------------------------------- run
    def run(self) -> None:
        sp = self.spec
        while self.running:
            got = self.node.poll(0.005)
            if got is not None:
                self.handle(*got)
                # budget gates the POLL, not the handle: a dequeued frame
                # is always handled, never dropped on budget exhaustion
                for _ in range(127):
                    got = self.node.poll(0.0)
                    if got is None:
                        break
                    self.handle(*got)
            now = time.monotonic()
            if now >= self._probe_due:
                self._local_probe()
                self._probe_due = now + sp.probe_interval_s
            if now >= self._rprobe_due:
                self._remote_probe()
                self._rprobe_due = now + sp.remote_probe_interval_s
            if now >= self._publish_due:
                self._publish_remote()
                self._publish_due = now + sp.remote_probe_interval_s
            if now >= self._sweep_due:
                self._sweep()
                self._sweep_due = now + min(0.05, sp.probe_interval_s)
        for conn in self.node.conns:
            if conn.alive and conn.id:
                conn.send(wire.msg("bye", id=f"lb:{self.region}",
                                   metrics=self.snapshot()))
        time.sleep(0.05)                       # let the pacer flush
        self.node.close()


def lb_main(spec_dict: dict, ready) -> None:
    """Child-process entry (mp spawn target)."""
    spec = LBSpec(**spec_dict)
    server = LBServer(spec)

    def _graceful(_sig, _frm):
        server.running = False

    signal.signal(signal.SIGINT, _graceful)
    signal.signal(signal.SIGTERM, _graceful)
    ready.send(("addr", list(server.node.addr)))
    ready.close()
    server.run()
    sys.exit(0)
