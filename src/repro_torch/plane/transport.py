# Copy of src/repro/plane/transport.py (no import of the JAX package).
"""`SocketTransport` — the `repro.routing.Transport` protocol over real
sockets.

The same `RoutingCore` that runs over the simulator's event queue and the
in-process router's tick mailbox here drives FRAMES on TCP connections:

    deliver        -> a ``deliver`` frame to a replica process (deadline
                      STRIPPED — the LB owns deadline enforcement; see
                      repro.plane.wire)
    forward        -> a ``forward`` frame to a peer LB (deadline converted
                      to a REMAINING duration; the receiver re-stamps)
    steal_request  -> a ``steal`` frame to the victim LB
    pull_pages     -> a ``kvpull`` frame to the peer LB; the KV payload
                      relays back and rides the eventual deliver frame
    hedge          -> a clone (GenRequest.clone_for_dispatch) raced to a
                      peer region; the owning LBServer arbitrates
                      first-token-wins and reaps the loser

Time is `time.monotonic()` — a real wall clock, which is exactly why
`now()` values must never cross a process boundary (each process has its
own epoch).  Liveness is HEARTBEAT FRESHNESS: the owner feeds `saw(id)` as
heartbeats arrive, and `target_alive`/`peer_alive` answer "heard from it
within `stale_after_s`" — so a kill -9'd process goes stale and drops out
of eligibility exactly the way the paper's availability monitor intends,
with no cooperative shutdown required.

WAN delay is per-link and injected at the SENDER: each peer `Conn` carries
its `delay_s` (configured from `wan_delay_ms` at connect time), so a
forward to a far region leaves the process `wan_delay_ms` after the core
decided — the socket plane's equivalent of `wan_delay_ticks`.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.plane import wire
from repro_torch.plane.mailbox import Node


class SocketTransport:
    """Transport over a `mailbox.Node`'s connections (one LB's view)."""

    def __init__(self, node: Node, origin: str, *,
                 stale_after_s: float = 0.5,
                 partition_grace_s: float = 0.0,
                 on_dispatch: Optional[Callable] = None,
                 on_pull: Optional[Callable] = None,
                 on_hedge: Optional[Callable] = None,
                 origin_of: Optional[Callable] = None):
        self.node = node
        self.origin = origin                 # this LB's region id
        self.stale_after_s = stale_after_s
        # extra patience before declaring a STALE-BUT-CONNECTED peer dead:
        # a blackholed or delay-spiked link keeps the TCP conn up (no EOF),
        # and heartbeats may resume — that is a link fault, not a death.
        # EOF + stale is a dead process and gets no grace.
        self.partition_grace_s = partition_grace_s
        self.last_seen: dict[str, float] = {}    # id -> monotonic heartbeat
        # owner hooks: inflight tracking (failover re-dispatch), the
        # pending-pull table, and the hedge race — per-request state that
        # lives with the LB server, not the wire
        self.on_dispatch = on_dispatch       # (req, target_id)
        self.on_forward = None               # (req, peer_id)
        self.on_pull = on_pull               # (req, peer, target, plen, ptok)
        self.on_hedge = on_hedge             # (clone, primary, peer_id)
        self.origin_of = origin_of           # (req) -> origin region id
        self.gen_of = None                   # (target_id) -> fencing epoch
        self.on_shed = None                  # (req) -> terminal SHED result

    # ------------------------------------------------------------ liveness
    def now(self) -> float:
        return time.monotonic()

    def saw(self, peer_id: str, ts: Optional[float] = None) -> None:
        """Record a heartbeat (or any sign of life) from `peer_id`."""
        self.last_seen[peer_id] = self.now() if ts is None else ts

    def forget(self, peer_id: str) -> None:
        self.last_seen.pop(peer_id, None)

    def _fresh(self, peer_id: str) -> bool:
        ts = self.last_seen.get(peer_id)
        if ts is None:
            return False
        conn = self.node.by_id.get(peer_id)
        if conn is None or not conn.alive:
            return False
        return self.now() - ts <= self.stale_after_s

    def target_alive(self, target_id: str) -> bool:
        return self._fresh(target_id)

    def peer_alive(self, peer_id: str) -> bool:
        return self._fresh(peer_id)

    def link_up(self, peer_id: str) -> bool:
        """Is the TCP conn to `peer_id` still established (regardless of
        heartbeat freshness)?"""
        conn = self.node.by_id.get(peer_id)
        return bool(conn is not None and conn.alive)

    def presumed_dead(self, peer_id: str) -> bool:
        """Should the owner `_declare_dead` this peer?  Two regimes:

        * stale + conn EOF'd  -> the process is gone (kill -9); declare
          as soon as the heartbeat goes stale.
        * stale + conn alive  -> the LINK may be down (blackhole, delay
          spike); wait out `partition_grace_s` past staleness before
          giving up, keeping inflight work parked meanwhile.
        """
        ts = self.last_seen.get(peer_id)
        if ts is None:
            return False
        age = self.now() - ts
        if age <= self.stale_after_s:
            return False
        if not self.link_up(peer_id):
            return True
        return age > self.stale_after_s + self.partition_grace_s

    # ------------------------------------------------------------ movement
    def _req_origin(self, req) -> str:
        if self.origin_of is not None:
            got = self.origin_of(req)
            if got is not None:
                return got
        return self.origin

    def deliver(self, req, target_id: str) -> None:
        if self.on_dispatch is not None:
            self.on_dispatch(req, target_id)
        d = wire.msg(
            "deliver", req=wire.encode_request(req, deadline=wire.STRIP),
            origin=self._req_origin(req))
        if self.gen_of is not None:
            d["gen"] = self.gen_of(target_id)
        self.node.send_to(target_id, d)

    def forward(self, req, peer_id: str) -> None:
        frame = wire.msg(
            "forward",
            req=wire.encode_request(req, deadline=wire.REMAINING,
                                    now=self.now()),
            origin=self._req_origin(req))
        if self.on_forward is not None:      # ownership moves with the req
            self.on_forward(req, peer_id)
        self.node.send_to(peer_id, frame)

    def steal_request(self, peer_id: str, n: int) -> None:
        self.node.send_to(peer_id, wire.msg(
            "steal", thief=self.origin, n=int(n)))

    def shed(self, req) -> None:
        """Admission-control shed: resolved AT this LB (terminal SHED
        result back to the owning client); no frame leaves the process."""
        if self.on_shed is not None:
            self.on_shed(req)

    def pull_pages(self, req, peer_id: str, target_id: str,
                   prefix_len: int, pull_tokens: int) -> None:
        """Ask `peer_id`'s region for the KV of the request's first
        `prefix_len` prompt tokens; the owner parks the request until the
        `kvpages` reply relays back (or its pull timeout fires) and then
        delivers it to `target_id` with the payload attached."""
        if self.on_pull is not None:
            self.on_pull(req, peer_id, target_id, prefix_len, pull_tokens)
        self.node.send_to(peer_id, wire.msg(
            "kvpull", rid=req.rid,
            tokens=list(req.prompt_tokens)[:prefix_len],
            requester=self.origin))

    def hedge(self, req, peer_id: str) -> None:
        """Race a clone of `req` to `peer_id`. The clone — fresh rid, no
        deadline, no callbacks (GenRequest.clone_for_dispatch), marked
        forwarded so it can't re-forward or re-hedge — travels as a normal
        forward frame; the owning LB arbitrates the race on token frames
        coming back (first token wins, loser reaped via the idempotent
        cancel path)."""
        clone = req.clone_for_dispatch()
        clone.forwarded = True
        if self.on_hedge is not None:
            self.on_hedge(clone, req, peer_id)
        self.node.send_to(peer_id, wire.msg(
            "forward",
            req=wire.encode_request(clone, deadline=wire.REMAINING,
                                    now=self.now()),
            origin=self.origin))
