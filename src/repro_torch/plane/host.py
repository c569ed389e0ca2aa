# Copy of src/repro/plane/host.py (no import of the JAX package), with
# the torch backend's `PlaneConfig.arch` / `device` threaded into every
# `ReplicaSpec` and its device resolved before the first spawn.
"""`ServingPlane` (the launcher) and `ProcessHost` (the frontend adapter).

`ServingPlane` spawns the real topology — N regions x M replica processes
plus one LB process per region — wires it (replica addrs into each LB
spec, a ``peers`` control frame carrying the WAN delay matrix), and keeps
control connections to every process for metrics?/drain/shutdown and the
crash drills (`kill_replica` / `kill_lb` are genuine ``SIGKILL``s on real
PIDs).

`ProcessHost` satisfies the `repro_torch.frontend.Client` host protocol
(submit/cancel/pump/now), so the SAME front door that drives the simulator
and the in-process router drives the multi-process plane:

    plane = ServingPlane(PlaneConfig(regions=("us", "eu"), replicas=2))
    plane.start()
    client = Client(plane.host())
    handle = client.submit(GenRequest(...), region="us")
    for ev in handle.stream(): ...
    plane.shutdown()

Client-side failover: the host keeps every unresolved request; when an LB
connection dies (kill -9, crash) the host re-submits those requests to a
surviving LB — with the deadline converted to its REMAINING duration on
the client's clock, because until an LB accepts a request the CLIENT is
its deadline owner (repro_torch.plane.wire's clock-ownership rule).  Token
replays after a replica failover are deduped by stream index, and a
request resolves exactly once no matter how many processes died on its
way.

With ``backend="torch"`` every replica process builds the port's `Engine`
on `PlaneConfig.device` (None: the card) from the serve CLI's seed-0 fp32
weights for `PlaneConfig.arch`. The launcher resolves the device before
the first spawn, so a machine without a card raises at once instead of
waiting on a child that never reports its address. Children are spawned,
never forked: CUDA cannot live in a forked child.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import signal
import time
from typing import Optional

from repro_torch.frontend.api import RequestHandle
from repro_torch.frontend.client import state_of
from repro_torch.plane import wire
from repro_torch.plane.lb import LBSpec, lb_main
from repro_torch.plane.mailbox import Node
from repro_torch.plane.replica import ReplicaSpec, replica_main
from repro_torch.serving.request import FinishReason, GenRequest, GenResult


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    regions: tuple = ("us", "eu")
    replicas: int = 2               # replica processes per region
    variant: str = "skylb"
    backend: str = "cost"           # "cost" | "torch"
    wan_delay_ms: float = 30.0      # LB<->LB one-way (scalar matrix)
    local_delay_ms: float = 0.0     # LB<->replica
    stale_after_s: float = 0.4
    partition_grace_s: float = 0.4  # stale-but-connected peers get this
                                    # long before being declared dead
    hb_interval_s: float = 0.05
    probe_interval_s: float = 0.05
    remote_probe_interval_s: float = 0.1
    time_scale: float = 0.02        # cost-backend latency compression
    cfg_overrides: tuple = ()
    arch: str = "qwen3-0.6b-reduced"  # torch backend: every replica's model
    device: Optional[str] = None    # torch backend: None = the card


class ServingPlane:
    """Launcher + control plane for the multi-process topology."""

    def __init__(self, cfg: Optional[PlaneConfig] = None):
        self.cfg = cfg if cfg is not None else PlaneConfig()
        self.ctx = mp.get_context("spawn")
        self.procs: dict[str, mp.Process] = {}       # name -> process
        self.replica_addrs: dict[str, tuple] = {}    # rid -> (host, port)
        self.lb_addrs: dict[str, tuple] = {}         # region -> (host, port)
        self.replicas_of: dict[str, list] = {}       # region -> [rid, ...]
        self.node = Node()                           # control endpoint
        self.final_metrics: dict[str, dict] = {}     # bye snapshots

    # -------------------------------------------------------------- start
    def _spawn(self, name: str, target, spec_dict: dict) -> tuple:
        parent, child = self.ctx.Pipe()
        p = self.ctx.Process(target=target, args=(spec_dict, child),
                             name=name, daemon=True)
        p.start()
        child.close()
        if not parent.poll(20.0):
            p.terminate()
            raise RuntimeError(f"{name} never reported its address")
        tag, addr = parent.recv()
        parent.close()
        assert tag == "addr"
        self.procs[name] = p
        return tuple(addr)

    def start(self) -> "ServingPlane":
        cfg = self.cfg
        if cfg.backend == "torch":
            from repro_torch.serving.engine import resolve_device
            resolve_device(cfg.device)      # no card: raise here, not in
                                            # a child the parent waits on
        for region in cfg.regions:
            self.replicas_of[region] = []
            for i in range(cfg.replicas):
                rid = f"{region}-r{i}"
                spec = ReplicaSpec(rid=rid, region=region,
                                   backend=cfg.backend,
                                   hb_interval_s=cfg.hb_interval_s,
                                   time_scale=cfg.time_scale,
                                   arch=cfg.arch, device=cfg.device)
                addr = self._spawn(rid, replica_main,
                                   dataclasses.asdict(spec))
                self.replica_addrs[rid] = addr
                self.replicas_of[region].append(rid)
        for region in cfg.regions:
            spec = LBSpec(
                region=region, variant=cfg.variant,
                replicas=tuple((r, list(self.replica_addrs[r]))
                               for r in self.replicas_of[region]),
                probe_interval_s=cfg.probe_interval_s,
                remote_probe_interval_s=cfg.remote_probe_interval_s,
                stale_after_s=cfg.stale_after_s,
                partition_grace_s=cfg.partition_grace_s,
                local_delay_ms=cfg.local_delay_ms,
                cfg_overrides=cfg.cfg_overrides)
            addr = self._spawn(f"lb-{region}", lb_main,
                               dataclasses.asdict(spec))
            self.lb_addrs[region] = addr
        # control conns + the peer table (the WAN delay matrix)
        peers = [{"region": r, "addr": list(a),
                  "delay_ms": self.cfg.wan_delay_ms}
                 for r, a in self.lb_addrs.items()]
        for region, addr in self.lb_addrs.items():
            self.node.connect(addr, f"lb:{region}",
                              hello=wire.msg("hello", kind="ctl", id="ctl"))
            self.node.send_to(f"lb:{region}", wire.msg("peers", peers=peers))
        for rid, addr in self.replica_addrs.items():
            self.node.connect(addr, f"rep:{rid}",
                              hello=wire.msg("attach", id="ctl", kind="ctl"))
        return self

    # -------------------------------------------------------------- drills
    def pid_of(self, name: str) -> Optional[int]:
        p = self.procs.get(name)
        return p.pid if p is not None else None

    def kill_replica(self, rid: str) -> int:
        """kill -9 a replica process (the crash drill). Returns the pid."""
        p = self.procs[rid]
        os.kill(p.pid, signal.SIGKILL)
        p.join(5.0)
        return p.pid

    def kill_lb(self, region: str) -> int:
        """kill -9 a region's LB process."""
        p = self.procs[f"lb-{region}"]
        os.kill(p.pid, signal.SIGKILL)
        p.join(5.0)
        return p.pid

    def adopt(self, by_region: str, orphaned_region: str) -> None:
        """After `kill_lb(orphaned_region)`: tell `by_region`'s LB to dial
        the orphaned replicas and serve them (controller-style failover)."""
        self.node.send_to(f"lb:{by_region}", wire.msg(
            "adopt", replicas=[[r, list(self.replica_addrs[r])]
                               for r in self.replicas_of[orphaned_region]]))

    # --------------------------------------------------------------- chaos
    def chaos(self, proc: str, target: str, fault) -> bool:
        """Install `fault` (a `repro_torch.plane.chaos.LinkFault`, or None to
        heal) on `proc`'s link to `target` ("*" = all links).  `proc` is a
        control name: "lb:<region>" or "rep:<rid>".  Rides the control
        conn, which is never faulted — heal is always deliverable."""
        return self.node.send_to(proc, wire.encode_chaos(target, fault))

    def blackhole_link(self, region: str, target: str) -> bool:
        """Blackhole the LB<->target link (applied at the LB's endpoint:
        its sends die at the pacer, the peer's frames are dropped on
        arrival — the peer sees silence, not an EOF)."""
        from repro_torch.plane.chaos import blackhole
        return self.chaos(f"lb:{region}", target, blackhole())

    def delay_link(self, region: str, target: str, extra_s: float,
                   jitter_s: float = 0.0) -> bool:
        """Delay-spike the LB->target direction by extra_s (+ jitter)."""
        from repro_torch.plane.chaos import delay
        return self.chaos(f"lb:{region}", target, delay(extra_s, jitter_s))

    def heal_link(self, region: str, target: str) -> bool:
        return self.chaos(f"lb:{region}", target, None)

    def isolate_region(self, region: str) -> bool:
        """Region-wide isolation: the region's LB is blackholed from every
        peer LB and every client (its local replicas stay reachable)."""
        from repro_torch.plane.chaos import blackhole
        f = blackhole()
        ok = True
        for peer in self.cfg.regions:
            if peer != region:
                ok &= self.chaos(f"lb:{region}", peer, f)
                ok &= self.chaos(f"lb:{peer}", region, f)
        return ok

    def heal_region(self, region: str) -> bool:
        ok = True
        for peer in self.cfg.regions:
            if peer != region:
                ok &= self.heal_link(region, peer)
                ok &= self.heal_link(peer, region)
        return ok

    # ------------------------------------------------------------- metrics
    def metrics(self, timeout: float = 2.0) -> dict:
        """Ray-Serve-style snapshot sweep: ask every live process for its
        per-process metrics and merge (repro_torch.plane.metrics)."""
        want = set()
        for name in list(self.node.by_id):
            if self.node.send_to(name, wire.msg("metrics?")):
                want.add(name)
        snaps: dict[str, dict] = dict(self.final_metrics)
        deadline = time.monotonic() + timeout
        while want and time.monotonic() < deadline:
            got = self.node.poll(0.05)
            if got is None:
                continue
            _conn, m = got
            if m.get("t") == "metrics":
                snaps[m["id"]] = m["data"]
                want.discard(m["id"])
                want.discard(f"rep:{m['id']}")
                want.discard(f"lb:{m['id'].split(':')[-1]}")
            elif m.get("t") == "bye":
                self.final_metrics[m["id"]] = m.get("metrics", {})
        from repro_torch.plane.metrics import merge_snapshots
        return merge_snapshots(list(snaps.values()))

    # ------------------------------------------------------------ shutdown
    def shutdown(self, timeout: float = 10.0) -> None:
        """Graceful stop: drain every process, join, escalate to SIGKILL
        only for stragglers. Never leaves orphans (tests assert this)."""
        for name in list(self.node.by_id):
            self.node.send_to(name, wire.msg("drain"))
        deadline = time.monotonic() + timeout
        for name, p in self.procs.items():
            p.join(max(0.1, deadline - time.monotonic()))
        for name, p in self.procs.items():
            if p.is_alive():
                p.terminate()
                p.join(2.0)
            if p.is_alive():
                p.kill()
                p.join(2.0)
        self.node.close()

    def host(self) -> "ProcessHost":
        return ProcessHost(self.lb_addrs,
                           stale_after_s=self.cfg.stale_after_s)


class ProcessHost:
    """`repro_torch.frontend.Client` host over the socket plane (the fourth
    substrate, after SimHost / RouterHost / EngineHost)."""

    def __init__(self, lb_addrs: dict, client_id: str = "client-0", *,
                 stale_after_s: float = 0.4):
        self.node = Node()
        self.lb_addrs = {r: tuple(a) for r, a in lb_addrs.items()}
        self.client_id = client_id
        self.stale_after_s = float(stale_after_s)
        self.ping_interval_s = max(0.02, self.stale_after_s / 4)
        for region, addr in self.lb_addrs.items():
            self.node.connect(addr, region, hello=wire.msg(
                "hello", kind="client", id=client_id))
        self.handles: dict[int, RequestHandle] = {}
        self.unresolved: dict[int, tuple] = {}   # rid -> (req, region, t0)
        self.resubmitted: dict[int, int] = {}    # rid -> count
        # partition tolerance: an LB behind a blackhole produces no EOF,
        # so liveness is ping/pong freshness; re-homed requests mark their
        # old region a ZOMBIE for that rid — post-heal frames from it are
        # fenced, and the re-dispatched copy is the only one that resolves
        now = time.monotonic()
        self.last_pong: dict[str, float] = {r: now for r in self.lb_addrs}
        self.region_down: set[str] = set()
        self.zombie_of: dict[int, set] = {}      # rid -> abandoned regions
        self.resolved_by: dict[int, str] = {}    # rid -> source of terminal
        self._ping_due = 0.0
        # counters (merged into the bench/drill gates)
        self.duplicate_results = 0               # UNFENCED cross-source dup
        self.fenced_frames = 0                   # zombie frames discarded
        self.dup_suppressed = 0                  # same-source resends
        self.rehomed = 0

    def now(self) -> float:
        return time.monotonic()

    def counters(self) -> dict:
        return {"duplicate_results": self.duplicate_results,
                "fenced_frames": self.fenced_frames,
                "dup_suppressed": self.dup_suppressed,
                "rehomed": self.rehomed,
                "reconnects": self.node.reconnects,
                "fault_dropped_send": self.node.fault_dropped_send,
                "fault_dropped_recv": self.node.fault_dropped_recv}

    # ------------------------------------------------------------- submit
    def submit(self, req: GenRequest, region: str,
               handle: RequestHandle) -> None:
        if region not in self.lb_addrs:
            raise ValueError(f"unknown region {region!r}; "
                             f"one of {sorted(self.lb_addrs)}")
        self.handles[req.rid] = handle
        # client-clock submit time, for client-observed TTFT; the wire
        # codec never ships it (arrival is re-stamped by every receiver)
        req.arrival_s = time.monotonic()
        # expired-at-submit is the host's to resolve, on the client's clock
        if req.deadline_s is not None and req.deadline_s <= 0:
            self._finish_local(req.rid, FinishReason.DEADLINE)
            return
        if region in self.region_down:
            # the target region is behind a partition right now: submit to
            # a survivor instead of parking on a dead link
            survivors = [r for r in self.lb_addrs if r not in
                         self.region_down and self._conn_ok(r)]
            if survivors:
                region = survivors[0]
        self.unresolved[req.rid] = (req, region, time.monotonic())
        if not self.node.send_to(region, wire.msg(
                "submit", req=wire.encode_request(req, deadline=wire.KEEP))):
            self._lb_died(region)        # dead at submit: fail over now

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        ent = self.unresolved.get(rid)
        if ent is None:
            return False
        _req, region, _t0 = ent
        if not self.node.send_to(region, wire.msg("cancel", rid=rid,
                                                  reason=reason)):
            self._finish_local(rid, FinishReason.CANCELLED)
        return True

    # --------------------------------------------------------------- pump
    def pump(self) -> bool:
        now = time.monotonic()
        if now >= self._ping_due:
            self._ping_due = now + self.ping_interval_s
            for region in self.lb_addrs:
                self.node.send_to(region, wire.msg("ping", nonce=now))
            self._check_liveness(now)
            self.node.maybe_redial(now)
        got = self.node.poll(0.02)
        if got is None:
            return bool(self.unresolved)
        self._handle(*got)
        # budget gates the POLL, not the handle: a dequeued frame is
        # always handled, never dropped on budget exhaustion
        for _ in range(63):
            got = self.node.poll(0.0)
            if got is None:
                break
            self._handle(*got)
        return True

    def _handle(self, conn, m: dict) -> None:
        t = m.get("t")
        src = conn.id
        if t == "token":
            if src in self.zombie_of.get(m["rid"], ()):
                self.fenced_frames += 1     # zombie region still streaming
                return
            h = self.handles.get(m["rid"])
            # replays after a replica failover restart at index 0: dedupe
            if h is not None and m["idx"] >= len(h.events):
                h._token(m["tok"], m["idx"], time.monotonic())
        elif t == "admit":
            if src in self.zombie_of.get(m["rid"], ()):
                self.fenced_frames += 1
                return
            h = self.handles.get(m["rid"])
            if h is not None:
                h._admit(time.monotonic())
        elif t == "result":
            res = wire.decode_result(m["res"])
            conn.send(wire.msg("resack", rid=res.rid))   # stop the resends
            if res.rid in self.resolved_by:
                by = self.resolved_by[res.rid]
                if by == src or by == "local":
                    self.dup_suppressed += 1    # a retry of the same copy
                elif src in self.zombie_of.get(res.rid, ()):
                    self.fenced_frames += 1     # the fence did its job
                else:
                    self.duplicate_results += 1  # correctness violation
                return
            if src in self.zombie_of.get(res.rid, ()):
                # the abandoned copy finished first: discard exactly once;
                # the re-dispatched copy is the only one that resolves
                self.fenced_frames += 1
                return
            self.resolved_by[res.rid] = src
            h = self.handles.pop(res.rid, None)
            self.unresolved.pop(res.rid, None)
            if h is not None and not h.done:
                h._finish(res, state_of(res.finish_reason))
        elif t == "pong":
            region = src or m.get("id")
            if region in self.last_pong:
                self.last_pong[region] = time.monotonic()
                if region in self.region_down:
                    self._region_healed(region)
        elif t == "_lost" and conn.id in self.lb_addrs:
            self._lb_died(conn.id)

    # ----------------------------------------------------------- failover
    def _lb_died(self, region: str) -> None:
        """An LB connection dropped (EOF — the process is gone): re-home
        every unresolved request that was submitted there to a surviving
        LB.  The client owns the deadline again until the new LB accepts,
        so it travels as the REMAINING duration measured on the client's
        clock."""
        self.node.drop(region)
        self._rehome(region)

    def _check_liveness(self, now: float) -> None:
        """A blackholed LB produces no EOF — only silence.  When a region
        stops answering pings for 2x stale_after_s AND has unresolved
        requests parked on it, treat the region as down and re-home; on
        heal (pongs resume) the abandoned copies are cancelled and their
        frames stay fenced."""
        down_after = 2 * self.stale_after_s
        for region, ts in self.last_pong.items():
            if region in self.region_down or now - ts <= down_after:
                continue
            if not any(reg == region
                       for _q, reg, _t in self.unresolved.values()):
                continue        # nothing parked there: nothing to re-home
            self.region_down.add(region)
            self._rehome(region)

    def _region_healed(self, region: str) -> None:
        """Pongs resumed from a region we re-homed away from: reap the
        zombie copies (idempotent cancels) so they stop computing."""
        self.region_down.discard(region)
        for rid, regions in list(self.zombie_of.items()):
            if region in regions:
                self.node.send_to(region, wire.msg(
                    "cancel", rid=rid, reason="cancelled"))

    def _rehome(self, region: str) -> None:
        survivors = [r for r in self.lb_addrs
                     if r != region and r not in self.region_down
                     and self._conn_ok(r)]
        strays = [rid for rid, (_q, reg, _t) in self.unresolved.items()
                  if reg == region]
        for rid in strays:
            req, _reg, t0 = self.unresolved[rid]
            if not survivors or self.resubmitted.get(rid, 0) >= 2:
                self._finish_local(rid, FinishReason.ABORT)
                continue
            if req.deadline_s is not None:
                req.deadline_s -= time.monotonic() - t0
                if req.deadline_s <= 0:
                    self._finish_local(rid, FinishReason.DEADLINE)
                    continue
            target = survivors[0]
            # the old region may still be computing this rid behind the
            # partition: fence everything it says about it from now on
            self.zombie_of.setdefault(rid, set()).add(region)
            self.resubmitted[rid] = self.resubmitted.get(rid, 0) + 1
            self.rehomed += 1
            self.unresolved[rid] = (req, target, time.monotonic())
            self.node.send_to(target, wire.msg(
                "submit", req=wire.encode_request(req, deadline=wire.KEEP)))

    def _conn_ok(self, region: str) -> bool:
        conn = self.node.by_id.get(region)
        if conn is not None and conn.alive:
            return True
        try:        # an LB we never dialed, or one that restarted
            self.node.connect(self.lb_addrs[region], region,
                              hello=wire.msg("hello", kind="client",
                                             id=self.client_id))
            return True
        except OSError:
            return False

    def _finish_local(self, rid: int, why: FinishReason) -> None:
        self.resolved_by.setdefault(rid, "local")
        h = self.handles.pop(rid, None)
        ent = self.unresolved.pop(rid, None)
        req = ent[0] if ent is not None else (h.request if h else None)
        if h is None or h.done or req is None:
            return
        res = GenResult(rid=rid, output_tokens=tuple(h.tokens),
                        finish_reason=why, cached_tokens=0,
                        prompt_len=len(req.prompt_tokens))
        h._finish(res, state_of(why))

    def close(self) -> None:
        self.node.close()
