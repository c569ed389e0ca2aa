# Copy of src/repro/core/system.py (no import of the JAX package).
"""Deployment builder + closed-loop clients: wires Sim, Network, replicas,
LBs, Controller, policies into the named system variants evaluated in the
paper (Fig. 8/9/10) plus our beyond-paper variants.

Variants:
  skylb        LB/region, prefix-trie local + snapshot-trie remote, SP-P
  skylb-ch     LB/region, consistent hashing at both layers, SP-P
  rr/ll/ch/sgl single central LB (US), blind pushing  — paper baselines
  gke          LB/region, RR, outstanding-cap spillover to remote regions
               (GKE-Gateway-like: no prefix awareness, no pending probes)
  region-local LB/region, least-load, NO cross-region  — Fig. 10 baseline
  blend        BEYOND-PAPER: skylb with blended prefix x load scoring
  steal        BEYOND-PAPER: skylb + receiver-initiated work stealing
  sp-o / bp    skylb trie routing but SP-O / blind pushing (Fig. 9 ablation)
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Optional

from repro_torch.core.metrics import RunMetrics
from repro_torch.core.simulator import (Controller, LoadBalancerSim, Network,
                                  ReplicaConfig, ReplicaSim, Request, Sim,
                                  resolve_cancelled)
from repro_torch.core.workloads import SessionSpec, TreeSpec, _tokens, stable_hash
from repro_torch.frontend.api import RequestHandle, RequestState
from repro_torch.frontend.client import state_of
from repro_torch.routing import build_routing
from repro_torch.serving.request import (FinishReason, GenResult,
                                   cancel_finish_reason, next_rid)

REGIONS = ("us", "eu", "asia")


class ServingSystem:
    def __init__(self, variant: str, replicas_per_region: dict[str, int],
                 *, replica_cfg: ReplicaConfig = ReplicaConfig(),
                 net: Optional[Network] = None, seed: int = 0,
                 cfg_overrides: Optional[dict] = None):
        self.sim = Sim()
        self.net = net or Network()
        self.variant = variant
        self.metrics = RunMetrics()
        self.replicas: list[ReplicaSim] = []
        self._region_of: dict[str, str] = {}    # rid -> region (O(1) lookups)
        self.lbs: dict[str, LoadBalancerSim] = {}
        self._rid = itertools.count()
        # request ids come from the ONE process-wide counter shared with
        # GenRequest, so frontend-submitted and internal-client requests
        # can never collide in the rid-keyed cancel/deadline registries
        self._req_id = iter(next_rid, None)
        self._inflight: dict[int, Request] = {}   # rid -> unresolved request
        self.rng = random.Random(seed)
        self.replica_cfg = replica_cfg          # template for elastic adds
        # RoutingConfig field overrides for every LB this system builds
        # (e.g. fairness=True, slo_lanes=True, admission=True for the
        # multi-tenant scenarios) — same shape as LBSpec.cfg_overrides on
        # the socket plane
        self.cfg_overrides = dict(cfg_overrides or {})
        self._build(variant, replicas_per_region, replica_cfg)
        self.controller = Controller(self.sim, self.net,
                                     list(self.lbs.values()))

    # ------------------------------------------------------------ build
    def _mk_replica(self, region: str, cfg: ReplicaConfig) -> ReplicaSim:
        r = ReplicaSim(self.sim, f"{region}-r{next(self._rid)}", region,
                       dataclasses.replace(cfg))
        r.on_bounce = lambda req, rep=r: self._bounce(rep, req)
        self.replicas.append(r)
        self._region_of[r.id] = region
        return r

    def _mk_replicas(self, region: str, n: int, cfg: ReplicaConfig):
        return [self._mk_replica(region, cfg) for _ in range(n)]

    def _build(self, variant, rpr, rcfg):
        spec = build_routing(variant)
        if spec.single_lb:
            # e.g. 'trie' = single global-view prefix-trie router (longest
            # match + least-load exploration) — the Fig. 6 'optimal' stand-in
            lb = LoadBalancerSim(self.sim, "lb-us", "us", self.net,
                                 spec.local_policy(),
                                 cfg=spec.make_config(**self.cfg_overrides),
                                 metrics=self.metrics)
            for region, n in rpr.items():
                for r in self._mk_replicas(region, n, rcfg):
                    lb.add_replica(r)
            self.lbs = {"lb-us": lb}
            return
        # one LB per region
        for region, n in rpr.items():
            lb = LoadBalancerSim(
                self.sim, f"lb-{region}", region, self.net,
                spec.local_policy(), remote_policy=spec.remote_policy(),
                cfg=spec.make_config(**self.cfg_overrides),
                metrics=self.metrics)
            for r in self._mk_replicas(region, n, rcfg):
                lb.add_replica(r)
            self.lbs[lb.id] = lb
        for a in self.lbs.values():
            for b in self.lbs.values():
                a.peer(b)

    # ------------------------------------------ elastic membership
    def lb_of(self, region: str) -> LoadBalancerSim:
        """The LB that OWNS a region's replicas (vs lb_for = nearest live).
        Single-LB variants own every region from the one central LB."""
        if len(self.lbs) == 1:
            return next(iter(self.lbs.values()))
        return self.lbs[f"lb-{region}"]

    def add_replica(self, region: str,
                    cfg: Optional[ReplicaConfig] = None) -> ReplicaSim:
        """A replica joins at runtime: registered with its region's LB
        (fresh TargetView — routable before the next probe)."""
        r = self._mk_replica(region, cfg or self.replica_cfg)
        self.lb_of(region).add_replica(r)
        return r

    def drain_replica(self, rid: str, on_drained=None) -> ReplicaSim:
        """Graceful decommission: leave the routing tables NOW (prefix-trie
        records / hashring vnodes forgotten once, no new admissions), finish
        in-flight work, then fire on_drained(replica). The replica stays in
        self.replicas so its stats survive into the run summary."""
        owner = next((lb for lb in self.lbs.values() if rid in lb.replicas),
                     None)
        r = (owner.remove_replica(rid) if owner is not None
             else next((x for x in self.replicas if x.id == rid), None))
        if r is None:
            raise ValueError(f"unknown replica {rid!r}")
        r.drain(on_drained)
        return r

    def _bounce(self, replica: ReplicaSim, req: Request) -> None:
        """A request reached a replica after its drain began (it was on the
        wire when admission stopped): hand it back to the nearest live LB
        for a fresh routing decision rather than dropping it."""
        req.forwarded = False
        req.replica = None
        lb = self.lb_for(replica.region)
        self.sim.after(self.net.one_way(replica.region, lb.region),
                       lambda: lb.on_request(req))

    # ------------------------------------------------------------ routing
    def lb_for(self, region: str) -> LoadBalancerSim:
        """DNS resolution: nearest live LB (paper §4.1)."""
        live = [lb for lb in self.lbs.values() if lb.alive]
        return min(live, key=lambda lb: self.net.one_way(region, lb.region))

    def _back_delay(self, r: Request) -> float:
        """Replica -> client one-way (client-observed event times)."""
        return self.net.one_way(
            self._region_of.get(r.replica, r.region), r.region)

    def _result_state(self, r: Request,
                      handle: RequestHandle) -> tuple[GenResult, RequestState]:
        if r.error is not None:
            reason = FinishReason.ABORT
        elif r.finish_reason is not None:
            reason = cancel_finish_reason(r.finish_reason)
        else:
            reason = FinishReason.LENGTH
        state = state_of(reason)
        res = GenResult(
            rid=r.rid, output_tokens=handle.tokens, finish_reason=reason,
            cached_tokens=r.cached_tokens, prompt_len=len(r.prompt_tokens),
            ttft_s=(r.ttft - r.issued) if r.ttft is not None else None,
            e2e_s=((r.finished - r.issued) if r.finished is not None
                   else None),
            error=r.error)
        return res, state

    def submit(self, req: Request, done_cb=None, *,
               handle: RequestHandle = None) -> RequestHandle:
        """The front door: submit returns a `RequestHandle` exposing the
        token-event stream (client-observed times: replica->client WAN
        delay included), `cancel()`, and the terminal `GenResult`.

        `done_cb` is the LEGACY callback surface, kept as a thin shim over
        the handle: it still receives the raw sim `Request` at the same
        event the handle resolves. `handle` lets `repro.frontend.SimHost`
        pass the client-owned handle in so there is exactly one per
        request."""
        if handle is None:
            handle = RequestHandle(
                req, canceller=lambda h: self.cancel(h.rid, "cancelled"),
                pump=lambda: self.sim.run(max_events=1) > 0)
        if done_cb is not None:
            handle.on_done(lambda _res, r=req, cb=done_cb: cb(r))
        req.issued = self.sim.now
        self.metrics.on_issued(req)
        self._inflight[req.rid] = req

        def finish(r: Request):
            res, state = self._result_state(r, handle)
            # one zero-delay event, exactly where the legacy done_cb fired
            self.sim.after(0.0, lambda: handle._finish(res, state))

        def wrapped_admit(r: Request, t: float):
            handle._admit(t + self._back_delay(r))

        def wrapped_token(r: Request, tok: int, idx: int, t: float):
            handle._token(tok, idx, t + self._back_delay(r))

        def wrapped_done(r: Request):
            self._inflight.pop(r.rid, None)
            if r.error is not None:     # replica rejected (oversized)
                self.metrics.on_rejected(r)
            elif r.finish_reason == "cancelled":
                self.metrics.on_cancelled(r)
            elif r.finish_reason == "deadline":
                self.metrics.on_deadline(r)
            elif r.finish_reason == "shed":
                self.metrics.on_shed(r)
            else:
                back = self._back_delay(r)
                if r.ttft is not None:
                    r.ttft += back      # client-observed first token
                r.finished += back
                self.metrics.on_done(r)
            finish(r)
            # break the retention chain req -> callbacks -> handle ->
            # events: metrics keep the request for the whole run, and an
            # internal client's handle (with one TokenEvent per generated
            # token) must not be pinned along with it
            r.admit_cb = r.token_cb = r.done_cb = None

        req.admit_cb = wrapped_admit
        req.token_cb = wrapped_token
        req.done_cb = wrapped_done
        if req.deadline_s is not None and req.deadline_s <= 0:
            # expired before admission: terminal DEADLINE, nothing
            # dispatched — no LB ever sees the request
            req.finish_reason = "deadline"
            req.finished = self.sim.now
            self._inflight.pop(req.rid, None)
            self.metrics.on_deadline(req)
            finish(req)
            return handle
        lb = self.lb_for(req.region)
        self.sim.after(self.net.one_way(req.region, lb.region),
                       lambda: lb.on_request(req))
        if req.deadline_s is not None:
            self.sim.at(req.issued + req.deadline_s,
                        lambda: self.cancel(req.rid, "deadline"))
        return handle

    # ------------------------------------------------------------ cancel
    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Propagate a cancel to wherever the request is right now: an LB
        queue, a replica (pending or mid-decode — pages and radix pins are
        freed), or the WAN (forward / steal / failover handoff in flight —
        the flag travels on the request object and the next host to see it
        resolves it, so a cancel racing a steal resolves exactly once).
        Returns False when the request is already terminal (cancel after
        finish is a no-op) or was already cancelled."""
        req = self._inflight.get(rid)
        if req is None or req.finished is not None or req.cancelled is not None:
            return False
        req.cancelled = reason
        for lb in self.lbs.values():
            got = lb.core.cancel(rid)
            if got is not None:         # still queued at this LB
                resolve_cancelled(got, self.sim.now, reason)
                return True
        for r in self.replicas:
            if r.cancel(rid) is not None:
                return True
        return True     # on the WAN: resolved once, at the next arrival

    # ------------------------------------------------------------ clients
    # The closed-loop clients drive the NEW front API: submit returns a
    # RequestHandle and the next turn is chained on its terminal GenResult.
    def add_session_client(self, spec: SessionSpec,
                           think_mean: float = 1.0) -> None:
        state = {"i": 0, "history": tuple(spec.system_prompt)}

        def issue():
            i = state["i"]
            if i >= len(spec.turns):
                return
            turn = spec.turns[i]
            prompt = state["history"] + tuple(turn.prompt_suffix)
            req = Request(
                rid=next(self._req_id), user_id=spec.user_id,
                session_key=spec.user_id, region=spec.region,
                prompt_tokens=prompt, output_len=len(turn.output_tokens),
                output_tokens=tuple(turn.output_tokens))
            self.submit(req).on_done(lambda res: done(res, prompt, turn))

        def done(res: GenResult, prompt: tuple, turn):
            if res.error is not None:
                # replica rejected the turn (oversized): the history only
                # grows, so every later turn would fail too — end the session
                return
            state["history"] = prompt + tuple(turn.output_tokens)
            state["i"] += 1
            think = self.rng.expovariate(1.0 / max(1e-6, think_mean))
            self.sim.after(think, issue)

        self.sim.after(self.rng.uniform(0, 0.5), issue)

    def add_tot_client(self, trees: list[TreeSpec]) -> None:
        state = {"ti": 0}

        def run_tree():
            if state["ti"] >= len(trees):
                return
            tree = trees[state["ti"]]
            trng = random.Random(tree.seed)
            thoughts: dict[tuple, tuple] = {}
            aborted = {"v": False}

            def node_prompt(path: tuple) -> tuple:
                """question + thoughts of all ANCESTORS (root .. parent)."""
                prompt = tuple(tree.question)
                for d in range(len(path)):
                    prompt += thoughts[path[:d]]
                return prompt

            def issue_layer(depth: int, frontier: list[tuple]):
                if depth >= tree.depth:
                    state["ti"] += 1
                    self.sim.after(0.5, run_tree)
                    return
                left = {"n": len(frontier)}
                children: list[tuple] = []

                def one_done(path):
                    def cb(res: GenResult):
                        if aborted["v"]:
                            return
                        if res.error is not None:
                            # a rejected node breaks the tree's prefix chain:
                            # abandon this tree, move on to the next one
                            aborted["v"] = True
                            state["ti"] += 1
                            self.sim.after(0.5, run_tree)
                            return
                        thoughts[path] = tuple(res.output_tokens)
                        for b in range(tree.branching):
                            children.append(path + (b,))
                        left["n"] -= 1
                        if left["n"] == 0:
                            issue_layer(depth + 1, children)
                    return cb

                for path in frontier:
                    rng = random.Random(stable_hash(tree.seed, path))
                    olen = tree.node_output_len(path)
                    out = _tokens(rng, olen)
                    req = Request(
                        rid=next(self._req_id), user_id=tree.user_id,
                        session_key=f"{tree.user_id}:{tree.seed}",
                        region=tree.region, prompt_tokens=node_prompt(path),
                        output_len=olen, output_tokens=out)
                    self.submit(req).on_done(one_done(path))

            issue_layer(0, [()])

        self.sim.after(self.rng.uniform(0, 0.5), run_tree)

    def add_open_loop(self, region: str, rate_fn, until: float, *,
                      prompt_len: int = 96, output_len: int = 48,
                      template_len: int = 48, seed: int = 0) -> None:
        """OPEN-loop arrivals for one region: a non-homogeneous Poisson
        process at `rate_fn(sim_now)` requests/sim-second (piecewise
        approximation: the rate is sampled when each gap is drawn — fine
        for diurnal curves that move over hours, not seconds). Prompts
        share a per-region template prefix; the suffix is unique. This is
        the demand side of the elastic-provisioning scenarios (fig11),
        where load must vary with the clock rather than with client
        think-time."""
        rng = random.Random(stable_hash(seed, region, "openloop"))
        template = _tokens(rng, template_len)

        def arrive():
            if self.sim.now >= until:
                return
            rid = next(self._req_id)
            req = Request(
                rid=rid, user_id=f"{region}-open", session_key=f"{region}-o{rid}",
                region=region, prompt_tokens=template + _tokens(rng, prompt_len),
                output_len=output_len, output_tokens=_tokens(rng, output_len))
            self.submit(req)
            self.sim.after(rng.expovariate(max(1e-9, rate_fn(self.sim.now))),
                           arrive)

        self.sim.after(rng.expovariate(max(1e-9, rate_fn(self.sim.now))),
                       arrive)

    def add_tenant_load(self, region: str, rate: float, until: float, *,
                        deadline_s: Optional[float] = None,
                        slo_class: str = "standard", stream=None,
                        seed: int = 0, **stream_kw) -> None:
        """OPEN-loop per-tenant arrivals at a constant Poisson `rate`,
        with tenants drawn from `workloads.tenant_request_stream` (Zipf
        over user_id: few abusive cache-affine tenants, many light) — the
        demand side of the fairness scenarios (fig12). `session_key` is
        the tenant, so affinity policies concentrate each tenant's traffic
        exactly the way the abuse pattern needs."""
        from repro_torch.core.workloads import tenant_request_stream
        rng = random.Random(stable_hash(seed, region, "tenantload"))
        gen = stream if stream is not None else tenant_request_stream(
            region, seed=seed, **stream_kw)

        def arrive():
            if self.sim.now >= until:
                return
            uid, prompt, olen = next(gen)
            req = Request(
                rid=next(self._req_id), user_id=uid, session_key=uid,
                region=region, prompt_tokens=prompt, output_len=olen,
                output_tokens=_tokens(rng, olen),
                deadline_s=deadline_s, slo_class=slo_class)
            self.submit(req)
            self.sim.after(rng.expovariate(max(1e-9, rate)), arrive)

        self.sim.after(rng.expovariate(max(1e-9, rate)), arrive)

    # ------------------------------------------------------------ run
    def run(self, until: float) -> dict:
        self.metrics.t_start = 0.0
        self.sim.run(until=until)
        self.metrics.t_end = min(self.sim.now, until)
        return self.metrics.summary(self.replicas)
