"""`ReplicaProcess` — one replica engine in its own OS process (port of
`repro.plane.replica`).

The spawned process (`replica_main`) owns a `mailbox.Node`, a recv loop,
an engine, and a heartbeat publisher:

    attach    its region LB dialing in (heartbeats/tokens/results flow back
              on this conn); a control client (the launcher) attaches too
    deliver   a routed GenRequest — deadline ALWAYS stripped by the codec:
              the replica never judges deadlines on its own clock (the LB
              owns expiry and sends an explicit cancel; see
              repro_torch.plane.wire's clock-ownership rule)
    cancel    abandon rid (client cancel, LB deadline, hedge-loser reap)
    kvfetch   export the longest cached prefix for a cross-region pull
    drain     graceful shutdown: stop accepting, finish in-flight work,
              send ``bye`` (with a final metrics snapshot), exit 0
    shutdown  immediate exit (still sends ``bye``)
    metrics?  Ray-Serve-style snapshot of this process

Two backends share the loop:

  * ``cost``  — `CostEngine`, the analytic `CostModelBackend` hosted on the
    WALL clock (each iteration sleeps its modeled latency, compressed by
    `time_scale`).  CPU-only CI runs the full multi-process plane — real
    sockets, real PIDs, real kill -9 — without importing torch.
  * ``torch`` — the port's paged `repro_torch.serving.Engine` on
    `ReplicaSpec.device` (None: the card), with the serve CLI's seed-0
    fp32 weights for `ReplicaSpec.arch` (imported lazily inside the child
    so cost-mode never pays for it).  Before the child reports its address,
    one short request runs through a throwaway engine on the same weights:
    a process's first step pays for the first use of cuBLAS and of the
    kernels, which takes longer than the LB's heartbeat staleness allows
    (the LB would fail the live replica over).  Its snapshot also carries
    the launches of this process's kernel wrappers since then, the
    engine's device and the bytes torch holds there.

A request re-dispatched onto a replica that still runs it (its LB had
presumed it dead) replaces the first copy, whose frames the LB fences.

A pulled prefix crosses the wire as the bytes of CPU torch tensors, under
the same keys and dtype names as the JAX package's payload, so the two
packages' ``kvpages`` frames have one format.  A payload that does not
decode to the engine's page layout is dropped (the request recomputes);
an import that fails on the device is not caught and ends the replica,
whose LB then fails its work over.

kill -9 needs no cooperation from this file: the process dies, its
heartbeats stop, the LB's `SocketTransport` goes stale on the link, and
failover re-dispatches whatever was in flight.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import Any, Optional

from repro_torch.plane import wire
from repro_torch.plane.mailbox import Node
from repro_torch.replica import ReplicaCore, ReplicaCoreConfig
from repro_torch.replica.backends import CostModelBackend, CostParams
from repro_torch.serving.request import (FinishReason, GenRequest, GenResult,
                                         SamplingParams, cancel_finish_reason)


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Everything a replica child needs, picklable for mp spawn."""
    rid: str                        # replica id, e.g. "us-r0"
    region: str
    backend: str = "cost"           # "cost" | "torch"
    page_size: int = 8
    n_pages: int = 128
    max_batch: int = 4
    max_seq_len: int = 1024
    prefill_pad: int = 32
    hb_interval_s: float = 0.05
    time_scale: float = 0.05        # cost backend: sleep fraction of
                                    # modeled latency (1.0 = real time)
    arch: str = "qwen3-0.6b-reduced"  # torch backend model
    device: Optional[str] = None    # torch backend: None = the card


class CostEngine:
    """Wall-clock host over ReplicaCore + CostModelBackend: the same
    submit/cancel/step/results surface as `repro_torch.serving.Engine`, but
    each iteration SLEEPS its analytic latency (scaled by `time_scale`)
    instead of running a forward pass.  Tokens replay the request's
    predetermined `output_tokens` attr when present, else stream
    `FILLER_TOKEN`s.

    Deliberately NO deadline sweep: on the socket plane the accepting LB
    owns deadlines (wire-delivered requests arrive with deadline_s=None);
    a replica re-judging them against its own `time.monotonic()` epoch is
    exactly the cross-process clock-skew bug the plane forbids."""

    def __init__(self, cost: Optional[CostParams] = None, *,
                 page_size: int = 8, n_pages: int = 128, max_batch: int = 4,
                 max_seq_len: int = 1024, time_scale: float = 0.05):
        self.backend = CostModelBackend(cost)
        self.core = ReplicaCore(ReplicaCoreConfig(
            page_size=page_size, n_pages=n_pages, max_batch=max_batch,
            max_seq_len=max_seq_len), self.backend)
        self.time_scale = float(time_scale)
        self.results: dict[int, GenResult] = {}
        self._tokbuf: list = []
        self.core.token_sink = (
            lambda seq, tok, idx: self._tokbuf.append((seq, tok, idx)))

    # ---- probe surface (what heartbeats advertise)
    def pending_count(self) -> int:
        return self.core.pending_count()

    def outstanding(self) -> int:
        return self.core.outstanding()

    def available(self) -> bool:
        return self.core.available()

    def kv_utilization(self) -> float:
        return self.core.kv_utilization()

    def hit_rate(self) -> float:
        return self.core.hit_rate()

    def tenant_counters(self) -> dict:
        return self.core.tenant_counters()

    @property
    def pending(self):
        return self.core.pending

    @property
    def running(self):
        return self.core.running

    @property
    def loading(self):
        return self.core.loading

    @property
    def steps(self) -> int:
        return self.core.steps

    @property
    def completions(self) -> int:
        return self.core.completions

    # ---- request path
    def submit(self, req: GenRequest) -> None:
        if req.arrival_s is None:
            req.arrival_s = time.monotonic()
        if req.cancelled is not None:
            if req.rid not in self.results:
                self._resolve(req, (), cancel_finish_reason(req.cancelled))
            return
        self.core.submit(req)

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        if rid in self.results:
            return False
        seq = self.core.cancel(rid)
        if seq is None:
            return False
        self._finish(seq, cancel_finish_reason(reason))
        return True

    def step(self) -> int:
        plan = self.core.begin_step()
        for seq in plan.admitted:
            if seq.req.on_admit is not None:
                seq.req.on_admit(seq.req, time.monotonic())
        for seq in plan.rejected:
            self._finish(seq, FinishReason.ABORT)
        # plan.shed stays empty on the socket plane (deliver frames strip
        # deadlines, so replica-level shedding never fires here — the LB
        # sheds at admission); handled anyway so CostEngine keeps the full
        # Engine surface for in-process tests
        for seq in plan.shed:
            self._finish(seq, FinishReason.SHED)
        dt = self.backend.step_cost(len(self.core.running))
        if dt > 0 and self.time_scale > 0:
            time.sleep(dt * self.time_scale)
        finished = self.core.finish_step()
        self._drain_tokens()
        for seq in finished:
            why = (FinishReason.LENGTH if len(seq.out) >= seq.max_new
                   else FinishReason.STOP)
            self._finish(seq, why)
        return len(finished) + len(plan.rejected) + len(plan.shed)

    def has_work(self) -> bool:
        return bool(self.core.pending or self.core.running
                    or self.core.loading)

    def run_until_idle(self, max_steps: int = 100_000):
        for _ in range(max_steps):
            self.step()
            if not self.has_work():
                break
        return self.results

    # ---- cross-region KV (token-granular: no real bytes to move)
    def export_prefix(self, tokens: tuple):
        n, _pages = self.core.radix.match(tuple(tokens))
        return n, None, None

    def import_prefix(self, tokens: tuple, k_stack, v_stack) -> int:
        n, _start, _pages = self.core.inject_prefix(tuple(tokens))
        return n

    # ---- internals
    def _drain_tokens(self) -> None:
        if not self._tokbuf:
            return
        buf, self._tokbuf = self._tokbuf, []
        now = time.monotonic()
        for seq, tok, idx in buf:
            if seq.req.first_token_s is None:
                seq.req.first_token_s = now
            cb = seq.req.on_token
            if cb is not None and seq.req.rid not in self.results:
                cb(seq.req, tok, idx, now)

    def _finish(self, seq, why: FinishReason) -> None:
        self._resolve(seq.req, tuple(seq.out), why, error=seq.error)

    def _resolve(self, req: GenRequest, out: tuple, why: FinishReason,
                 error=None) -> None:
        req.finished_s = time.monotonic()
        res = GenResult(
            rid=req.rid, output_tokens=out, finish_reason=why,
            cached_tokens=req.cached_tokens,
            prompt_len=len(req.prompt_tokens),
            ttft_s=(req.first_token_s - req.arrival_s
                    if req.first_token_s is not None
                    and req.arrival_s is not None else None),
            e2e_s=(req.finished_s - req.arrival_s
                   if req.arrival_s is not None else None),
            error=error)
        self.results[req.rid] = res
        if req.on_done is not None:
            req.on_done(res)


def _build_engine(spec: ReplicaSpec):
    if spec.backend == "cost":
        return CostEngine(page_size=spec.page_size, n_pages=spec.n_pages,
                          max_batch=spec.max_batch,
                          max_seq_len=spec.max_seq_len,
                          time_scale=spec.time_scale)
    if spec.backend == "torch":
        from repro_torch.configs import get_config
        from repro_torch.models import init_weights
        from repro_torch.serving.engine import (Engine, EngineConfig,
                                                resolve_device)
        dev = resolve_device(spec.device)
        cfg = get_config(spec.arch)
        params = init_weights(cfg, dev)
        ecfg = EngineConfig(
            page_size=spec.page_size, n_pages=spec.n_pages,
            max_batch=spec.max_batch, max_seq_len=spec.max_seq_len,
            prefill_pad=spec.prefill_pad)
        Engine(cfg, params, ecfg, device=dev.type).generate([GenRequest(
            prompt_tokens=tuple(range(1, spec.prefill_pad + 1)),
            sampling=SamplingParams(max_new_tokens=2))])     # the warm-up
        return Engine(cfg, params, ecfg, device=dev.type)
    raise ValueError(f"unknown replica backend {spec.backend!r}")


def _kernel_launches() -> dict:
    """The launch counts of this process's kernel wrappers."""
    from repro_torch.kernels.page_copy import page_gather, page_scatter
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_verify import paged_verify
    return {f.__name__: f.launches
            for f in (paged_decode, paged_verify, page_gather, page_scatter)}


class _ReplicaServer:
    """The recv loop + heartbeat publisher around one engine."""

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.node = Node()
        self.engine = _build_engine(spec)
        self.lb_conn = None                 # the region LB's conn (attach)
        self.draining = False
        self.running = True
        self.delivered = 0
        self.redispatched = 0
        # partition tolerance: the fencing generation each rid was
        # delivered under (echoed on admit/token/result so the LB can
        # discard zombie frames), and terminal results not yet resacked
        # by the LB (resent on re-attach — heal never loses a finished
        # request)
        self.req_gen: dict[int, int] = {}
        self.unacked: dict[int, dict] = {}  # rid -> result frame
        # cross-region KV over the wire: one entry per non-empty export
        # and import ({"n", "bytes", "ms"}: tokens, encoded K+V bytes, host
        # ms from the request to the frame queued / to the import issued;
        # an export also has its whole frame's "frame_bytes" and "codec")
        # and the payloads dropped as malformed
        self.kv_exports: list[dict] = []
        self.kv_imports: list[dict] = []
        self.kv_dropped = 0
        self.start_s: Optional[float] = None  # replica_main: entry to addr
        # the longest gap between two heartbeats (a step holds them up),
        # against the LB's stale_after_s + partition_grace_s
        self.max_hb_gap_s = 0.0
        self._last_hb: Optional[float] = None
        # torch backend: the kernels' launches before serving (the warm-up)
        self._launches0 = (_kernel_launches() if spec.backend == "torch"
                           else None)
        self._resend_due = 0.0
        self._hb_due = 0.0
        self._t0 = time.monotonic()

    # --------------------------------------------------------------- wiring
    def _send_lb(self, msg: dict) -> None:
        if self.lb_conn is not None and self.lb_conn.alive:
            self.lb_conn.send(msg)

    def _wire_request(self, req: GenRequest, origin: str,
                      gen: int = 1) -> None:
        rid = req.rid
        self.req_gen[rid] = gen

        def on_admit(_req, t):
            self._send_lb(wire.msg("admit", rid=rid, origin=origin,
                                   gen=gen))

        def on_token(_req, tok, idx, t):
            self._send_lb(wire.msg("token", rid=rid, tok=int(tok),
                                   idx=int(idx), origin=origin, gen=gen))

        def on_done(res: GenResult):
            frame = wire.msg("result", res=wire.encode_result(res),
                             origin=origin, gen=gen)
            # park until the LB resacks: a result sent into a blackhole
            # (or while orphaned) is resent on re-attach and periodically
            self.unacked[rid] = frame
            self._send_lb(frame)

        req.on_admit, req.on_token, req.on_done = on_admit, on_token, on_done

    # ------------------------------------------------------------- handlers
    def handle(self, conn, m: dict) -> None:
        t = m.get("t")
        if t == "attach":
            self.node.register(conn, m["id"])
            if m.get("kind", "lb") == "lb":
                self.lb_conn = conn
                # re-attach after a lost link: unacked terminal results
                # flow again immediately (heal never loses a finished
                # request; the LB dedupes/fences as needed)
                for frame in list(self.unacked.values()):
                    conn.send(frame)
        elif t == "deliver":
            if self.draining:
                # nothing may be lost during drain: bounce the request back
                # to the LB so it re-routes (same shape as a failover)
                conn.send(wire.msg("redispatch", req=m["req"],
                                   origin=m.get("origin", "")))
                self.redispatched += 1
                return
            req = wire.decode_request(m["req"])
            assert req.deadline_s is None, \
                "deliver frames must never carry a deadline (LB owns expiry)"
            # a re-dispatch onto this replica after its LB presumed it
            # dead (late heartbeats): the LB fences the first copy's
            # generation, so drop that copy unseen and forget its result,
            # whose rid would keep the new copy's tokens from streaming
            self.engine.core.cancel(req.rid)
            self.engine.results.pop(req.rid, None)
            self.unacked.pop(req.rid, None)
            kv = m.get("kv")
            if kv and kv.get("n", 0) > 0:
                self._import_kv(kv)
            self._wire_request(req, m.get("origin", ""),
                               gen=m.get("gen", 1))
            self.delivered += 1
            self.engine.submit(req)
        elif t == "cancel":
            self.engine.cancel(m["rid"], m.get("reason", "cancelled"))
        elif t == "resack":
            self.unacked.pop(m["rid"], None)
            self.req_gen.pop(m["rid"], None)
        elif t == "chaos":
            target, fault = wire.decode_chaos(m)
            if target == "*":
                ids = {i for i in self.node.by_id if i != "ctl"}
                ids |= set(self.node.faults)
                for i in ids:
                    self.node.set_fault(i, fault)
            else:
                self.node.set_fault(target, fault)
        elif t == "kvfetch":
            t0 = time.monotonic()
            n, k, v = self.engine.export_prefix(tuple(m["tokens"]))
            payload = _encode_kv(tuple(m["tokens"]), n, k, v)
            frame = wire.msg("kvpages", rid=m["rid"],
                             requester=m["requester"], kv=payload)
            conn.send(frame)
            if k is not None:
                ms = 1e3 * (time.monotonic() - t0)
                packed = wire.pack(frame)   # as the conn packed it
                self.kv_exports.append({
                    "n": int(n), "bytes": _kv_bytes(payload), "ms": ms,
                    "frame_bytes": len(packed),
                    "codec": {b"M": "msgpack", b"J": "json"}[packed[4:5]]})
        elif t == "metrics?":
            conn.send(wire.msg("metrics", id=self.spec.rid,
                               data=self.snapshot()))
        elif t == "drain":
            self.draining = True
        elif t == "shutdown":
            self.running = False
        elif t == "_lost":
            if conn is self.lb_conn:
                self.lb_conn = None         # orphaned: keep serving; a new
                                            # LB may attach (adoption)

    def _import_kv(self, kv: dict) -> None:
        """Install a pulled prefix. Only the payload is guarded: one that
        does not decode to this engine's page layout is dropped and the
        request recomputes. The import itself is not: a failed launch on
        the device ends the replica, and its LB fails the work over."""
        t0 = time.monotonic()
        try:
            tokens = tuple(kv["tokens"])[:kv["n"]]
            k, v = _decode_kv_arrays(kv)
            self._check_kv(tokens, k, v)
        except (KeyError, TypeError, ValueError):
            self.kv_dropped += 1
            return
        self.engine.import_prefix(tokens, k, v)
        self.kv_imports.append({"n": len(tokens), "bytes": _kv_bytes(kv),
                                "ms": 1e3 * (time.monotonic() - t0)})

    def _check_kv(self, tokens: tuple, k, v) -> None:
        """Raise ValueError unless (k, v) are the (N, L, page, K, hd) stacks
        of this engine's pools for the full pages of `tokens` (the cost
        engine moves tokens only and takes any payload)."""
        backend = getattr(self.engine, "backend", None)
        pool = getattr(backend, "k_pages", None)
        if pool is None:
            return
        want = ((len(tokens) // pool.shape[2], pool.shape[0])
                + tuple(pool.shape[2:]))
        for name, a in (("k", k), ("v", v)):
            if a is None or a.dtype != pool.dtype or tuple(a.shape) != want:
                raise ValueError(
                    f"kv payload {name}: "
                    f"{None if a is None else (a.dtype, tuple(a.shape))}, "
                    f"the pool takes {pool.dtype} {want}")

    # ------------------------------------------------------------- metrics
    def snapshot(self) -> dict:
        """Ray-Serve-style per-process metrics snapshot (merged by the
        launcher into the RunMetrics schema)."""
        e = self.engine
        res = list(e.results.values())
        done = [r for r in res if r.finish_reason in
                (FinishReason.LENGTH, FinishReason.STOP)]
        snap = {
            "kind": "replica", "id": self.spec.rid,
            "region": self.spec.region, "pid": os.getpid(),
            "uptime_s": time.monotonic() - self._t0,
            "delivered": self.delivered,
            "completed": len(done),
            "cancelled": sum(1 for r in res
                             if r.finish_reason == FinishReason.CANCELLED),
            "deadline_aborted": sum(
                1 for r in res
                if r.finish_reason == FinishReason.DEADLINE),
            "rejected": sum(1 for r in res
                            if r.finish_reason == FinishReason.ABORT),
            "output_tokens": sum(len(r.output_tokens) for r in done),
            "cached_tokens": sum(r.cached_tokens for r in done),
            "prompt_tokens": sum(r.prompt_len for r in done),
            "steps": e.steps,
            "hit_rate": e.hit_rate(),
            "kv_utilization": e.kv_utilization(),
            "pending": e.pending_count(),
            "outstanding": e.outstanding(),
            "unacked_results": len(self.unacked),
            "lb_attached": bool(self.lb_conn is not None
                                and self.lb_conn.alive),
            "fault_dropped_send": self.node.fault_dropped_send,
            "fault_dropped_recv": self.node.fault_dropped_recv,
            "start_s": self.start_s,
            "kv_exports": list(self.kv_exports),
            "kv_imports": list(self.kv_imports),
            "kv_dropped": self.kv_dropped,
            "max_hb_gap_s": self.max_hb_gap_s,
        }
        if self._launches0 is not None:
            import torch
            snap.update(
                kernel_launches={k: n - self._launches0[k]
                                 for k, n in _kernel_launches().items()},
                device=str(e.device),
                device_allocated=(torch.cuda.memory_allocated(e.device)
                                  if e.device.type == "cuda" else 0))
        return snap

    def _heartbeat(self) -> None:
        now = time.monotonic()
        if self._last_hb is not None:
            self.max_hb_gap_s = max(self.max_hb_gap_s, now - self._last_hb)
        self._last_hb = now
        e = self.engine
        view = {"id": self.spec.rid, "outstanding": e.outstanding(),
                "pending": e.pending_count(),
                "available": e.available() and not self.draining}
        # fairness ledger rides the heartbeat only when a non-FCFS
        # discipline has actually charged something (keeps frames lean;
        # absent key decodes via the TargetView default)
        tc = e.tenant_counters()
        if tc:
            view["tenant_counters"] = tc
        self._send_lb(wire.msg("hb", id=self.spec.rid, view=view,
                               ts=time.monotonic()))

    # ----------------------------------------------------------------- run
    def run(self) -> None:
        while self.running:
            # drain a burst, then compute; the budget gates the POLL so a
            # dequeued frame is always handled, never dropped
            for _ in range(64):
                got = self.node.poll(0.0)
                if got is None:
                    break
                self.handle(*got)
            if self.engine.has_work():
                self.engine.step()
            elif self.draining:
                break
            else:
                got = self.node.poll(min(self.spec.hb_interval_s, 0.02))
                if got is not None:
                    self.handle(*got)
            now = time.monotonic()
            if now >= self._hb_due:
                self._heartbeat()
                self._hb_due = now + self.spec.hb_interval_s
            if self.unacked and now >= self._resend_due:
                self._resend_due = now + 0.25
                for frame in list(self.unacked.values()):
                    self._send_lb(frame)
        # graceful exit: final heartbeat-silence is expected; announce
        self._send_lb(wire.msg("bye", id=self.spec.rid,
                               metrics=self.snapshot()))
        for conn in self.node.conns:
            if conn is not self.lb_conn and conn.alive and conn.id:
                conn.send(wire.msg("bye", id=self.spec.rid,
                                   metrics=self.snapshot()))
        time.sleep(0.05)                    # let the pacer flush
        self.node.close()


def _encode_kv(tokens: tuple, n: int, k, v) -> dict:
    """The ``kvpages`` payload: K and V as raw bytes of CPU tensors, the
    dtype spelled as numpy spells it ("float32")."""
    out: dict[str, Any] = {"tokens": list(tokens), "n": int(n)}
    if k is not None and v is not None:
        import torch
        ka, va = k.contiguous(), v.contiguous()
        kb, vb = (a.view(torch.uint8).numpy().tobytes() for a in (ka, va))
        out.update(k=wire.encode_bytes(kb), v=wire.encode_bytes(vb),
                   dtype=str(ka.dtype).removeprefix("torch."),
                   k_shape=list(ka.shape), v_shape=list(va.shape))
    return out


def _decode_kv_arrays(kv: dict):
    """(k, v) as writable CPU torch tensors, or (None, None) for a
    token-only payload. ValueError on a dtype torch lacks or on bytes that
    do not fill the shapes."""
    if "k" not in kv or kv.get("k") is None:
        return None, None
    import torch
    dtype = getattr(torch, str(kv["dtype"]), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"kv payload dtype {kv['dtype']!r}")
    out = []
    for key in ("k", "v"):
        raw = bytearray(wire.decode_bytes(kv[key]))
        shape = [int(d) for d in kv[f"{key}_shape"]]
        numel = 1
        for d in shape:
            numel *= d
        if len(raw) != numel * dtype.itemsize:
            raise ValueError(f"kv payload {key}: {len(raw)} bytes for "
                             f"{shape} of {dtype}")
        out.append(torch.frombuffer(raw, dtype=dtype).reshape(shape)
                   if raw else torch.empty(shape, dtype=dtype))
    return out[0], out[1]


def _kv_bytes(kv: dict) -> int:
    """Encoded K + V bytes of a payload (raw under msgpack, base64 text
    under JSON): nearly all of a ``kvpages`` frame."""
    return sum(len(kv.get(key) or b"") for key in ("k", "v"))


def replica_main(spec_dict: dict, ready) -> None:
    """Child-process entry (mp spawn target). Reports its listen addr over
    the `ready` pipe, then serves until drain/shutdown. SIGINT and SIGTERM
    request a graceful drain — Ctrl-C on the process group finishes
    in-flight work instead of dropping it; only kill -9 is abrupt."""
    t0 = time.monotonic()
    spec = ReplicaSpec(**spec_dict)
    server = _ReplicaServer(spec)

    def _graceful(_sig, _frm):
        server.draining = True

    signal.signal(signal.SIGINT, _graceful)
    signal.signal(signal.SIGTERM, _graceful)
    server.start_s = time.monotonic() - t0
    ready.send(("addr", list(server.node.addr)))
    ready.close()
    server.run()
    sys.exit(0)
