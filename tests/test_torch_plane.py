"""The port's multi-process serving plane (`repro_torch.plane`) against the
JAX package's (`repro.plane`).

Frame level: the JAX replica server (``backend="jax"``) and the port's
(``backend="torch"`` on the CPU, given the JAX weights converted) answer
the same attach / deliver / cancel / kvfetch frames with the same admit,
token, result and kvpages frames, and each takes the other's KV payload.
The routing brain over the port's `SocketTransport` decides and sends
what the reference's does on `tests/test_plane.py`'s trace. Then real
processes: torch-backend planes of 2 regions x 1 replica of
qwen3-0.6b-reduced on the CPU stream the tokens an in-process `Engine`
gives on the same seed-0 weights, through a kill -9 of a replica and
through a region partition and its heal; a cost-backend 2 x 2 plane
streams, cancels, expires a deadline and shuts down with every child
exiting 0. Narrower tests hold the port's repairs: `Engine.has_work`, the
LB's `kv_params` after `dataclasses.asdict`, the replica's KV codec and
its guard, which drops a malformed payload but lets a failed import
raise, a re-dispatch onto a replica that still runs the request, the
launcher's device check, and cost-mode processes that never import
torch.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.plane import replica as jreplica
from repro.plane import wire as jwire
from repro.plane.mailbox import Node as JaxNode
from repro.plane.transport import SocketTransport as JaxSocketTransport
from repro.routing import RoutingCore as JaxRoutingCore
from repro.routing import TargetView as JaxTargetView
from repro.routing import build_routing as jax_build_routing
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving.request import GenRequest as JaxGenRequest
from repro.serving.request import SamplingParams as JaxSamplingParams
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.frontend import Client
from repro_torch.models import init_weights
from repro_torch.plane import PlaneConfig, ServingPlane, chaos, wire
from repro_torch.plane import replica as treplica
from repro_torch.plane.lb import LBServer, LBSpec
from repro_torch.plane.mailbox import Node
from repro_torch.plane.transport import SocketTransport
from repro_torch.routing import (KVTransferParams, RoutingCore, TargetView,
                                 build_routing)
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.request import (FinishReason, GenRequest,
                                         SamplingParams)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-0.6b-reduced"
# the replica's EngineConfig (ReplicaSpec's defaults in both packages)
ECFG = dict(page_size=8, n_pages=128, max_batch=4, max_seq_len=1024,
            prefill_pad=32)
TIMES = ("ttft_s", "e2e_s")


# ------------------------------------------------------- frame-level parity

class _Conn:
    """A connection that keeps what the server sends."""

    def __init__(self):
        self.sent: list = []
        self.alive = True
        self.id = None
        self.fault = None

    def send(self, m: dict) -> bool:
        self.sent.append(m)
        return True


def _busy(engine) -> bool:
    c = engine.core
    return bool(c.pending or c.running or c.loading)


def _until_idle(srv) -> None:
    for _ in range(500):
        if not _busy(srv.engine):
            return
        srv.engine.step()
    raise AssertionError("engine never went idle")


def _deliver(wire_mod, Req, SP, rid: int, prompt, max_new: int,
             kv=None) -> dict:
    req = Req(prompt_tokens=tuple(prompt),
              sampling=SP(max_new_tokens=max_new), rid=rid)
    m = wire_mod.msg("deliver", req=wire_mod.encode_request(
        req, deadline=wire_mod.STRIP), origin="us", gen=1)
    if kv is not None:
        m["kv"] = kv
    return m


def _script(srv, wire_mod, Req, SP, prompts) -> list:
    """attach; deliver A and a long C; three steps; cancel C; run to idle;
    deliver B, which extends A's prompt; run to idle; kvfetch B's prompt.
    Returns the frames sent."""
    conn = _Conn()
    srv.handle(conn, wire_mod.msg("attach", id="us", kind="lb"))
    a, b, c = prompts
    for rid, prompt, n in ((501, a, 6), (503, c, 40)):
        srv.handle(conn, _deliver(wire_mod, Req, SP, rid, prompt, n))
    for _ in range(3):
        srv.engine.step()
    srv.handle(conn, wire_mod.msg("cancel", rid=503, reason="cancelled"))
    _until_idle(srv)
    srv.handle(conn, _deliver(wire_mod, Req, SP, 502, b, 6))
    _until_idle(srv)
    srv.handle(conn, wire_mod.msg("kvfetch", rid=504, tokens=list(b),
                                  requester="eu"))
    return conn.sent


def _untimed(frames: list) -> list:
    out = []
    for m in frames:
        if m["t"] == "result":
            m = dict(m, res={k: v for k, v in m["res"].items()
                             if k not in TIMES})
        out.append(m)
    return out


def _kv_arrays(kv: dict) -> tuple:
    return tuple(np.frombuffer(jwire.decode_bytes(kv[key]), kv["dtype"])
                 .reshape(kv[f"{key}_shape"]) for key in ("k", "v"))


@pytest.fixture(scope="module")
def servers():
    """The JAX replica server as `ReplicaSpec(backend="jax")` builds it,
    and the port's on the CPU with an `Engine` over its converted
    weights."""
    jsrv = jreplica._ReplicaServer(jreplica.ReplicaSpec(
        rid="us-r0", region="us", backend="jax"))
    tsrv = treplica._ReplicaServer(treplica.ReplicaSpec(
        rid="us-r0", region="us", backend="torch", device="cpu"))
    tcfg = get_config(ARCH)
    tparams = from_jax_params(jax.tree.map(np.asarray, jsrv.engine.params),
                              tcfg, "cpu", torch.float32)
    tsrv.engine = Engine(tcfg, tparams, EngineConfig(**ECFG), device="cpu")
    yield jsrv, tsrv, tparams
    jsrv.node.close()
    tsrv.node.close()


def test_replica_frames_match_the_reference(servers):
    jsrv, tsrv, _ = servers
    rng = np.random.default_rng(3)
    vocab = get_config(ARCH).vocab
    a = tuple(int(t) for t in rng.integers(1, vocab, size=40))
    b = a + tuple(int(t) for t in rng.integers(1, vocab, size=12))
    c = tuple(int(t) for t in rng.integers(1, vocab, size=30))
    want = _script(jsrv, jwire, JaxGenRequest, JaxSamplingParams, (a, b, c))
    got = _script(tsrv, wire, GenRequest, SamplingParams, (a, b, c))
    kinds = [m["t"] for m in want]
    assert [m["t"] for m in got] == kinds
    assert kinds.count("result") == 3 and kinds[-1] == "kvpages"
    assert _untimed(got[:-1]) == _untimed(want[:-1])
    res = {m["res"]["rid"]: m["res"] for m in want if m["t"] == "result"}
    assert res[503]["finish_reason"] == "cancelled"
    assert res[502]["cached_tokens"] > 0
    gkv, wkv = got[-1]["kv"], want[-1]["kv"]
    meta = ("tokens", "n", "dtype", "k_shape", "v_shape")
    assert {k: gkv[k] for k in meta} == {k: wkv[k] for k in meta}
    assert wkv["n"] == 48 and wkv["dtype"] == "float32"
    assert {k: v for k, v in got[-1].items() if k != "kv"} == \
        {k: v for k, v in want[-1].items() if k != "kv"}
    for g, w in zip(_kv_arrays(gkv), _kv_arrays(wkv)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    # the port's export record holds the frame it sent: payload, whole
    # frame and codec
    frame = wire.pack(got[-1])
    exp = tsrv.kv_exports[-1]
    assert exp["n"] == 48 and exp["bytes"] == treplica._kv_bytes(gkv)
    assert exp["frame_bytes"] == len(frame) > exp["bytes"]
    assert exp["codec"] == {b"M": "msgpack", b"J": "json"}[frame[4:5]]

    # each package takes the other's payload: a fresh engine on each side
    # imports it for a request that extends B, with the same cached tokens
    # and the same tokens out as the other side
    tcfg = get_config(ARCH)
    jsrv.engine = JaxEngine(jsrv.engine.cfg, jsrv.engine.params,
                            JaxEngineConfig(**ECFG))
    tsrv.engine = Engine(tcfg, tsrv.engine.params, EngineConfig(**ECFG),
                         device="cpu")
    d = b + (7, 8, 9)
    outs = []
    for srv, w, Req, SP, kv in ((jsrv, jwire, JaxGenRequest,
                                 JaxSamplingParams, gkv),
                                (tsrv, wire, GenRequest, SamplingParams,
                                 wkv)):
        conn = _Conn()
        srv.handle(conn, w.msg("attach", id="us", kind="lb"))
        srv.handle(conn, _deliver(w, Req, SP, 505, d, 5, kv=kv))
        _until_idle(srv)
        # (attach first resends the unacked results of earlier requests)
        outs.append(next(m["res"] for m in conn.sent if m["t"] == "result"
                         and m["res"]["rid"] == 505))
    assert outs[0]["cached_tokens"] == outs[1]["cached_tokens"] == 48
    assert outs[0]["output_tokens"] == outs[1]["output_tokens"]
    assert tsrv.kv_imports and tsrv.kv_imports[0]["n"] == 48


# ------------------------------------------------------ decision parity

def _drive(core, rids, TV, mkreq):
    """`tests/test_plane.py`'s scripted entry-call trace: probe, local
    dispatches, capacity collapse, cross-region forwards, a cancel."""
    fresh = lambda: [TV(id="us-r0"), TV(id="us-r1")]
    core.refresh_local(fresh())
    core.refresh_remote([TV(id="eu", n_avail_replicas=2, n_replicas=2)])
    for rid in rids[:4]:
        core.on_request(mkreq(rid, (rid % 2, 1, 2, 3)))
    core.refresh_local([TV(id="us-r0", available=False, pending=9,
                           outstanding=9),
                        TV(id="us-r1", available=False, pending=9,
                           outstanding=9)])
    for rid in rids[4:6]:
        core.on_request(mkreq(rid, (rid % 2, 1, 2, 3)))
    core.refresh_remote([TV.unavailable("eu")])
    core.on_request(mkreq(rids[6], (1, 2, 3, 4)))
    core.cancel(rids[6])
    core.refresh_local(fresh())
    core.on_request(mkreq(rids[7], (1, 2, 3, 4)))


def _socket_run(NodeCls, Transport, Core, build, TV, Req, SP) -> tuple:
    """The trace over one LB node with a sink node per target and peer, at
    zero delay: the decision stream and each sink's frames in order."""
    rids = list(range(9100, 9108))
    spec = build("skylb")
    lb_node = NodeCls()
    sinks = {name: NodeCls() for name in ("us-r0", "us-r1", "eu")}
    try:
        for name, sink in sinks.items():
            lb_node.connect(sink.addr, name, delay_s=0.0)
        transport = Transport(lb_node, "us", stale_after_s=60.0)
        core = Core("us", spec.local_policy(), spec.remote_policy(),
                    spec.make_config(record_decisions=True), transport)
        for name in sinks:
            transport.saw(name)
        core.target_added(TV(id="us-r0"))
        core.target_added(TV(id="us-r1"))
        core.peer_added("eu")
        _drive(core, rids, TV, lambda rid, p: Req(
            prompt_tokens=p, sampling=SP(max_new_tokens=4), rid=rid))
        want = sum(1 for d in core.decisions if d[0] in ("local", "forward"))
        seen = {name: [] for name in sinks}
        deadline = time.monotonic() + 5.0
        while (sum(map(len, seen.values())) < want
               and time.monotonic() < deadline):
            for name, sink in sinks.items():
                got = sink.poll(0.01)
                if got is not None and got[1]["t"] in ("deliver", "forward"):
                    seen[name].append(got[1])
        return list(core.decisions), seen
    finally:
        lb_node.close()
        for sink in sinks.values():
            sink.close()


def test_socket_transport_decisions_match_the_reference():
    want = _socket_run(JaxNode, JaxSocketTransport, JaxRoutingCore,
                       jax_build_routing, JaxTargetView, JaxGenRequest,
                       JaxSamplingParams)
    got = _socket_run(Node, SocketTransport, RoutingCore, build_routing,
                      TargetView, GenRequest, SamplingParams)
    assert got == want
    decisions, frames = got
    assert [d for d in decisions if d[0] == "forward"]
    assert [d for d in decisions if d[0] == "cancel"]
    assert sum(map(len, frames.values())) == sum(
        1 for d in decisions if d[0] in ("local", "forward"))


# ------------------------------------------- torch-backend planes (spawned)

def _prompts(n: int, seed: int, lo: int = 20, hi: int = 40) -> list:
    rng = np.random.default_rng(seed)
    vocab = get_config(ARCH).vocab
    return [tuple(int(t) for t in rng.integers(
        1, vocab, size=int(rng.integers(lo, hi)))) for _ in range(n)]


def _reference(prompts: list, max_new: int) -> dict:
    """Greedy tokens of an in-process `Engine` with the replicas' seed-0
    fp32 weights and EngineConfig, by prompt."""
    cfg = get_config(ARCH)
    eng = Engine(cfg, init_weights(cfg, torch.device("cpu")),
                 EngineConfig(**ECFG), device="cpu")
    res = eng.generate([GenRequest(prompt_tokens=p, sampling=SamplingParams(
        max_new_tokens=max_new)) for p in prompts])
    return {p: r.output_tokens for p, r in zip(prompts, res)}


def _torch_plane(monkeypatch, **kw) -> ServingPlane:
    # one intra-op thread a replica: the children share this machine's
    # cores with the other test workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = dict(regions=("eu", "us"), replicas=1, backend="torch",
               arch=ARCH, device="cpu", wan_delay_ms=5.0,
               stale_after_s=0.3)
    cfg.update(kw)
    return ServingPlane(PlaneConfig(**cfg)).start()


def _drain(client, handles, timeout_s) -> list:
    t0 = time.monotonic()
    while any(not h.done for h in handles) \
            and time.monotonic() - t0 < timeout_s:
        client.poll()
    return [h.state.value for h in handles]


def _poll_for(client, seconds: float) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        client.poll()


def _check_streams(handles, ref: dict) -> None:
    """Every request finished once, its streamed tokens (deduped by index
    across replays) and its result equal to the reference's."""
    for h in handles:
        want = ref[h.request.prompt_tokens]
        assert h.state.value == "finished"
        assert h.result.output_tokens == want
        assert [e.index for e in h.events] == list(range(len(want)))
        assert tuple(e.token for e in h.events) == want


def test_torch_plane_streams_the_engines_tokens(monkeypatch):
    prompts = _prompts(6, seed=11)
    ref = _reference(prompts, 8)
    plane = _torch_plane(monkeypatch)
    host = plane.host()
    try:
        client = Client(host)
        hs = [client.submit(GenRequest(prompt_tokens=p, sampling=SamplingParams(
            max_new_tokens=8)), region=("us" if i % 2 else "eu"))
            for i, p in enumerate(prompts)]
        assert _drain(client, hs, 60.0) == ["finished"] * 6
        _check_streams(hs, ref)
        m = plane.metrics()
        assert m["unresolved"] == 0 and m["n_processes"] == 4
        reps = [s for s in m["per_process"] if s.get("kind") == "replica"]
        assert sorted(s["id"] for s in reps) == ["eu-r0", "us-r0"]
        for s in reps:
            assert s["start_s"] > 0 and s["completed"] >= 1
            # the CPU takes the plain versions: no kernel launched
            assert set(s["kernel_launches"].values()) == {0}
            assert s["device"] == "cpu" and s["device_allocated"] == 0
    finally:
        host.close()
        plane.shutdown()


def test_torch_plane_kill9_replica_failover(monkeypatch):
    prompts = _prompts(4, seed=12)
    ref = _reference(prompts, 64)
    plane = _torch_plane(monkeypatch)
    host = plane.host()
    try:
        client = Client(host)
        hs = [client.submit(GenRequest(prompt_tokens=p, sampling=SamplingParams(
            max_new_tokens=64)), region="us") for p in prompts]
        t0 = time.monotonic()
        while not any(h.events for h in hs) and time.monotonic() - t0 < 30:
            client.poll()
        assert any(h.events for h in hs), "no request started in time"
        assert not all(h.done for h in hs)
        plane.kill_replica("us-r0")         # a real SIGKILL mid-decode
        assert _drain(client, hs, 60.0) == ["finished"] * 4
        _check_streams(hs, ref)
        assert host.counters()["duplicate_results"] == 0
        m = plane.metrics()
        assert m["redispatched"] >= 1
        assert m["unresolved"] == 0
        us = next(s for s in m["per_process"]
                  if s.get("kind") == "lb" and s["id"] == "us")
        assert any("failover us-r0" in e for e in us["events"])
    finally:
        host.close()
        plane.shutdown()


def test_torch_plane_partition_and_heal(monkeypatch):
    prompts = _prompts(6, seed=13)
    ref = _reference(prompts, 200)
    plane = _torch_plane(monkeypatch, stale_after_s=0.25,
                         partition_grace_s=0.3)
    host = plane.host()
    try:
        client = Client(host)
        hs = [client.submit(GenRequest(prompt_tokens=p, sampling=SamplingParams(
            max_new_tokens=200)), region=("us" if i % 2 else "eu"))
            for i, p in enumerate(prompts)]
        t0 = time.monotonic()
        while not all(h.events for h in hs) and time.monotonic() - t0 < 30:
            client.poll()
        assert all(h.events for h in hs), "not all requests started"
        assert plane.isolate_region("us")
        host.node.set_fault("us", chaos.blackhole())
        _poll_for(client, 3 * plane.cfg.stale_after_s)
        assert host.rehomed >= 1, "client must have re-homed us strays"
        host.node.set_fault("us", None)
        assert plane.heal_region("us")
        assert _drain(client, hs, 60.0) == ["finished"] * 6
        _check_streams(hs, ref)
        t0 = time.monotonic()
        while host.counters()["fenced_frames"] < 1 \
                and time.monotonic() - t0 < 15:
            _poll_for(client, 0.25)
        counters = host.counters()
        assert counters["fenced_frames"] >= 1, \
            "the zombie region's post-heal frames must be fenced"
        assert counters["duplicate_results"] == 0
        assert plane.metrics()["unresolved"] == 0
    finally:
        host.close()
        plane.shutdown()


# ------------------------------------------------- cost-backend plane 2 x 2

def _req(prompt, max_new: int, **kw) -> GenRequest:
    return GenRequest(prompt_tokens=tuple(prompt),
                      sampling=SamplingParams(max_new_tokens=max_new), **kw)


def test_cost_plane_2x2_streaming_cancel_deadline_shutdown():
    import multiprocessing as mp
    plane = ServingPlane(PlaneConfig(
        regions=("eu", "us"), replicas=2, wan_delay_ms=5.0, time_scale=0.01,
        stale_after_s=0.3)).start()
    host = plane.host()
    try:
        client = Client(host)
        hs = [client.submit(_req(range(i, i + 20), 6),
                            region=("us" if i % 2 else "eu"))
              for i in range(6)]
        assert _drain(client, hs, 30.0) == ["finished"] * 6
        for h in hs:
            assert [e.index for e in h.events] == list(range(6))
            assert len(h.result.output_tokens) == 6
        hc = client.submit(_req(range(40, 70), 500), region="us")
        t0 = time.monotonic()
        while not hc.events and time.monotonic() - t0 < 10:
            client.poll()
        assert hc.cancel()
        assert _drain(client, [hc], 30.0) == ["cancelled"]
        hd = client.submit(_req(range(70, 100), 900, deadline_s=0.1),
                           region="us")
        assert _drain(client, [hd], 30.0) == ["deadline"]
        assert hd.result.finish_reason == FinishReason.DEADLINE
        he = client.submit(_req((1, 2, 3, 4), 4, deadline_s=-1.0),
                           region="us")
        assert he.done and he.state.value == "deadline"
        m = plane.metrics()
        assert m["unresolved"] == 0 and m["n_processes"] == 6
        reps = [s for s in m["per_process"] if s.get("kind") == "replica"]
        assert reps and all("kernel_launches" not in s for s in reps)
    finally:
        host.close()
        plane.shutdown()
    for name, p in plane.procs.items():
        assert p.exitcode == 0, f"{name} exited {p.exitcode}"
    assert not mp.active_children()


# ------------------------------------------------------------ the repairs

def test_engine_has_work():
    """The replica loop asks `has_work()` before it steps; the JAX
    package's `Engine` lacks it, so its `jax` replicas cannot run."""
    cfg = get_config(ARCH)
    eng = Engine(cfg, init_weights(cfg, torch.device("cpu")),
                 EngineConfig(**ECFG), device="cpu")
    assert not eng.has_work()
    eng.submit(_req(range(1, 20), 3))
    assert eng.has_work()
    eng.run_until_idle()
    assert not eng.has_work() and len(eng.results) == 1
    assert not hasattr(JaxEngine, "has_work")


def test_lb_rebuilds_kv_params_after_asdict():
    params = KVTransferParams(prefill_tps=100.0, min_pull_tokens=8)
    spec = LBSpec(region="us", cfg_overrides=(
        ("kv_transfer", True), ("kv_params", params)))
    shipped = dataclasses.asdict(spec)          # what ServingPlane sends
    assert isinstance(dict(shipped["cfg_overrides"])["kv_params"], dict)
    lb = LBServer(LBSpec(**shipped))
    try:
        assert lb.core.cfg.kv_params == params
        assert lb.core.cfg.kv_transfer
    finally:
        lb.node.close()


def _torch_server():
    return treplica._ReplicaServer(treplica.ReplicaSpec(
        rid="us-r0", region="us", backend="torch", device="cpu"))


def _cached_prompt(srv, n_tokens: int) -> tuple:
    prompt = tuple(range(3, 3 + n_tokens))
    srv.engine.generate([_req(prompt, 2)])
    return prompt


def test_kv_codec_round_trip_imports():
    src, dst = _torch_server(), _torch_server()
    try:
        prompt = _cached_prompt(src, 40)
        n, k, v = src.engine.export_prefix(prompt)
        payload = treplica._encode_kv(prompt, n, k, v)
        assert payload["dtype"] == "float32" and n == 40
        k2, v2 = treplica._decode_kv_arrays(
            wire.unpack(wire.pack(payload)[4:]))
        assert isinstance(k2, torch.Tensor) and k2.device.type == "cpu"
        assert torch.equal(k2, k) and torch.equal(v2, v)
        k2.add_(0)                                  # writable
        assert dst.engine.import_prefix(prompt[:n], k2, v2) == 40
        assert dst.engine.export_prefix(prompt)[0] == 40
        assert torch.equal(dst.engine.export_prefix(prompt)[1], k)
    finally:
        src.node.close()
        dst.node.close()


@pytest.mark.parametrize("bad", ["dtype", "shape", "bytes", "keys"])
def test_malformed_kv_payload_is_dropped(bad):
    src, dst = _torch_server(), _torch_server()
    try:
        prompt = _cached_prompt(src, 32)
        kv = treplica._encode_kv(prompt, *src.engine.export_prefix(prompt))
        if bad == "dtype":
            kv["dtype"] = "float16"
        elif bad == "shape":
            kv["k_shape"] = kv["v_shape"] = [2, *kv["k_shape"][1:-1],
                                             2 * kv["k_shape"][-1]]
        elif bad == "bytes":
            kv["k"] = wire.encode_bytes(wire.decode_bytes(kv["k"])[:-4])
        else:
            del kv["v_shape"]
        conn = _Conn()
        dst.handle(conn, wire.msg("attach", id="us", kind="lb"))
        dst.handle(conn, _deliver(wire, GenRequest, SamplingParams, 601,
                                  prompt + (5, 6), 3, kv=kv))
        assert dst.kv_dropped == 1 and not dst.kv_imports
        _until_idle(dst)
        res = next(m["res"] for m in conn.sent if m["t"] == "result")
        assert res["finish_reason"] == "length" and res["cached_tokens"] == 0
    finally:
        src.node.close()
        dst.node.close()


def test_failed_kv_import_is_not_swallowed(monkeypatch):
    src, dst = _torch_server(), _torch_server()
    try:
        prompt = _cached_prompt(src, 32)
        kv = treplica._encode_kv(prompt, *src.engine.export_prefix(prompt))

        def broken(tokens, k, v):
            raise RuntimeError("page_scatter failed to launch")

        monkeypatch.setattr(dst.engine, "import_prefix", broken)
        conn = _Conn()
        dst.handle(conn, wire.msg("attach", id="us", kind="lb"))
        with pytest.raises(RuntimeError, match="page_scatter"):
            dst.handle(conn, _deliver(wire, GenRequest, SamplingParams, 602,
                                      prompt + (5, 6), 3, kv=kv))
    finally:
        src.node.close()
        dst.node.close()


def test_redispatch_onto_the_same_replica_streams_again():
    """The LB presumed the replica dead, fenced its generation and sent the
    request back to it while the first copy ran: the second copy streams
    every token under the new generation and the first copy goes silent."""
    srv = _torch_server()
    try:
        conn = _Conn()
        srv.handle(conn, wire.msg("attach", id="us", kind="lb"))
        first = _deliver(wire, GenRequest, SamplingParams, 701,
                         tuple(range(2, 30)), 8)
        srv.handle(conn, first)
        for _ in range(3):
            srv.engine.step()
        again = dict(first, gen=2)
        srv.handle(conn, again)
        _until_idle(srv)
        by_gen = {g: [m for m in conn.sent if m.get("gen") == g]
                  for g in (1, 2)}
        assert [m["t"] for m in by_gen[1]] == ["admit", "token", "token",
                                               "token"]
        toks = [m for m in by_gen[2] if m["t"] == "token"]
        assert [m["idx"] for m in toks] == list(range(8))
        res = [m["res"] for m in by_gen[2] if m["t"] == "result"]
        assert len(res) == 1 and res[0]["output_tokens"] == \
            [m["tok"] for m in toks]
        assert [m["tok"] for m in by_gen[1][1:]] == \
            [m["tok"] for m in toks[:3]]
    finally:
        srv.node.close()


def test_torch_plane_without_a_card_raises_before_spawning():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    plane = ServingPlane(PlaneConfig(backend="torch"))
    with pytest.raises(RuntimeError, match="CUDA"):
        plane.start()
    assert not plane.procs
    plane.node.close()


def test_cost_mode_processes_import_no_torch():
    code = ("import sys\n"
            "import repro_torch.plane.lb, repro_torch.plane.replica\n"
            "import repro_torch.plane.host, repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
