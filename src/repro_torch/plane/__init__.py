# Copy of src/repro/plane/__init__.py (docstring adapted; no import of the
# JAX package).
"""The multi-process serving plane (port of `repro.plane`): the
`repro_torch.routing.Transport` protocol over real sockets, engines in
their own OS processes, wall-clock WAN delay injection, and crash drills
on real PIDs.

    wire       framed msgpack-or-JSON codec + the deadline clock-ownership
               rule (who may judge `deadline_s`, and on whose clock)
    mailbox    Conn/Node: framed, sender-paced (WAN delay) connections and
               the one-inbox-per-process recv model; redial-with-backoff
               and per-link chaos fault application live here
    chaos      LinkFault + constructors (blackhole/partition/delay/heal):
               runtime link-fault injection, no process restart needed
    transport  SocketTransport — the Transport protocol over a Node
    replica    ReplicaProcess: an engine (cost-model, or the port's torch
               `Engine` on the card or the CPU) + recv loop + heartbeat
               publisher in a spawned process
    lb         LBProcess: one RoutingCore per region over SocketTransport
    host       ServingPlane (launcher/control) + ProcessHost (the
               frontend.Client adapter)
    metrics    per-process snapshot merge into the RunMetrics schema

The tick-based `repro_torch.serving.router.InProcessRouter` remains the
deterministic-parity reference for the same RoutingCore; this package is
the same brain on real wires (tests assert the decision streams match).
"""
from repro_torch.plane.chaos import (LinkFault, blackhole, delay,
                                     partition_in, partition_out)
from repro_torch.plane.host import PlaneConfig, ProcessHost, ServingPlane
from repro_torch.plane.lb import LBServer, LBSpec
from repro_torch.plane.metrics import merge_snapshots
from repro_torch.plane.replica import CostEngine, ReplicaSpec
from repro_torch.plane.transport import SocketTransport

__all__ = [
    "PlaneConfig", "ProcessHost", "ServingPlane",
    "LBServer", "LBSpec", "merge_snapshots",
    "CostEngine", "ReplicaSpec", "SocketTransport",
    "LinkFault", "blackhole", "delay", "partition_in", "partition_out",
]
