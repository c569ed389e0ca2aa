# Copy of src/repro/plane/wire.py (no import of the JAX package).
"""Wire codec for the multi-process serving plane.

Every message on a plane socket is one FRAME:

    4-byte big-endian payload length | 1-byte codec tag | payload

The tag makes each frame self-describing (``M`` = msgpack, ``J`` = JSON),
so a JSON-only peer can always decode what it receives; senders prefer
msgpack when the import succeeds and can be forced with
``REPRO_PLANE_CODEC=json``.  Payloads are plain dicts with a ``"t"`` type
field — the full vocabulary of the plane:

    hello/attach       connection handshake (who is dialing, their id/kind)
    submit             client -> LB: a GenRequest enters the system
    deliver            LB -> replica: dispatch (deadline STRIPPED — see below)
    forward            LB -> LB: cross-region forward / steal release / hedge
    token/admit/result the request lifecycle flowing back to the client
    hb / rhb           replica heartbeat / LB remote heartbeat (TargetView)
    steal              thief LB asks a victim LB to release queued work
    cancel             cancel/deadline propagation (idempotent per rid)
    kvpull/kvfetch/    cross-region KV-prefix transfer (request, replica
    kvpages            export, payload back)
    chaos              host -> process: install/heal a LinkFault on the
                       link to ``target`` (never sent over a faulted
                       link — the control conn is exempt from chaos)
    resack             receiver -> sender ack for a terminal ``result``
                       frame; the sender resends unacked results on
                       reconnect until the resack arrives (heal never
                       loses a finished request)
    ping/pong          client <-> LB liveness probe (a blackholed LB
                       produces no EOF, so the client needs its own
                       freshness signal to re-home requests)
    drain/shutdown/bye graceful lifecycle; ``bye`` carries a final metrics
    metrics?/metrics   Ray-Serve-style per-process snapshot on demand

Fencing fields: ``deliver`` frames carry ``gen`` — the LB's per-target
generation, bumped on every `_declare_dead` — and replicas echo it on
``admit``/``token``/``result`` so a healed zombie's frames (stamped with
a pre-death generation) are discarded exactly once at the LB.

Deadline clock ownership (the cross-process rule): ``time.monotonic()``
has a PER-PROCESS epoch, so an ``arrival_s`` stamped in one process is
meaningless in another — naively re-judging ``now - arrival_s > deadline_s``
in a replica process would abort (or never abort) requests on clock skew.
The codec therefore enforces the rule at the encoding layer:

  * ``encode_request(req, deadline="strip")`` — used for LB -> replica
    ``deliver`` frames: the replica NEVER sees a deadline and never judges
    one; the accepting LB tracks expiry on its own clock and sends an
    explicit ``cancel`` frame when it fires.
  * ``encode_request(req, deadline="remaining", now=...)`` — used for
    LB -> LB ``forward`` frames: the sender converts its absolute view into
    a duration (``deadline_s`` minus time already spent since its own
    ``arrival_s`` stamp) and the RECEIVING LB re-stamps ``arrival_s`` on its
    own clock, becoming the new deadline owner.
  * ``encode_request(req, deadline="keep")`` — client -> LB ``submit``
    frames: nothing elapsed yet; the accepting LB stamps arrival.

Decoded requests always come back with ``arrival_s=None`` and all callback
slots empty (callbacks never cross a process boundary).
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Optional

from repro_torch.serving.request import (FinishReason, GenRequest, GenResult,
                                   SamplingParams)

try:                                            # optional speed-up
    import msgpack as _msgpack
except ImportError:                             # pragma: no cover
    _msgpack = None

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024        # sanity bound against corrupt streams


def _use_msgpack() -> bool:
    if os.environ.get("REPRO_PLANE_CODEC", "").lower() == "json":
        return False
    return _msgpack is not None


# ------------------------------------------------------------------ frames

def pack(msg: dict) -> bytes:
    """One frame (length prefix + codec tag + payload) for `msg`."""
    if _use_msgpack():
        body = b"M" + _msgpack.packb(msg, use_bin_type=True)
    else:
        body = b"J" + json.dumps(msg, separators=(",", ":")).encode()
    return _LEN.pack(len(body)) + body


def unpack(body: bytes) -> dict:
    """Decode one frame payload (without the length prefix)."""
    tag, payload = body[:1], body[1:]
    if tag == b"M":
        if _msgpack is None:
            raise ValueError("received a msgpack frame without msgpack")
        return _msgpack.unpackb(payload, raw=False)
    if tag == b"J":
        return json.loads(payload.decode())
    raise ValueError(f"unknown codec tag {tag!r}")


def read_frame(sock) -> Optional[dict]:
    """Blocking read of one frame from a socket; None on clean EOF."""
    head = _read_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if not 0 < n <= MAX_FRAME:
        raise ValueError(f"bad frame length {n}")
    body = _read_exact(sock, n)
    if body is None:
        return None
    return unpack(body)


def _read_exact(sock, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


# ------------------------------------------------------------- GenRequest

#: wire deadline modes (see module docstring)
KEEP, REMAINING, STRIP = "keep", "remaining", "strip"


def encode_request(req: GenRequest, *, deadline: str = KEEP,
                   now: Optional[float] = None) -> dict:
    """GenRequest -> wire dict. Callback slots never cross the wire; the
    `deadline` mode implements the clock-ownership rule (module docstring).
    """
    if deadline == STRIP:
        dl = None
    elif deadline == REMAINING:
        dl = req.deadline_s
        if dl is not None and req.arrival_s is not None and now is not None:
            dl = dl - (now - req.arrival_s)
    elif deadline == KEEP:
        dl = req.deadline_s
    else:
        raise ValueError(f"unknown deadline mode {deadline!r}")
    d = {
        "rid": req.rid,
        "prompt_tokens": list(req.prompt_tokens),
        "sampling": dataclasses.asdict(req.sampling),
        "user_id": req.user_id,
        "session_key": req.session_key,
        "priority": req.priority,
        "tenant_weight": req.tenant_weight,
        "deadline_s": dl,
        "slo_class": req.slo_class,
        "cancelled": req.cancelled,
        "cached_tokens": req.cached_tokens,
        "forwarded": bool(getattr(req, "forwarded", False)),
    }
    # predetermined completion (cost-backend replicas replay it; absent on
    # real-engine requests)
    out = getattr(req, "output_tokens", None)
    if out:
        d["output_tokens"] = list(out)
    return d


def decode_request(d: dict) -> GenRequest:
    """Wire dict -> GenRequest. `arrival_s` is always None — the ACCEPTING
    process stamps it from its own clock — and callbacks are empty."""
    req = GenRequest(
        prompt_tokens=tuple(d["prompt_tokens"]),
        sampling=SamplingParams(**d["sampling"]),
        rid=d["rid"],
        user_id=d.get("user_id", ""),
        session_key=d.get("session_key", ""),
        priority=d.get("priority", 0),
        tenant_weight=d.get("tenant_weight", 1.0),
        deadline_s=d.get("deadline_s"),
        slo_class=d.get("slo_class", "standard"),
        cancelled=d.get("cancelled"),
        cached_tokens=d.get("cached_tokens", 0),
    )
    if d.get("forwarded"):
        req.forwarded = True
    if d.get("output_tokens"):
        req.output_tokens = tuple(d["output_tokens"])
    return req


# -------------------------------------------------------------- GenResult

def encode_result(res: GenResult) -> dict:
    return {
        "rid": res.rid,
        "output_tokens": list(res.output_tokens),
        "finish_reason": res.finish_reason.value,
        "cached_tokens": res.cached_tokens,
        "prompt_len": res.prompt_len,
        "ttft_s": res.ttft_s,
        "e2e_s": res.e2e_s,
        "error": res.error,
    }


def decode_result(d: dict) -> GenResult:
    return GenResult(
        rid=d["rid"],
        output_tokens=tuple(d["output_tokens"]),
        finish_reason=FinishReason(d["finish_reason"]),
        cached_tokens=d["cached_tokens"],
        prompt_len=d["prompt_len"],
        ttft_s=d.get("ttft_s"),
        e2e_s=d.get("e2e_s"),
        error=d.get("error"),
    )


# ------------------------------------------------------------- TargetView

def encode_view(view) -> dict:
    d = {"id": view.id, "outstanding": view.outstanding,
         "pending": view.pending, "available": view.available,
         "queue_len": view.queue_len,
         "n_avail_replicas": view.n_avail_replicas,
         "n_replicas": view.n_replicas}
    # fairness ledgers ride heartbeats only when fairness is on — frames
    # from older peers (no key) decode fine via the TargetView default
    if getattr(view, "tenant_counters", None):
        d["tenant_counters"] = dict(view.tenant_counters)
    return d


def decode_view(d: dict):
    from repro_torch.routing.policies import TargetView
    return TargetView(**d)


# ---------------------------------------------------------------- helpers

def msg(t: str, **fields: Any) -> dict:
    """Tiny constructor: msg("cancel", rid=3, reason="deadline")."""
    fields["t"] = t
    return fields


def encode_chaos(target: str, fault) -> dict:
    """Chaos control frame: install `fault` (a LinkFault, or None to
    heal) on the receiving process's link to `target` ("*" = every
    known link)."""
    return {"t": "chaos", "target": target,
            "fault": None if fault is None else fault.encode()}


def decode_chaos(d: dict):
    from repro_torch.plane.chaos import LinkFault
    return d.get("target", "*"), LinkFault.decode(d.get("fault"))


def encode_bytes(b: bytes):
    """Binary payloads (KV pages): raw under msgpack, base64 under JSON."""
    if _use_msgpack():
        return b
    import base64
    return "b64:" + base64.b64encode(b).decode("ascii")


def decode_bytes(x) -> bytes:
    if isinstance(x, bytes):
        return x
    if isinstance(x, str) and x.startswith("b64:"):
        import base64
        return base64.b64decode(x[4:])
    raise ValueError(f"not a wire-encoded byte payload: {type(x)}")
