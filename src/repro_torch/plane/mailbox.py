# Copy of src/repro/plane/mailbox.py (no import of the JAX package).
"""Socket plumbing for the serving plane: framed, paced, bidirectional
connections plus one inbox per process.

`Node` owns a listening TCP socket (127.0.0.1, OS-assigned port) and a
single `queue.Queue` inbox.  Every connection — dialed or accepted — is a
`Conn`: a reader thread decodes frames into the owner's inbox as
``(conn, msg)`` tuples, and a paced sender thread writes queued frames to
the socket **after the link's delay** — this is where WAN latency is
injected, at the SENDER, per link (`delay_s`), exactly like the tick
router's `wan_delay_ticks` but on the wall clock and a real wire.  Frames
on one conn keep FIFO order (equal delays can't reorder; the pacer heap
tie-breaks on enqueue sequence).

Chaos faults ride the same machinery: a `LinkFault` (see `chaos.py`)
attached to a conn drops frames at the pacer (`drop_send`), discards
inbound frames before they reach the inbox (`drop_recv` — the receiving
half of an asymmetric partition), or stretches the pacing delay
(`extra_delay_s` + jitter).  Faults are keyed by REMOTE ID in
`Node.faults`, so a redialed conn comes back up with the fault still
applied — the network is broken, not the socket.

A dead peer (EOF, reset, refused) surfaces as a ``{"t": "_lost"}`` inbox
message so the single-threaded owner loop handles connection failure the
same way it handles any other event.  Lost dialed conns can be redialed:
`Node.connect` records the dial info, `schedule_redial` arms an
exponential-backoff-with-jitter retry, and `maybe_redial` (called from
the owner's timer path) re-establishes the link and re-sends the hello.
All threads are daemons: a process that decides to exit never blocks on
its sockets.
"""
from __future__ import annotations

import heapq
import itertools
import queue
import random
import socket
import threading
import time
from typing import Optional

from repro_torch.plane import wire
from repro_torch.plane.chaos import LinkFault


class Conn:
    """One framed bidirectional connection with sender-side pacing."""

    def __init__(self, sock: socket.socket, inbox: "queue.Queue", *,
                 delay_s: float = 0.0, label: str = "",
                 owner: Optional["Node"] = None):
        self.sock = sock
        self.inbox = inbox
        self.delay_s = float(delay_s)
        self.label = label
        self.id: Optional[str] = None       # set once the peer is known
        self.alive = True
        self.owner = owner
        self.fault: Optional[LinkFault] = None
        self._lock = threading.Condition()
        self._outq: list = []               # (due, seq, frame_bytes)
        self._seq = itertools.count()
        self._closing = False
        self._sender = threading.Thread(target=self._send_loop, daemon=True)
        self._reader = threading.Thread(target=self._recv_loop, daemon=True)
        self._sender.start()
        self._reader.start()

    # ------------------------------------------------------------- sending
    def send(self, msg: dict) -> bool:
        """Queue `msg`; it hits the wire `delay_s` from NOW (the message is
        frozen — encoded — at call time, like a packet leaving the NIC)."""
        if not self.alive:
            return False
        frame = wire.pack(msg)
        fault = self.fault
        extra = fault.sample_delay() if fault is not None else 0.0
        with self._lock:
            heapq.heappush(self._outq,
                           (time.monotonic() + self.delay_s + extra,
                            next(self._seq), frame))
            self._lock.notify()
        return True

    def _send_loop(self) -> None:
        while True:
            with self._lock:
                while not self._outq and not self._closing:
                    self._lock.wait()
                if self._closing and not self._outq:
                    return
                due, _, frame = self._outq[0]
                wait = due - time.monotonic()
                if wait > 0:
                    self._lock.wait(timeout=wait)
                    continue
                heapq.heappop(self._outq)
            fault = self.fault
            if fault is not None and fault.drop_send:
                # blackhole / outbound partition: the frame dies at the
                # pacer, exactly where a real NIC would drop it
                if self.owner is not None:
                    self.owner.fault_dropped_send += 1
                continue
            try:
                self.sock.sendall(frame)
            except OSError:
                self._mark_lost()
                return

    # ----------------------------------------------------------- receiving
    def _recv_loop(self) -> None:
        while True:
            try:
                msg = wire.read_frame(self.sock)
            except (OSError, ValueError):
                msg = None
            if msg is None:
                self._mark_lost()
                return
            fault = self.fault
            if fault is not None and fault.drop_recv:
                # inbound half of an asymmetric partition: the frame made
                # it over the wire but "the path back is down"
                if self.owner is not None:
                    self.owner.fault_dropped_recv += 1
                continue
            self.inbox.put((self, msg))

    def _mark_lost(self) -> None:
        if self.alive:
            self.alive = False
            if not self._closing:
                self.inbox.put((self, {"t": "_lost", "id": self.id}))

    # -------------------------------------------------------------- close
    def close(self) -> None:
        self._closing = True
        self.alive = False
        with self._lock:
            self._lock.notify()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class Node:
    """A process's socket endpoint: listener + inbox + peer table."""

    #: startup-dial retry schedule (satellite: a replica slow to bind its
    #: listener must not fail plane wiring with a raw ConnectionRefusedError)
    CONNECT_RETRIES = 20
    CONNECT_BACKOFF_S = 0.05

    #: redial backoff (lost links, driven by the owner loop)
    REDIAL_BASE_S = 0.05
    REDIAL_MAX_S = 1.0

    def __init__(self, host: str = "127.0.0.1"):
        self.inbox: queue.Queue = queue.Queue()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(64)
        self.addr = self._listener.getsockname()     # (host, port)
        self.conns: list[Conn] = []
        self.by_id: dict[str, Conn] = {}
        # chaos state: faults survive conn churn (keyed by remote id) and
        # drop counters feed the metrics snapshot
        self.faults: dict[str, LinkFault] = {}
        self.fault_dropped_send = 0
        self.fault_dropped_recv = 0
        # redial state: remote_id -> {"due": t, "attempt": n}
        self.dial_info: dict[str, tuple] = {}        # id -> (addr, hello, delay)
        self._redial: dict[str, dict] = {}
        self.reconnects = 0
        self._closing = False
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._acceptor.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.conns.append(Conn(sock, self.inbox, owner=self))

    # ------------------------------------------------------------- dialing
    def connect(self, addr, remote_id: str, *, delay_s: float = 0.0,
                hello: Optional[dict] = None,
                timeout: float = 5.0,
                retries: Optional[int] = None) -> Conn:
        """Dial `addr`, register the conn under `remote_id`, and send the
        `hello` frame (how the remote learns who we are).  Refused dials
        are retried with backoff up to `retries` times — the remote may
        simply not have bound its listener yet."""
        if retries is None:
            retries = self.CONNECT_RETRIES
        attempt = 0
        while True:
            try:
                sock = socket.create_connection(tuple(addr), timeout=timeout)
                break
            except OSError:
                if attempt >= retries or self._closing:
                    raise
                time.sleep(min(0.5, self.CONNECT_BACKOFF_S * (1.5 ** attempt)))
                attempt += 1
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = Conn(sock, self.inbox, delay_s=delay_s, label=remote_id,
                    owner=self)
        conn.id = remote_id
        conn.fault = self.faults.get(remote_id)
        self.conns.append(conn)
        self.by_id[remote_id] = conn
        self.dial_info[remote_id] = (tuple(addr), hello, delay_s)
        if hello is not None:
            conn.send(hello)
        return conn

    def register(self, conn: Conn, remote_id: str) -> None:
        """Bind an ACCEPTED conn to an id (on receiving its hello)."""
        conn.id = remote_id
        conn.fault = self.faults.get(remote_id)
        self.by_id[remote_id] = conn

    def send_to(self, remote_id: str, msg: dict) -> bool:
        conn = self.by_id.get(remote_id)
        return bool(conn is not None and conn.alive and conn.send(msg))

    def drop(self, remote_id: str) -> None:
        conn = self.by_id.pop(remote_id, None)
        if conn is not None:
            conn.close()

    # --------------------------------------------------------------- chaos
    def set_fault(self, remote_id: str, fault: Optional[LinkFault]) -> None:
        """Install (or heal, with None) a fault on the link to `remote_id`.
        Applies to the live conn immediately and persists across redials."""
        if fault is None or fault.is_noop():
            self.faults.pop(remote_id, None)
            fault = None
        else:
            self.faults[remote_id] = fault
        for conn in self.conns:
            if conn.id == remote_id:
                conn.fault = fault

    # ------------------------------------------------------------- redial
    def schedule_redial(self, remote_id: str,
                        now: Optional[float] = None) -> bool:
        """Arm a reconnect for a previously dialed peer (no-op for
        accepted conns we never dialed, or an already-armed redial)."""
        if remote_id not in self.dial_info or self._closing:
            return False
        if remote_id in self._redial:
            return True
        if now is None:
            now = time.monotonic()
        base = self.REDIAL_BASE_S
        self._redial[remote_id] = {
            "due": now + base + random.uniform(0, 0.5 * base),
            "attempt": 0,
        }
        return True

    def maybe_redial(self, now: Optional[float] = None) -> list[str]:
        """Attempt any due redials; returns ids that reconnected.  The
        owner loop calls this from its timer path and re-runs its own
        hello logic (`saw`, re-attach) for each returned id."""
        if not self._redial or self._closing:
            return []
        if now is None:
            now = time.monotonic()
        reconnected = []
        for rid in list(self._redial):
            st = self._redial[rid]
            if now < st["due"]:
                continue
            cur = self.by_id.get(rid)
            if cur is not None and cur.alive:
                del self._redial[rid]
                continue
            addr, hello, delay_s = self.dial_info[rid]
            try:
                self.connect(addr, rid, delay_s=delay_s, hello=hello,
                             timeout=1.0, retries=0)
            except OSError:
                st["attempt"] += 1
                base = min(self.REDIAL_MAX_S,
                           self.REDIAL_BASE_S * (2 ** st["attempt"]))
                st["due"] = now + base + random.uniform(0, 0.5 * base)
                continue
            del self._redial[rid]
            self.reconnects += 1
            reconnected.append(rid)
        return reconnected

    def cancel_redial(self, remote_id: str) -> None:
        self._redial.pop(remote_id, None)

    # --------------------------------------------------------------- poll
    def poll(self, timeout: Optional[float] = 0.0) -> Optional[tuple]:
        """Next (conn, msg), or None when the inbox stays empty for
        `timeout` seconds (0 = non-blocking)."""
        try:
            if timeout is None:
                return self.inbox.get()
            return self.inbox.get(timeout=timeout) if timeout > 0 \
                else self.inbox.get_nowait()
        except queue.Empty:
            return None

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        for conn in self.conns:
            conn.close()
