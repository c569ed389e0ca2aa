# Copy of src/repro/plane/chaos.py (no import of the JAX package).
"""Runtime link-fault injection for the serving plane.

A `LinkFault` describes what is wrong with ONE direction-pair of a link
between two live processes.  Faults are applied inside the existing
`Conn` machinery in `mailbox.py` — frames are dropped at the sender
pacer (`drop_send`), discarded on arrival (`drop_recv`, which models an
asymmetric partition from the receiver's point of view), or delayed by
`extra_delay_s` plus a deterministic jitter — so no process restart,
iptables rule, or socket teardown is needed to simulate a WAN blip.

Faults are keyed by remote-peer id in `Node.faults`, NOT stored only on
the live `Conn`: a redial after a blackhole must come back up with the
fault still applied (the network is broken, not the socket).  The host
injects faults by sending a ``chaos`` control frame (see `wire.py`
vocabulary) over the control connection, which is never faulted —
otherwise `heal` could not be delivered.

The fault grammar the drills use:

    blackhole()            drop everything, both directions
    partition_out()        drop only what WE send (asymmetric: we hear
                           the peer, the peer never hears us)
    partition_in()         drop only what we receive (the mirror image)
    delay(extra, jitter)   delay spike: every frame late by
                           ``extra + U(0, jitter)`` seconds
    heal()                 remove the fault (encoded as None on the wire)
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass
class LinkFault:
    """What is currently wrong with a link to one remote peer."""
    drop_send: bool = False      # frames we send never hit the wire
    drop_recv: bool = False      # frames we receive are discarded
    extra_delay_s: float = 0.0   # added to the link's pacing delay
    jitter_s: float = 0.0        # uniform extra [0, jitter_s) per frame

    def is_noop(self) -> bool:
        return (not self.drop_send and not self.drop_recv
                and self.extra_delay_s <= 0.0 and self.jitter_s <= 0.0)

    def sample_delay(self, rng: Optional[random.Random] = None) -> float:
        if self.jitter_s <= 0.0:
            return self.extra_delay_s
        r = rng if rng is not None else random
        return self.extra_delay_s + r.uniform(0.0, self.jitter_s)

    # ------------------------------------------------------------- codec
    def encode(self) -> dict:
        return {"drop_send": self.drop_send, "drop_recv": self.drop_recv,
                "extra_delay_s": self.extra_delay_s,
                "jitter_s": self.jitter_s}

    @staticmethod
    def decode(d: Optional[dict]) -> Optional["LinkFault"]:
        if d is None:
            return None
        return LinkFault(drop_send=bool(d.get("drop_send", False)),
                         drop_recv=bool(d.get("drop_recv", False)),
                         extra_delay_s=float(d.get("extra_delay_s", 0.0)),
                         jitter_s=float(d.get("jitter_s", 0.0)))


# ------------------------------------------------------------ constructors

def blackhole() -> LinkFault:
    """Total partition: nothing in, nothing out."""
    return LinkFault(drop_send=True, drop_recv=True)


def partition_out() -> LinkFault:
    """Asymmetric: our frames vanish, the peer's still arrive."""
    return LinkFault(drop_send=True)


def partition_in() -> LinkFault:
    """Asymmetric: the peer's frames vanish, ours still get through."""
    return LinkFault(drop_recv=True)


def delay(extra_s: float, jitter_s: float = 0.0) -> LinkFault:
    """Delay spike: every frame arrives extra_s (+ jitter) late."""
    return LinkFault(extra_delay_s=float(extra_s), jitter_s=float(jitter_s))


def heal() -> None:
    """The absence of a fault; `None` on the wire and in `Node.faults`."""
    return None
