# Copy of src/repro/frontend/__init__.py (no import of the JAX package).
"""`repro.frontend` — the one front door for every serving substrate.

    from repro_torch.frontend import Client, SimHost          # virtual time
    from repro_torch.frontend import RouterHost, EngineHost   # wall clock

    client = Client(SimHost(system))        # or RouterHost(router), ...
    handle = client.submit(GenRequest(...), region="us")
    for ev in handle.stream():              # TokenEvent{rid, token, index, t}
        ...
    result = handle.result                  # terminal GenResult
    handle.cancel()                         # from any non-terminal state

Lifecycle: QUEUED -> PREFILL -> DECODE -> {FINISHED, CANCELLED, DEADLINE,
ABORT}; per-request `GenRequest.deadline_s` / `slo_class` ride along.
"""
from repro_torch.frontend.api import RequestHandle, RequestState, TokenEvent
from repro_torch.frontend.client import (Client, EngineHost, RouterHost, SimHost,
                                   state_of, wire_gen_request)

__all__ = [
    "Client", "EngineHost", "ProcessHost", "RequestHandle", "RequestState",
    "RouterHost", "SimHost", "TokenEvent", "state_of", "wire_gen_request",
]


def __getattr__(name):
    # The fourth host — Client over the multi-process socket plane — lives
    # in repro.plane and is loaded lazily to keep this package import-light
    # (replica child processes import the plane without the frontend).
    if name == "ProcessHost":
        from repro_torch.plane.host import ProcessHost
        return ProcessHost
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
