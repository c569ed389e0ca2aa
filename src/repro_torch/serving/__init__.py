"""PyTorch paged serving engine: `Engine` over the shared
`repro_torch.replica.ReplicaCore` with `TorchPagedBackend`, the OpenAI-ish
request types (copied from `repro.serving.request`), and the in-process
SkyLB router over the port's engines (`InProcessRouter`).

Request/response types import eagerly (they are dependency-light, so the
routing core, the front API and the plane's cost-mode processes use them
without importing torch); the engine, its backend and the router resolve
lazily on first attribute access. The router's lazy import also breaks
the cycle with `repro_torch.routing`, whose core imports
`repro_torch.serving.request`.
"""
from repro_torch.serving.request import (FinishReason, GenRequest, GenResult,
                                         SamplingParams)

__all__ = [
    "Engine", "EngineConfig", "FinishReason", "GenRequest", "GenResult",
    "InProcessRouter", "SamplingParams", "TorchPagedBackend",
]

_LAZY = {
    "Engine": ("repro_torch.serving.engine", "Engine"),
    "EngineConfig": ("repro_torch.serving.engine", "EngineConfig"),
    "TorchPagedBackend": ("repro_torch.serving.torch_backend",
                          "TorchPagedBackend"),
    "InProcessRouter": ("repro_torch.serving.router", "InProcessRouter"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value
