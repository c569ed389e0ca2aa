"""PyTorch paged serving engine: `Engine` over the shared
`repro_torch.replica.ReplicaCore` with `TorchPagedBackend`, the OpenAI-ish
request types (copied from `repro.serving.request`), and the in-process
SkyLB router over the port's engines (`InProcessRouter`).

`InProcessRouter` resolves lazily on first attribute access: the routing
core imports `repro_torch.serving.request`, so an eager import here would
be circular when `repro_torch.routing` is imported first.
"""
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import (FinishReason, GenRequest, GenResult,
                                         SamplingParams)
from repro_torch.serving.torch_backend import TorchPagedBackend

__all__ = [
    "Engine", "EngineConfig", "FinishReason", "GenRequest", "GenResult",
    "InProcessRouter", "SamplingParams", "TorchPagedBackend",
]


def __getattr__(name: str):
    if name != "InProcessRouter":
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    from repro_torch.serving.router import InProcessRouter
    globals()[name] = InProcessRouter
    return InProcessRouter
