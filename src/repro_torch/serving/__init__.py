"""PyTorch paged serving engine: `Engine` over the shared
`repro_torch.replica.ReplicaCore` with `TorchPagedBackend`, and the
OpenAI-ish request types (copied from `repro.serving.request`)."""
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import (FinishReason, GenRequest, GenResult,
                                         SamplingParams)
from repro_torch.serving.torch_backend import TorchPagedBackend

__all__ = [
    "Engine", "EngineConfig", "FinishReason", "GenRequest", "GenResult",
    "SamplingParams", "TorchPagedBackend",
]
