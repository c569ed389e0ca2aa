"""Backend-agnostic replica scheduler (copy of `repro.replica`'s core):
ReplicaCore owns admission, KV page accounting, the radix prefix cache,
chunked prefill, rejection and priority preemption behind the
ReplicaBackend protocol; the torch backend lives in
repro_torch.serving.torch_backend.
"""
from repro_torch.replica.blocks import BlockAllocator
from repro_torch.replica.core import (ReplicaBackend, ReplicaCore,
                                      ReplicaCoreConfig, Seq, StepPlan)
from repro_torch.replica.hostpool import HostPool
from repro_torch.replica.radix import PagedRadix

__all__ = [
    "BlockAllocator", "HostPool", "PagedRadix", "ReplicaBackend",
    "ReplicaCore", "ReplicaCoreConfig", "Seq", "StepPlan",
]
