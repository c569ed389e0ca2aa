# Copy of src/repro/replica/__init__.py (docstring adapted; no import of
# the JAX package).
"""Backend-agnostic replica scheduler core shared by the discrete-event
simulator and the port's torch paged engine: ReplicaCore owns admission,
KV page accounting, the radix prefix cache, chunked prefill, rejection,
and priority preemption behind the ReplicaBackend protocol. See
repro_torch.replica.core for the full story; the torch backend lives in
repro_torch.serving.torch_backend, the simulator's in
repro_torch.replica.backends.
"""
from repro_torch.replica.blocks import BlockAllocator
from repro_torch.replica.backends import CostModelBackend, CostParams
from repro_torch.replica.core import (ReplicaBackend, ReplicaCore,
                                      ReplicaCoreConfig, Seq, StepPlan)
from repro_torch.replica.hostpool import HostPool
from repro_torch.replica.radix import PagedRadix

__all__ = [
    "BlockAllocator", "CostModelBackend", "CostParams", "HostPool",
    "PagedRadix", "ReplicaBackend", "ReplicaCore", "ReplicaCoreConfig",
    "Seq", "StepPlan",
]
