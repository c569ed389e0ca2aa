# Copy of src/repro/tenancy/__init__.py (no import of the JAX package).
"""Multi-tenant fairness & admission control (ROADMAP open item 1).

Three pure decision surfaces, deliberately clock-free so the simulator,
the in-process router, and the socket plane reach byte-identical verdicts
from identical state (the same discipline as `repro.routing.hedging` and
`repro.routing.kvtransfer`):

* `discipline`  — pluggable replica queue disciplines (`QueueDiscipline`);
  FCFS (the default, byte-identical to the pre-subsystem behavior) plus
  Virtual-Token-Counter fair queueing and its per-tenant-weighted variant.
* `ledger`      — the router-level counterpart: per-tenant service
  counters that ride heartbeats so every LB converges on the same view.
* `admission`   — deadline-aware shedding: reject at admission (a distinct
  `FinishReason.SHED`) when the predicted queueing delay already exceeds
  the request's deadline, instead of burning prefill on a lost cause.
"""
from repro_torch.tenancy.admission import AdmissionParams, should_shed
from repro_torch.tenancy.discipline import (FCFSDiscipline, QueueDiscipline,
                                      VTCDiscipline, WeightedVTCDiscipline,
                                      make_discipline, tenant_of,
                                      tenant_weight_of)
from repro_torch.tenancy.ledger import TenantLedger

__all__ = [
    "AdmissionParams", "FCFSDiscipline", "QueueDiscipline", "TenantLedger",
    "VTCDiscipline", "WeightedVTCDiscipline", "make_discipline",
    "should_shed", "tenant_of", "tenant_weight_of",
]
