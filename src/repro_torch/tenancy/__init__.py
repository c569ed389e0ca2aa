"""Replica-side multi-tenant fairness and admission control (copies of
`repro.tenancy.discipline` and `repro.tenancy.admission`)."""
from repro_torch.tenancy.admission import AdmissionParams, should_shed
from repro_torch.tenancy.discipline import (FCFSDiscipline, QueueDiscipline,
                                            VTCDiscipline,
                                            WeightedVTCDiscipline,
                                            make_discipline, tenant_of,
                                            tenant_weight_of)

__all__ = [
    "AdmissionParams", "FCFSDiscipline", "QueueDiscipline", "VTCDiscipline",
    "WeightedVTCDiscipline", "make_discipline", "should_shed", "tenant_of",
    "tenant_weight_of",
]
