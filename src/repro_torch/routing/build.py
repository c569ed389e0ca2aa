# Copy of src/repro/routing/build.py (no import of the JAX package).
"""`build_routing()` — the one place a system-variant name (skylb, gke,
rr, ...) is turned into routing machinery: policy constructors, pushing
mode, cross-region / work-stealing switches, and topology shape.  The
discrete-event `ServingSystem`, the real-engine `InProcessRouter`, the
launchers, and the benchmarks all build through this, so a new variant
lands once and runs on every transport.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.routing.core import RoutingConfig
from repro_torch.routing.policies import (BP, SP_O, SP_P, BlendedScorePolicy,
                                    ConsistentHash, LeastLoad, Policy,
                                    PrefixTreePolicy, RoundRobin,
                                    SGLangRouterLike)

# single central LB, blind pushing — the paper's §5 baselines ('trie' is the
# single global-view prefix-trie router, the Fig. 6 'optimal' stand-in)
_SINGLE_LB = {"rr": RoundRobin, "ll": LeastLoad, "ch": ConsistentHash,
              "sgl": SGLangRouterLike, "trie": PrefixTreePolicy}

# one LB per region: (local policy, remote policy)
_TWO_LAYER = {
    "skylb": (PrefixTreePolicy, PrefixTreePolicy),
    "sp-o": (PrefixTreePolicy, PrefixTreePolicy),
    "bp": (PrefixTreePolicy, PrefixTreePolicy),
    "steal": (PrefixTreePolicy, PrefixTreePolicy),
    "skylb-ch": (ConsistentHash, ConsistentHash),
    "blend": (BlendedScorePolicy, PrefixTreePolicy),
    "gke": (RoundRobin, RoundRobin),
    "region-local": (LeastLoad, LeastLoad),
}

_PUSHING = {"skylb": SP_P, "skylb-ch": SP_P, "blend": SP_P,
            "sp-o": SP_O, "bp": BP, "gke": SP_O,
            "region-local": SP_P, "steal": SP_P}

VARIANTS = tuple(_SINGLE_LB) + tuple(_TWO_LAYER)


@dataclasses.dataclass(frozen=True)
class RoutingSpec:
    """Everything a host needs to instantiate one system variant."""
    variant: str
    single_lb: bool                        # central LB vs one LB per region
    local_policy: Callable[[], Policy]
    remote_policy: Optional[Callable[[], Policy]]
    pushing: str
    cross_region: bool
    work_stealing: bool = False

    def make_config(self, **overrides) -> RoutingConfig:
        return RoutingConfig(pushing=self.pushing,
                             cross_region=self.cross_region,
                             work_stealing=self.work_stealing, **overrides)


def build_routing(variant: str) -> RoutingSpec:
    v = variant.lower()
    if v in _SINGLE_LB:
        return RoutingSpec(variant=v, single_lb=True,
                           local_policy=_SINGLE_LB[v], remote_policy=None,
                           pushing=BP, cross_region=False)
    if v in _TWO_LAYER:
        local, remote = _TWO_LAYER[v]
        return RoutingSpec(variant=v, single_lb=False,
                           local_policy=local, remote_policy=remote,
                           pushing=_PUSHING[v],
                           cross_region=(v != "region-local"),
                           work_stealing=(v == "steal"))
    raise ValueError(f"unknown routing variant {variant!r}; "
                     f"one of {', '.join(VARIANTS)}")
