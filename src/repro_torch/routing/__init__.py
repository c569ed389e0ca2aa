# Copy of src/repro/routing/__init__.py (no import of the JAX package).
"""SkyLB's routing brain, transport-agnostic: policies + pushing modes,
hash ring, prefix trie, the `RoutingCore` two-layer dispatch engine, and
the `build_routing()` variant factory.  The discrete-event simulator
(`repro.core.simulator`) and the real-engine router (`repro.serving.router`)
are both thin transports around this package.
"""
from repro_torch.routing.build import RoutingSpec, VARIANTS, build_routing
from repro_torch.routing.core import RoutingConfig, RoutingCore, Transport
from repro_torch.routing.failover import FailoverTracker
from repro_torch.routing.hashring import HashRing
from repro_torch.routing.kvtransfer import (KVTransferParams, PULL, PUSH,
                                      RECOMPUTE, decide)
from repro_torch.routing.policies import (BP, SP_O, SP_P, BlendedScorePolicy,
                                    ConsistentHash, LeastLoad, Policy,
                                    PrefixTreePolicy, RoundRobin,
                                    SGLangRouterLike, TargetView, eligible,
                                    make_policy)
from repro_torch.routing.prefixtree import PrefixTree

__all__ = [
    "RoutingSpec", "VARIANTS", "build_routing",
    "RoutingConfig", "RoutingCore", "Transport", "FailoverTracker",
    "HashRing", "PrefixTree",
    "KVTransferParams", "PULL", "PUSH", "RECOMPUTE", "decide",
    "BP", "SP_O", "SP_P", "BlendedScorePolicy", "ConsistentHash",
    "LeastLoad", "Policy", "PrefixTreePolicy", "RoundRobin",
    "SGLangRouterLike", "TargetView", "eligible", "make_policy",
]
