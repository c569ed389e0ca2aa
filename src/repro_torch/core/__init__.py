# Copy of src/repro/core/__init__.py (no import of the JAX package).
"""Multi-region discrete-event testbed for SkyLB: replicas, WAN network,
LB hosts, controller, workloads, metrics, and the `ServingSystem` builder.
The routing DECISIONS themselves live in the transport-agnostic
`repro.routing` package (shared with the real-engine path); the old
`repro.core.{policies,hashring,prefixtree}` import paths remain as
deprecated shims."""
from repro_torch.core.simulator import (Controller, LBConfig, LoadBalancerSim,
                                  Network, ReplicaConfig, ReplicaSim, Request,
                                  Sim)
from repro_torch.core.system import ServingSystem
from repro_torch.routing import (BP, SP_O, SP_P, BlendedScorePolicy, ConsistentHash,
                           HashRing, LeastLoad, Policy, PrefixTree,
                           PrefixTreePolicy, RoundRobin, SGLangRouterLike,
                           TargetView, eligible, make_policy)

__all__ = [
    "HashRing", "PrefixTree", "BP", "SP_O", "SP_P", "BlendedScorePolicy",
    "ConsistentHash", "LeastLoad", "Policy", "PrefixTreePolicy", "RoundRobin",
    "SGLangRouterLike", "TargetView", "eligible", "make_policy", "Controller",
    "LBConfig", "LoadBalancerSim", "Network", "ReplicaConfig", "ReplicaSim",
    "Request", "Sim", "ServingSystem",
]
