# Copy of src/repro/routing/policies.py (no import of the JAX package).
"""Routing policies (paper §3.2, §5 baselines) + pushing modes (§3.3).

Policies see immutable *views* of candidate targets and return a choice;
pushing modes decide WHICH targets are eligible at all:

  BP    blind pushing      — every target eligible (RR/LL/CH/SGL baselines)
  SP-O  selective/outstanding — outstanding < fixed threshold
  SP-P  selective/pending  — pending == 0 (the paper's mechanism)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.routing.hashring import HashRing
from repro_torch.routing.prefixtree import PrefixTree


@dataclasses.dataclass
class TargetView:
    """Probe-snapshot view of a replica (or a remote LB)."""
    id: str
    outstanding: int = 0        # running + pending
    pending: int = 0            # not yet in the continuous batch
    available: bool = True      # SP-P availability (pending == 0 at probe)
    queue_len: int = 0          # remote LB queue length
    n_avail_replicas: int = 1   # remote LB: replicas with empty pending
    n_replicas: int = 1         # remote LB: replicas that EXIST at all
                                # (busy counts; 0 = emptied/scaled-to-zero)
    # per-tenant service counters (repro.tenancy.TenantLedger snapshot),
    # carried in heartbeats so every LB converges on the same fairness
    # view; None (the default) keeps wire frames lean when fairness is off
    tenant_counters: Optional[dict] = None

    #: sentinel load advertised for a dead/unreachable target
    DEAD_LOAD = 10 ** 9

    @classmethod
    def unavailable(cls, target_id: str) -> "TargetView":
        """The view every transport must advertise for a dead peer — one
        convention, so eligibility and steal-victim filtering see the same
        sentinel on every host."""
        return cls(id=target_id, available=False, n_avail_replicas=0,
                   n_replicas=0, queue_len=cls.DEAD_LOAD,
                   outstanding=cls.DEAD_LOAD)


# ------------------------------------------------------------------ pushing

BP, SP_O, SP_P = "BP", "SP-O", "SP-P"


def eligible(views: Sequence[TargetView], mode: str, spo_limit: int = 24,
             tau: int = 4) -> list[TargetView]:
    if mode == BP:
        return list(views)
    if mode == SP_O:
        return [v for v in views if v.outstanding < spo_limit]
    if mode == SP_P:
        return [v for v in views
                if v.available and v.n_avail_replicas > 0 and v.queue_len <= tau]
    raise ValueError(mode)


# ------------------------------------------------------------------ policies

class Policy:
    """select() returns a target id among `views` (already
    eligibility-filtered) or None."""
    name = "base"
    prefix_aware = False

    def select(self, req, views: Sequence[TargetView]) -> Optional[str]:
        raise NotImplementedError

    def on_routed(self, req, target_id: str) -> None:
        pass

    def on_target_added(self, target_id: str) -> None:
        pass

    def on_target_removed(self, target_id: str) -> None:
        pass


class RoundRobin(Policy):
    name = "RR"

    def __init__(self):
        self._i = 0

    def select(self, req, views):
        if not views:
            return None
        v = views[self._i % len(views)]
        self._i += 1
        return v.id


class LeastLoad(Policy):
    name = "LL"

    def select(self, req, views):
        if not views:
            return None
        return min(views, key=lambda v: (v.outstanding, v.id)).id


class ConsistentHash(Policy):
    """Classic ring hash on the session key (baseline CH and SkyLB-CH's
    per-layer primitive). Skips unavailable virtual nodes."""
    name = "CH"
    prefix_aware = True          # implicitly, via session affinity

    def __init__(self, targets=(), vnodes: int = 100):
        self.ring = HashRing(targets, vnodes=vnodes)

    def select(self, req, views):
        avail = {v.id for v in views}
        for v in views:
            self.ring.add(v.id)   # lazily learn targets
        return self.ring.lookup(str(req.session_key), available=avail)

    def on_target_added(self, target_id):
        self.ring.add(target_id)

    def on_target_removed(self, target_id):
        self.ring.remove(target_id)


class PrefixTreePolicy(Policy):
    """SkyLB's trie policy: longest available prefix match; when the hit
    ratio is poor (< explore_threshold) fall back to least-load exploration
    (paper §5.1: 'when the prefix hit ratio is low (e.g., <50%), it explores
    other underutilized replicas')."""
    name = "TRIE"
    prefix_aware = True

    def __init__(self, max_tokens: int = 2_000_000,
                 explore_threshold: float = 0.5):
        self.tree = PrefixTree(max_tokens=max_tokens)
        self.explore_threshold = explore_threshold

    def select(self, req, views):
        if not views:
            return None
        avail = {v.id for v in views}
        mlen, best = self.tree.match(req.prompt_tokens, avail)
        ratio = mlen / max(1, len(req.prompt_tokens))
        if best is None or ratio < self.explore_threshold:
            return min(views, key=lambda v: (v.outstanding, v.id)).id
        return best

    def on_routed(self, req, target_id):
        self.tree.insert(req.prompt_tokens, target_id)

    def on_target_removed(self, target_id):
        self.tree.remove_target(target_id)

    def match_ratio(self, req, views) -> float:
        mlen, _ = self.tree.match(req.prompt_tokens, {v.id for v in views})
        return mlen / max(1, len(req.prompt_tokens))


class SGLangRouterLike(Policy):
    """SGLang-router-style cache-aware policy (baseline SGL): approximate
    per-replica prefix tree; cache-aware when the best match beats a
    threshold, else least-load. Blind pushing (no admission control)."""
    name = "SGL"
    prefix_aware = True

    def __init__(self, threshold: float = 0.3, max_tokens: int = 2_000_000):
        self.tree = PrefixTree(max_tokens=max_tokens)
        self.threshold = threshold

    def select(self, req, views):
        if not views:
            return None
        avail = {v.id for v in views}
        mlen, best = self.tree.match(req.prompt_tokens, avail)
        if best is not None and mlen / max(1, len(req.prompt_tokens)) >= self.threshold:
            return best
        return min(views, key=lambda v: (v.outstanding, v.id)).id

    def on_routed(self, req, target_id):
        self.tree.insert(req.prompt_tokens, target_id)

    def on_target_removed(self, target_id):
        self.tree.remove_target(target_id)


# ---------------------------------------------------- beyond-paper policies

class BlendedScorePolicy(PrefixTreePolicy):
    """BEYOND-PAPER: score = alpha * prefix_hit - (1-alpha) * norm_load,
    instead of hard longest-match-then-explore. Motivated by paper §7
    ('request-characteristic aware routing'): short prompts gain little from
    cache hits, so load dominates; long prompts weight locality more."""
    name = "BLEND"

    def __init__(self, alpha: float = 0.7, **kw):
        super().__init__(**kw)
        self.alpha = alpha

    def select(self, req, views):
        if not views:
            return None
        avail = {v.id for v in views}
        n = len(req.prompt_tokens)
        # per-target longest match: walk once per target set is costly;
        # approximate with global best + membership check at best depth
        max_out = max((v.outstanding for v in views), default=0) + 1
        # prompt-length-aware locality weight
        alpha = self.alpha * min(1.0, n / 2048.0)
        best_v, best_score = None, -1e9
        mlen, best_t = self.tree.match(req.prompt_tokens, avail)
        for v in views:
            hit = (mlen / max(1, n)) if v.id == best_t else 0.0
            score = alpha * hit - (1 - alpha) * v.outstanding / max_out
            if score > best_score:
                best_v, best_score = v, score
        return best_v.id


def make_policy(kind: str) -> Policy:
    kind = kind.upper()
    if kind == "RR":
        return RoundRobin()
    if kind == "LL":
        return LeastLoad()
    if kind == "CH":
        return ConsistentHash()
    if kind == "SGL":
        return SGLangRouterLike()
    if kind == "TRIE":
        return PrefixTreePolicy()
    if kind == "BLEND":
        return BlendedScorePolicy()
    raise ValueError(kind)
