# Copy of src/repro/core/metrics.py (no import of the JAX package).
"""Metrics collection for simulator runs: throughput, TTFT / E2E latency
distributions, KV-cache hit rate, load-imbalance stats."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Optional


def pct(xs: list[float], p: float) -> float:
    if not xs:
        return float("nan")
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, int(round(p / 100 * (len(xs) - 1)))))
    return xs[k]


@dataclasses.dataclass
class RunMetrics:
    completed: list = dataclasses.field(default_factory=list)
    rejected: list = dataclasses.field(default_factory=list)
    cancelled: list = dataclasses.field(default_factory=list)
    deadline_aborted: list = dataclasses.field(default_factory=list)
    shed: list = dataclasses.field(default_factory=list)
    forwards: list = dataclasses.field(default_factory=list)
    issued: int = 0
    t_start: float = 0.0
    t_end: float = 0.0
    # hedged dispatch (latency-class duplication; repro.routing.hedging)
    hedged: int = 0            # requests duplicated to a second region
    hedge_wins: int = 0        # races the CLONE won (hedge paid off)
    wasted_work_tok: int = 0   # loser-leg compute, in tokens: uncached
                               # prefill + decoded-then-suppressed tokens
    # measured provisioning dollars (repro.provision.CostMeter.summary),
    # set by FleetController.finalize() on elastic-fleet runs
    cost: Optional[dict] = None

    def on_issued(self, req) -> None:
        self.issued += 1

    def on_done(self, req) -> None:
        self.completed.append(req)

    def on_rejected(self, req) -> None:
        """Replica refused the request (oversized for its KV budget)."""
        self.rejected.append(req)

    def on_cancelled(self, req) -> None:
        """Client abandoned the request (handle.cancel())."""
        self.cancelled.append(req)

    def on_deadline(self, req) -> None:
        """deadline_s expired before completion: aborted, not served."""
        self.deadline_aborted.append(req)

    def on_shed(self, req) -> None:
        """Shed at admission: predicted queueing delay already exceeded the
        deadline, so the system refused it up-front instead of burning
        prefill on a request it would abort anyway."""
        self.shed.append(req)

    def _client_ttfts(self) -> list:
        """Client-observed TTFTs — the ONE definition behind both the
        reported percentiles and SLO attainment."""
        return [r.ttft - r.issued for r in self.completed
                if r.finished is not None and r.ttft is not None]

    def slo_attainment(self, ttft_slo_s: float) -> float:
        """Fraction of completed requests whose client-observed TTFT met
        the SLO (the paper's cost claim is 'cheaper at EQUAL SLO')."""
        ttft = self._client_ttfts()
        if not ttft:
            return float("nan")
        return sum(1 for t in ttft if t <= ttft_slo_s) / len(ttft)

    # ---- grouped breakdowns ------------------------------------------
    def grouped_percentiles(self, key_fn, ps=(50, 90)) -> dict:
        """ONE grouping implementation behind every breakdown (per-tenant,
        per-region, per-SLO-class): client-observed TTFT percentiles keyed
        by `key_fn(req)`. The previous per-X helpers each re-filtered
        `completed` with subtly different guards; keeping a single code
        path is the fix."""
        groups: dict = {}
        for r in self.completed:
            if r.finished is None or r.ttft is None:
                continue
            groups.setdefault(key_fn(r), []).append(r.ttft - r.issued)
        return {k: {f"p{p}": pct(v, p) for p in ps} | {"n": len(v)}
                for k, v in sorted(groups.items())}

    def per_tenant(self, ps=(50, 90)) -> dict:
        return self.grouped_percentiles(
            lambda r: getattr(r, "user_id", "") or "_anon", ps)

    def per_region(self, ps=(50, 90)) -> dict:
        return self.grouped_percentiles(lambda r: r.region, ps)

    def per_slo_class(self, ps=(50, 90)) -> dict:
        return self.grouped_percentiles(
            lambda r: getattr(r, "slo_class", "standard"), ps)

    def ttft_p90_spread(self) -> float:
        """max/min of per-tenant p90 TTFT — the fig12 fairness gate.
        1.0 = perfectly even; an abusive tenant starving others shows up
        as a large spread under FCFS that VTC must collapse."""
        p90s = [g["p90"] for g in self.per_tenant().values()
                if g["p90"] == g["p90"]]          # drop NaN groups
        if len(p90s) < 2:
            return float("nan")
        return max(p90s) / max(1e-9, min(p90s))

    # ---- summary -----------------------------------------------------
    def summary(self, replicas: Optional[list] = None) -> dict:
        reqs = [r for r in self.completed if r.finished is not None]
        dur = max(1e-9, self.t_end - self.t_start)
        out_tokens = sum(r.output_len for r in reqs)
        ttft = self._client_ttfts()
        e2e = [r.finished - r.issued for r in reqs]
        prompt_tokens = sum(len(r.prompt_tokens) for r in reqs)
        cached = sum(r.cached_tokens for r in reqs)
        # goodput: output delivered by requests that met their deadline
        # (requests past deadline are aborted mid-flight, so their partial
        # tokens are NOT goodput; requests without a deadline always count)
        good = [r for r in reqs
                if r.deadline_s is None
                or (r.finished - r.issued) <= r.deadline_s]
        s = {
            "requests": len(reqs),
            "duration_s": dur,
            "throughput_tok_s": out_tokens / dur,
            "throughput_req_s": len(reqs) / dur,
            "goodput_tok_s": sum(r.output_len for r in good) / dur,
            "ttft_p50": pct(ttft, 50), "ttft_p90": pct(ttft, 90),
            "ttft_mean": statistics.fmean(ttft) if ttft else float("nan"),
            "e2e_p50": pct(e2e, 50), "e2e_p90": pct(e2e, 90),
            "e2e_mean": statistics.fmean(e2e) if e2e else float("nan"),
            "hit_rate": cached / max(1, prompt_tokens),
            "forwards": len(self.forwards),
            "rejected": len(self.rejected),
            "cancelled": len(self.cancelled),
            "deadline_aborted": len(self.deadline_aborted),
            "shed": len(self.shed),
            "hedged": self.hedged,
            "hedge_wins": self.hedge_wins,
            "wasted_work_tok": self.wasted_work_tok,
            "issued": self.issued,
            # issued but not terminally resolved by t_end: in-flight at the
            # horizon on a healthy run; DROPPED work if a drill expected
            # the system to settle (outage test asserts 0)
            "unresolved": max(0, self.issued - len(self.completed)
                              - len(self.rejected) - len(self.cancelled)
                              - len(self.deadline_aborted)
                              - len(self.shed)),
        }
        if self.cost is not None:
            s.update(self.cost)
        if replicas:
            peaks = [r.peak_outstanding for r in replicas]
            s["peak_outstanding_max"] = max(peaks)
            s["peak_outstanding_min"] = min(peaks)
            s["imbalance_ratio"] = (max(peaks) / max(1, min(peaks)))
            s["replica_completions"] = {r.id: r.completions for r in replicas}
        return s
