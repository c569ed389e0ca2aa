# Copy of src/repro/plane/metrics.py (no import of the JAX package).
"""Merging per-process metrics snapshots into the one RunMetrics schema.

Each plane process answers ``metrics?`` with a Ray-Serve-style snapshot of
ITSELF (a replica: delivered/completed/tokens/steps; an LB: issued/
resolved/forwards/hedges).  Nobody aggregates in-band — the launcher (or a
test) sweeps the snapshots and `merge_snapshots` folds them into the same
summary dict shape `repro.core.metrics.RunMetrics.summary()` produces, so
benchmark tables and gates read identically whether a run happened in the
simulator, the in-process router, or across real PIDs.

Latency percentiles are deliberately absent here: cross-process timestamps
don't compose (per-process monotonic epochs), so TTFT/E2E distributions
belong to the CLIENT, which observes every event on one clock.  The merged
dict carries the counters that are well-defined across processes.
"""
from __future__ import annotations


def merge_snapshots(snaps: list[dict]) -> dict:
    """Fold per-process ``metrics`` snapshots into a RunMetrics-style
    summary dict (plus ``per_process`` with the raw snapshots)."""
    reps = [s for s in snaps if s.get("kind") == "replica"]
    lbs = [s for s in snaps if s.get("kind") == "lb"]
    dur = max([s.get("uptime_s", 0.0) for s in snaps], default=0.0)
    dur = max(1e-9, dur)
    out_tokens = sum(s.get("output_tokens", 0) for s in reps)
    prompt_tokens = sum(s.get("prompt_tokens", 0) for s in reps)
    cached = sum(s.get("cached_tokens", 0) for s in reps)
    completed = sum(s.get("completed", 0) for s in reps)
    issued = sum(s.get("issued", 0) for s in lbs)
    resolved = sum(s.get("resolved", 0) for s in lbs)
    return {
        "requests": completed,
        "duration_s": dur,
        "throughput_tok_s": out_tokens / dur,
        "throughput_req_s": completed / dur,
        "hit_rate": cached / max(1, prompt_tokens),
        "forwards": sum(s.get("forwarded_out", 0) for s in lbs),
        "rejected": sum(s.get("rejected", 0) for s in reps),
        "cancelled": sum(s.get("cancelled", 0) for s in reps),
        "deadline_aborted": sum(s.get("deadline_aborted", 0) for s in reps),
        "hedged": sum(s.get("hedged", 0) for s in lbs),
        "hedge_wins": sum(s.get("hedge_wins", 0) for s in lbs),
        "wasted_work_tok": sum(s.get("wasted_work_tok", 0) for s in lbs),
        "redispatched": sum(s.get("redispatched", 0) for s in lbs)
        + sum(s.get("redispatched", 0) for s in reps),
        "issued": issued,
        # issued at some LB but never resolved back through one — with the
        # caveat that client-side failover RE-issues (the client is the
        # authoritative judge for drill gates; this is the plane's view)
        "unresolved": max(0, issued - resolved),
        "steps": sum(s.get("steps", 0) for s in reps),
        # partition-tolerance counters (fence/chaos machinery)
        "fenced_frames": sum(s.get("fenced_frames", 0) for s in lbs),
        "dup_suppressed": sum(s.get("dup_suppressed", 0) for s in lbs),
        "send_drops": sum(s.get("send_drops", 0) for s in lbs),
        "kv_pull_timeouts": sum(s.get("kv_pull_timeouts", 0) for s in lbs),
        "degraded_transitions": sum(s.get("degraded_transitions", 0)
                                    for s in lbs),
        "reconnects": sum(s.get("reconnects", 0) for s in snaps),
        "fault_dropped_send": sum(s.get("fault_dropped_send", 0)
                                  for s in snaps),
        "fault_dropped_recv": sum(s.get("fault_dropped_recv", 0)
                                  for s in snaps),
        "unacked_results": sum(s.get("unacked_results", 0) for s in snaps),
        "n_processes": len(snaps),
        "per_process": list(snaps),
    }
