# Copy of src/repro/routing/kvtransfer.py (no import of the JAX package).
"""Bytes-vs-recompute cost model for cross-region KV movement.

SkyWalker forwards a request to the region with the best prefix affinity
(push-request). With a host tier multiplying per-replica cache capacity,
a second option opens: PULL the remote region's cached KV *pages* over the
WAN and serve the request where it arrived (WANSpec's argument for
WAN-separated compute). This module is the explicit decision rule between
the three ways to materialize a prefix, as wall-clock-to-first-token
estimates:

  recompute   t = (prompt - local_hit) / prefill_tps
  pull        t = rtt + pulled_bytes / wan_bw + (prompt - remote_hit) / tps
              (one request/response round trip, then the payload streams;
              the suffix beyond the remote hit still prefills locally)
  push        t = 2 * rtt/2 ... = rtt + (prompt - remote_hit) / tps
              but the RESPONSE tokens also cross the WAN back, so the
              request pays the full round trip: 2 * (rtt/2) each way plus
              remote queueing — modeled as one extra one-way hop vs pull.

`decide()` is deliberately a PURE function of (prompt_len, local_hit,
remote_hit) and frozen params — no queue depths, no clocks — so the
simulator and the real tick router reach byte-identical decisions on a
shared trace (the parity requirement), and the decision stream is
reproducible from the trace alone.
"""
from __future__ import annotations

import dataclasses

PULL = "pull"
PUSH = "push"
RECOMPUTE = "recompute"


@dataclasses.dataclass(frozen=True)
class KVTransferParams:
    kv_bytes_per_token: float = 131072.0  # ~128 KiB/token (fp16 mid-size)
    wan_gbps: float = 1.0                 # inter-region bandwidth
    wan_rtt_s: float = 0.15               # inter-region round trip
    prefill_tps: float = 1700.0           # local recompute speed
    # pulls below this many tokens never pay off (RTT dominates); also the
    # hysteresis guard that keeps tiny remote hits from thrashing the WAN
    min_pull_tokens: int = 64


def decide(prompt_len: int, local_hit: int, remote_hit: int,
           params: KVTransferParams = KVTransferParams()) -> tuple[str, dict]:
    """Choose how to materialize `prompt_len` tokens of prefix given
    `local_hit` tokens cached here and `remote_hit` cached at the best
    peer. Returns (choice, costs) with costs in estimated seconds; the
    tie-break order is fixed (recompute < pull < push on equal cost) so
    every host reaches the identical decision."""
    p = params
    local_hit = min(local_hit, prompt_len)
    remote_hit = min(remote_hit, prompt_len)
    tps = max(p.prefill_tps, 1e-9)
    bw = max(p.wan_gbps, 1e-9) * 1e9
    t_rec = (prompt_len - local_hit) / tps
    pulled = max(0, remote_hit - local_hit)
    t_pull = (p.wan_rtt_s + pulled * p.kv_bytes_per_token / bw
              + (prompt_len - remote_hit) / tps)
    t_push = 1.5 * p.wan_rtt_s + (prompt_len - remote_hit) / tps
    costs = {RECOMPUTE: t_rec, PULL: t_pull, PUSH: t_push,
             "pulled_tokens": pulled}
    if pulled < p.min_pull_tokens:
        # not enough remote advantage to pay an RTT for
        return RECOMPUTE, costs
    best = RECOMPUTE
    if t_pull < costs[best]:
        best = PULL
    if t_push < costs[best]:
        best = PUSH
    return best, costs
