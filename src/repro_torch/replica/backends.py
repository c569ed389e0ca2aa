# Copy of src/repro/replica/backends.py (no import of the JAX package).
"""Analytic cost-model backend for ReplicaCore (the simulator's side).

Tokens are not computed: "generation" replays the request's predetermined
`output_tokens` (how the discrete-event workloads model reusable
completions); what the backend produces is the iteration's LATENCY, from
the same calibration the old ReplicaSim used (~1.7k tok/s prefill,
~30 tok/s/stream decode on one L4 via SGLang). The host (ReplicaSim) calls
`step_cost()` after `core.begin_step()` and schedules `core.finish_step()`
that far in the future.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class CostParams:
    prefill_tps: float = 1700.0
    decode_base: float = 0.03       # s per iteration
    decode_per_seq: float = 0.0008  # s per running sequence
    speed_factor: float = 1.0       # >1 = straggler
    kv_page_bytes: float = 131072.0  # bytes per KV page (host<->device copy)
    host_copy_gbps: float = 20.0     # PCIe-class host<->device bandwidth
    # Speculative decoding (draft-k/verify-1). spec_k = 0 disables the
    # `decode_many` surface entirely (core falls back to `decode`).
    spec_k: int = 0                  # drafted tokens per decode iteration
    spec_accept_rate: float = 1.0    # per-draft acceptance probability
    spec_draft_cost: float = 0.15    # drafter fwd cost as fraction of target

# Stands in for a generated token the workload didn't predetermine. Fillers
# flow into the radix cache on completion like any generated token would on
# a real engine: generated KV occupies cache until LRU-evicted, and is
# reused only if a later prompt extends it (which a filler chain never is —
# it just models the residency cost). Workloads that model multi-turn reuse
# must supply real `output_tokens`, as every in-repo generator does.
FILLER_TOKEN = -1


class CostModelBackend:
    """ReplicaBackend with analytic timing. `cost` is any object with
    CostParams' attributes (the simulator passes its live ReplicaConfig so
    straggler demotion takes effect immediately)."""

    def __init__(self, cost=None):
        self.cost = cost if cost is not None else CostParams()
        self._prefill_tokens = 0     # uncached tokens prefilled this step
        self._copy_pages = 0         # host->device pages loading this step
        self.demoted_pages = 0       # device->host demotions (D2H copies)
        self.loaded_pages = 0        # completed load-backs (H2D copies)

    # ---- ReplicaBackend protocol
    def prefill(self, seq, start: int, end: int, sample: bool) -> Optional[int]:
        self._prefill_tokens += end - start
        return self._next_token(seq) if sample else None

    def prefill_batch(self, items) -> list:
        """One admission round; analytic cost is additive, so the packed
        plan surface reduces to sequential accounting."""
        return [self.prefill(seq, start, end, sample)
                for seq, start, end, sample in items]

    def decode(self, seqs) -> list:
        return [self._next_token(s) for s in seqs]

    def decode_many(self, seqs) -> Optional[list]:
        """Speculative decode iteration, mirrored analytically: each draft
        position is accepted with probability `spec_accept_rate` (leading
        matches only — the first rejection discards the rest, exactly the
        draft-k/verify-1 rule), then the verify pass always contributes one
        target-sampled token, so every sequence emits accepted+1 tokens.
        The coin flips are a deterministic hash of (rid, position, draft
        index), so reruns — and the JAX engine at rate 1.0 with
        drafter == target — produce identical decision streams."""
        k = int(getattr(self.cost, "spec_k", 0))
        if k <= 0:
            return None
        rate = float(getattr(self.cost, "spec_accept_rate", 1.0))
        out = []
        for s in seqs:
            n_acc = 0
            for j in range(k):
                if not self._accept(s.req.rid, len(s.out), j, rate):
                    break
                n_acc += 1
            out.append([self._token_at(s, len(s.out) + j)
                        for j in range(n_acc + 1)])
        return out

    # ---- host-tier hooks (mirror JaxPagedBackend's async copy path)
    def load_pages(self, seq, pairs) -> None:
        """Host->device load dispatched for a LOADING admission; the copy's
        analytic cost lands in this step's latency, overlapped with
        decode."""
        self._copy_pages += len(pairs)

    def finish_load(self, seq) -> None:
        self.loaded_pages += len(seq.host_plan)

    def abort_load(self, seq) -> None:
        pass                                    # nothing staged to drop

    def on_demote(self, dev_page: int, host_page: int) -> None:
        self.demoted_pages += 1                 # no bytes to snapshot

    # ---- cost model
    def step_cost(self, n_running: int) -> float:
        """Latency of the iteration just planned: prefill the admitted
        suffixes + one decode for the running batch, where the host->device
        load-back OVERLAPS decode (async H2D staging on the real engine) —
        the step takes max(decode, copy), not their sum. Resets the
        accumulators."""
        c = self.cost
        t = self._prefill_tokens / c.prefill_tps
        self._prefill_tokens = 0
        decode_t = c.decode_base + c.decode_per_seq * n_running
        spec_k = int(getattr(c, "spec_k", 0))
        if spec_k > 0:
            # k drafter forwards at a fraction of target cost + the wider
            # verify dispatch (~= one target forward) per iteration
            decode_t *= 1.0 + spec_k * float(getattr(c, "spec_draft_cost", 0.15))
        copy_t = (self._copy_pages * float(getattr(c, "kv_page_bytes", 131072.0))
                  / (float(getattr(c, "host_copy_gbps", 20.0)) * 1e9))
        self._copy_pages = 0
        t += max(decode_t, copy_t)
        return t * c.speed_factor

    @staticmethod
    def _next_token(seq) -> int:
        out = getattr(seq.req, "output_tokens", None) or ()
        i = len(seq.out)
        return int(out[i]) if i < len(out) else FILLER_TOKEN

    @staticmethod
    def _token_at(seq, i: int) -> int:
        out = getattr(seq.req, "output_tokens", None) or ()
        return int(out[i]) if i < len(out) else FILLER_TOKEN

    @staticmethod
    def _accept(rid: int, pos: int, j: int, rate: float) -> bool:
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        x = (rid * 1000003 ^ pos * 10007 ^ j * 101) & 0xFFFFFFFF
        x = (x * 2654435761) & 0xFFFFFFFF
        return x / 2.0 ** 32 < rate
