"""Continuous-batching PyTorch inference engine with paged KV + radix
prefix cache: a thin host around `repro_torch.replica.ReplicaCore` over
`TorchPagedBackend` (port of `repro.serving.engine`).

Every scheduling decision (pending-queue admission, page-granular KV
accounting, radix match/insert/evict, chunked prefill, oversized-request
rejection, priority preemption) lives in the backend-agnostic core; this
module turns finished sequences into `GenResult`s.
``pending_count() == 0`` is exactly the availability signal SkyLB's SP-P
probes (§3.3).

Speculative decoding (`EngineConfig.spec_k > 0`) takes a drafter model,
`Engine(..., draft_cfg=, draft_params=)`, whose params live on the engine's
device; its tokens equal the non-speculative engine's whatever the drafter
proposes.

The device is explicit: `device=None` means "cuda", and without CUDA the
engine raises unless the caller asked for `device="cpu"`. It serves dense,
MoE and VLM transformers, as the JAX engine does; other families raise
`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import leaves
from repro_torch.replica import ReplicaCore, ReplicaCoreConfig
from repro_torch.serving.request import (FinishReason, GenRequest, GenResult,
                                         cancel_finish_reason)
from repro_torch.serving.torch_backend import TorchPagedBackend


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    page_size: int = 16
    n_pages: int = 512            # KV budget = n_pages * page_size tokens
    max_batch: int = 8            # max concurrent sequences
    max_seq_len: int = 2048
    prefill_pad: int = 64         # pad uncached suffix to a multiple
    scratch_pages: int = 1        # reserved ids for padding block tables
    prefill_chunk: int = 0        # max tokens per prefill call; 0 = whole suffix
    preemption: bool = False      # priority preemption (recompute on resume)
    host_pages: int = 0           # host-memory KV tier pages; 0 = tier off
    overlap_loads: bool = True    # async H2D load-back staging (False =
                                  # block at dispatch; benchmark contrast)
    bucket_shapes: bool = True    # pow2 shape buckets; False = exact shapes
    packed_prefill: bool = True   # admissions packed into one call;
                                  # False = one prefill_step per request
    spec_k: int = 0               # speculative drafts per decode iteration;
                                  # 0 = off. >0 requires Engine(draft_cfg=,
                                  # draft_params=): the drafter model
    spec_synth_rate: Optional[float] = None  # benchmark knob: fixed
                                  # synthetic acceptance rate (emitted
                                  # tokens then NOT baseline-exact)
    discipline: str = "fcfs"      # queue discipline: fcfs | vtc | wvtc
    cache_discount: float = 0.25  # VTC charge rate for cache-hit tokens
    shed_deadline: bool = False   # deadline-aware admission shedding


def resolve_device(device: Optional[str]) -> torch.device:
    """`None` means the card. Without CUDA only an explicit "cpu" runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"the paged engine serves transformer families (dense/moe/vlm); "
            f"got {cfg.family} (ssm/hybrid replicas are modeled by the "
            f"simulator)")


class Engine:
    def __init__(self, model_cfg: ModelConfig, params: Any,
                 ecfg: EngineConfig = EngineConfig(), seed: int = 0,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params: Any = None, device: Optional[str] = None):
        _check_family(model_cfg)
        if draft_cfg is not None:
            _check_family(draft_cfg)
        self.device = resolve_device(device)
        for what, tree in (("params", params), ("draft_params", draft_params)):
            if tree is None:
                continue
            on = {t.device.type for t in leaves(tree)}
            if on != {self.device.type}:
                raise ValueError(f"{what} live on {sorted(on)}, the engine "
                                 f"on {self.device}; make them where they "
                                 f"will run")
        self.cfg = model_cfg
        self.ecfg = ecfg
        self.params = params
        self.backend = TorchPagedBackend(
            model_cfg, params, n_pages=ecfg.n_pages, page_size=ecfg.page_size,
            device=self.device, prefill_pad=ecfg.prefill_pad, seed=seed,
            bucket_shapes=ecfg.bucket_shapes,
            packed_prefill=ecfg.packed_prefill,
            overlap_loads=ecfg.overlap_loads,
            spec_k=ecfg.spec_k, draft_cfg=draft_cfg,
            draft_params=draft_params,
            spec_synth_rate=ecfg.spec_synth_rate)
        self.core = ReplicaCore(ReplicaCoreConfig(
            page_size=ecfg.page_size, n_pages=ecfg.n_pages,
            max_batch=ecfg.max_batch, max_seq_len=ecfg.max_seq_len,
            prefill_chunk=ecfg.prefill_chunk, preemption=ecfg.preemption,
            reserved_pages=ecfg.scratch_pages,
            host_pages=ecfg.host_pages,
            discipline=ecfg.discipline,
            cache_discount=ecfg.cache_discount,
            shed_deadline=ecfg.shed_deadline), self.backend)
        self.backend.bind(self.core)
        self.results: dict[int, GenResult] = {}
        # tokens the core appended this step; drained ONCE per step into
        # `req.on_token` events. The tokens are already host-resident from
        # the step's single device sync, so streaming adds no device work.
        self._tokbuf: list = []
        self.core.token_sink = (
            lambda seq, tok, idx: self._tokbuf.append((seq, tok, idx)))

    # ------------------------------------------------------------ probes
    def pending_count(self) -> int:
        return self.core.pending_count()

    def outstanding(self) -> int:
        return self.core.outstanding()

    def available(self) -> bool:
        """SP-P availability: no pending request (Alg. 1 line 5)."""
        return self.core.available()

    def kv_utilization(self) -> float:
        return self.core.kv_utilization()

    # ---- core state pass-throughs (probe surface + tests)
    @property
    def pending(self):
        return self.core.pending

    @property
    def running(self):
        return self.core.running

    @property
    def loading(self):
        return self.core.loading

    @property
    def alloc(self):
        return self.core.alloc

    @property
    def radix(self):
        return self.core.radix

    @property
    def steps(self) -> int:
        return self.core.steps

    @property
    def prefill_tokens(self) -> int:
        return self.core.total_prefill_tokens

    @property
    def cached_tokens(self) -> int:
        return self.core.total_cached_tokens

    @property
    def completions(self) -> int:
        return self.core.completions

    @property
    def peak_running(self) -> int:
        return self.core.peak_running

    def tenant_counters(self) -> dict:
        return self.core.tenant_counters()

    # ------------------------------------------------------------ submit
    def submit(self, req: GenRequest) -> None:
        if req.arrival_s is None:
            # admission stamp from THIS transport's clock — never the
            # dataclass-construction time
            req.arrival_s = time.monotonic()
        if req.cancelled is not None:
            # a cancel raced the request here: resolve it at arrival,
            # exactly once
            if req.rid not in self.results:
                self._resolve(req, (), cancel_finish_reason(req.cancelled))
            return
        if req.deadline_s is not None and req.deadline_s <= 0:
            # expired at submit: immediate DEADLINE abort, nothing reaches
            # the scheduler — no pages, no prefill, no batch slot
            self._resolve(req, (), FinishReason.DEADLINE)
            return
        self.core.submit(req)

    # ------------------------------------------------------------ cancel
    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Abandon an in-flight request: queued work is dropped, a running
        sequence is reaped mid-decode (pages + radix pins freed; the device
        batch-state slot is reclaimed at the next membership sync). No-op
        (False) when `rid` already has a terminal result."""
        if rid in self.results:
            return False
        seq = self.core.cancel(rid)
        if seq is None:
            return False
        self._finish(seq, cancel_finish_reason(reason))
        return True

    def _sweep_deadlines(self, now: float) -> int:
        expired = [s.req.rid for s in
                   (list(self.core.pending) + list(self.core.running)
                    + list(self.core.loading))
                   if s.req.deadline_s is not None
                   and s.req.arrival_s is not None
                   and now - s.req.arrival_s > s.req.deadline_s]
        for rid in expired:
            self.cancel(rid, "deadline")
        return len(expired)

    # ------------------------------------------------------------ drive
    def step(self) -> int:
        """One continuous-batching iteration: reap expired deadlines, admit
        while possible (prefill each admission), then one decode for the
        batch. Returns #sequences terminally resolved this step (finished +
        rejected + shed + deadline-aborted) — every one has a GenResult in
        `results`. Token events (`req.on_token`) drain once per step."""
        aborted = self._sweep_deadlines(time.monotonic())
        plan = self.core.begin_step()
        for seq in plan.admitted:
            if seq.req.on_admit is not None:
                seq.req.on_admit(seq.req, time.monotonic())
        for seq in plan.rejected:
            self._finish(seq, FinishReason.ABORT)
        for seq in plan.shed:
            self._finish(seq, FinishReason.SHED)
        finished = self.core.finish_step()
        self._drain_tokens()
        for seq in finished:
            why = (FinishReason.LENGTH if len(seq.out) >= seq.max_new
                   else FinishReason.STOP)
            self._finish(seq, why)
        return len(finished) + len(plan.rejected) + len(plan.shed) + aborted

    def _drain_tokens(self) -> None:
        if not self._tokbuf:
            return
        buf, self._tokbuf = self._tokbuf, []
        now = time.monotonic()
        for seq, tok, idx in buf:
            cb = seq.req.on_token
            if cb is not None and seq.req.rid not in self.results:
                cb(seq.req, tok, idx, now)

    def _finish(self, seq, why: FinishReason) -> None:
        self._resolve(seq.req, tuple(seq.out), why, error=seq.error)

    def _resolve(self, req: GenRequest, out: tuple, why: FinishReason,
                 error=None) -> None:
        req.finished_s = time.monotonic()
        res = GenResult(
            rid=req.rid, output_tokens=out, finish_reason=why,
            cached_tokens=req.cached_tokens, prompt_len=len(req.prompt_tokens),
            ttft_s=(req.first_token_s - req.arrival_s
                    if req.first_token_s is not None
                    and req.arrival_s is not None else None),
            e2e_s=(req.finished_s - req.arrival_s
                   if req.arrival_s is not None else None),
            error=error)
        self.results[req.rid] = res
        if req.on_done is not None:
            req.on_done(res)

    def run_until_idle(self, max_steps: int = 100_000) -> dict[int, GenResult]:
        for _ in range(max_steps):
            self.step()
            if (not self.core.running and not self.core.pending
                    and not self.core.loading):
                break
        return self.results

    # ------------------------------------------- cross-region KV transfer
    def export_prefix(self, tokens: tuple):
        """KV bytes for the longest device-cached full-page prefix of
        `tokens`: (n_tokens, k_stack, v_stack), the stacks CPU tensors
        (N, L, page, K, hd) — the pull-prefix payload."""
        n, pages = self.core.radix.match(tuple(tokens))
        if not pages:
            return 0, None, None
        k_stack, v_stack = self.backend.export_pages(pages)
        return n, k_stack, v_stack

    def import_prefix(self, tokens: tuple, k_stack, v_stack) -> int:
        """Install a pulled prefix: claim radix pages for the uncached
        blocks of `tokens` and scatter the transferred KV into them.
        Returns tokens now locally cached (capacity-capped)."""
        n, start_block, new_pages = self.core.inject_prefix(tuple(tokens))
        if new_pages:
            rows = slice(start_block, start_block + len(new_pages))
            self.backend.import_pages(new_pages, k_stack[rows],
                                      v_stack[rows])
        return n

    def generate(self, reqs: list[GenRequest]) -> list[GenResult]:
        """Batched blocking API: submit all, run to completion, return in
        submission order."""
        for r in reqs:
            self.submit(r)
        self.run_until_idle()
        return [self.results[r.rid] for r in reqs]

    def hit_rate(self) -> float:
        return self.core.hit_rate()
