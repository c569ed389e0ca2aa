# Copy of src/repro/replica/core.py (no import of the JAX package).
"""Backend-agnostic replica scheduler core (the layer under repro.routing).

`ReplicaCore` owns the WHOLE continuous-batching scheduler that used to be
implemented twice — once as the simulator's `ReplicaSim` and once as the JAX
paged `Engine`: pending-queue admission, page-granular KV accounting
(`BlockAllocator`), radix prefix-cache bookkeeping (match / insert / evict /
refcounts, `PagedRadix`), chunked prefill, oversized-request rejection,
priority preemption, and the probe surface consumed by `repro.routing`
(`pending_count` / `available` / `kv_utilization`). What it deliberately
does NOT know is how tokens are produced or how long an iteration takes —
that lives behind the `ReplicaBackend` protocol:

  `CostModelBackend` (repro.replica.backends)  analytic timing; tokens are
      replayed from the request's predetermined completion. The simulator's
      `ReplicaSim` is a thin Sim-event host around it.
  `TorchPagedBackend` (repro_torch.serving.torch_backend)  real prefill/
      decode over a paged KV pool via `model_runner`. The serving `Engine`
      is a thin host.

Hosts drive one continuous-batching iteration in two phases,

    plan = core.begin_step()       # admit + prefill (backend) + reject
    ...                            # the sim host puts the iteration's
                                   # latency here; the engine runs on
    finished = core.finish_step()  # decode (backend) + reap

so the discrete-event simulator can schedule the iteration's analytic cost
between the phases while the real engine runs both back-to-back. Admission,
KV, cache, and preemption DECISIONS are identical across backends — the
parity test (tests/test_replica_parity.py) asserts it on a shared trace.

Requests only need `prompt_tokens`, a writable `cached_tokens` slot, and
either `sampling.max_new_tokens` (engine `GenRequest`) or `output_len`
(simulator `Request`); an optional integer `priority` (higher wins) feeds
preemption.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Protocol, runtime_checkable

from repro_torch.replica.blocks import BlockAllocator
from repro_torch.replica.radix import PagedRadix
from repro_torch.tenancy.admission import (DEFAULT_ADMISSION, AdmissionParams,
                                     should_shed)
from repro_torch.tenancy.discipline import (make_discipline, tenant_of,
                                      tenant_weight_of)


@runtime_checkable
class ReplicaBackend(Protocol):
    """How a ReplicaCore's scheduled work turns into tokens.

    Implementations own compute (real forward passes or analytic cost
    accumulation) and sampling; the core owns every scheduling decision.
    """

    def prefill(self, seq: "Seq", start: int, end: int,
                sample: bool) -> Optional[int]:
        """Process `seq.tokens[start:end]` (KV lands in `seq.pages`).
        `start` is page-aligned; `end == len(seq.tokens)` iff `sample`.
        When `sample`, return the boundary next token; else None."""
        ...

    def decode(self, seqs: list["Seq"]) -> list[int]:
        """One continuous-batch decode iteration: one new token per seq."""
        ...

    # Optional: `prefill_batch(items)` with items = [(seq, start, end,
    # sample)] processes one ROUND of independent prefill chunks (one chunk
    # from each of several sequences) in a single call, returning one
    # Optional[int] per item. Backends that can pack admissions into one
    # dispatch (JaxPagedBackend) implement it; the core falls back to
    # sequential `prefill` calls otherwise. Scheduling decisions are
    # identical either way — only compute dispatch changes.
    #
    # Optional: `decode_many(seqs) -> Optional[list[list[int]]]` — the
    # speculative-decoding step contract: one decode iteration may emit
    # SEVERAL verified tokens per sequence (>= 1 each). Returning None
    # means speculation is off and the core falls back to `decode`. The
    # core appends each list in order, truncating once the sequence
    # finishes mid-list, and records ("accept", rid, n_appended) in the
    # decision stream — CostModelBackend mirrors the acceptance count
    # analytically so sim/JAX decision parity holds under speculation.


@dataclasses.dataclass(frozen=True)
class ReplicaCoreConfig:
    page_size: int = 16
    n_pages: int = 512        # KV budget = n_pages * page_size tokens
    max_batch: int = 0        # max concurrent sequences; 0 = unbounded
    max_seq_len: int = 0      # prompt + output token cap; 0 = unbounded
    prefill_chunk: int = 0    # max tokens per backend.prefill call (rounded
                              # down to a page multiple); 0 = whole suffix
    preemption: bool = False  # higher-priority head may preempt running work
    reserved_pages: int = 0   # pinned at init (engine scratch pages)
    host_pages: int = 0       # host-memory KV tier size; 0 = tier off
    record_decisions: bool = False  # ("admit"|"reject"|"evict"|"preempt", ..)
    # multi-tenant fairness (repro.tenancy): "fcfs" keeps the decision
    # stream byte-identical to the pre-tenancy core; "vtc"/"wvtc" admit the
    # least-served tenant first and add ("admit_fair", rid, tenant) records
    discipline: str = "fcfs"
    cache_discount: float = 0.25   # VTC charge rate for cache-hit tokens
    # deadline-aware admission shedding: refuse (FinishReason.SHED) when
    # the snapshot-predicted TTFT already exceeds the request's deadline;
    # adds ("shed", rid) records. Off by default.
    shed_deadline: bool = False
    shed_params: Optional[AdmissionParams] = None   # None = DEFAULT_ADMISSION


class Seq:
    """One scheduled sequence. `tokens` = prompt + everything generated so
    far (it BECOMES the prompt again after a preemption); `pages` = block
    table over the shared allocator, cached prefix pages first."""

    __slots__ = ("req", "tokens", "pages", "cached_pages", "out",
                 "prompt_len", "max_new", "priority", "admit_index",
                 "new_this_step", "preemptions", "error", "host_plan")

    def __init__(self, req, prompt: tuple, max_new: int, priority: int):
        self.req = req
        self.tokens: list = list(prompt)
        self.prompt_len = len(prompt)
        self.pages: list[int] = []
        self.cached_pages = 0
        self.out: list = []
        self.max_new = max_new
        self.priority = priority
        self.admit_index = -1
        self.new_this_step = False
        self.preemptions = 0
        self.error: Optional[str] = None
        # in-flight host->device load plan: (radix node, host page, target
        # device page) triples; non-empty only while the seq is LOADING
        self.host_plan: list = []

    @property
    def pos(self) -> int:
        return len(self.tokens)

    @property
    def final_len(self) -> int:
        """Token length once generation completes (KV reserved upfront)."""
        return len(self.tokens) + (self.max_new - len(self.out))

    def done(self) -> bool:
        if len(self.out) >= self.max_new:
            return True
        sp = getattr(self.req, "sampling", None)
        stop = getattr(sp, "stop_token", None)
        return stop is not None and bool(self.out) and self.out[-1] == stop


@dataclasses.dataclass
class StepPlan:
    """What begin_step did: hosts stamp TTFTs on `admitted`, deliver
    error results for `rejected`, and resolve `shed` with
    `FinishReason.SHED` (deadline-aware admission refusals)."""
    admitted: list
    rejected: list
    shed: list = dataclasses.field(default_factory=list)


def _describe(req) -> tuple[tuple, int, int]:
    sp = getattr(req, "sampling", None)
    max_new = sp.max_new_tokens if sp is not None else req.output_len
    return tuple(req.prompt_tokens), int(max_new), int(getattr(req, "priority", 0))


class ReplicaCore:
    """The single implementation of replica-side continuous batching."""

    def __init__(self, cfg: ReplicaCoreConfig, backend: ReplicaBackend):
        if cfg.reserved_pages >= cfg.n_pages:
            raise ValueError("reserved_pages must leave room for sequences")
        self.cfg = cfg
        self.backend = backend
        self.alloc = BlockAllocator(cfg.n_pages)
        self.reserved: list[int] = (self.alloc.alloc(cfg.reserved_pages)
                                    if cfg.reserved_pages else [])
        self.radix = PagedRadix(self.alloc, cfg.page_size,
                                host_pages=cfg.host_pages)
        # demotion hook: backends that materialize KV snapshot the page D2H
        # here (fires while the device page's contents are still intact)
        demote_hook = getattr(backend, "on_demote", None)
        if cfg.host_pages and demote_hook is not None:
            self.radix.on_demote = demote_hook
        self.pending: deque[Seq] = deque()
        self.running: list[Seq] = []
        # host-hit admissions whose device pages are still streaming in from
        # the host tier (LOADING state): they hold batch slots and KV pages
        # but run no compute until the load completes at the NEXT
        # begin_step — one scheduler iteration of load latency, identical on
        # every backend (the real copy overlaps the current step's decode)
        self.loading: list[Seq] = []
        # host hook: called (seq, token, index) whenever a token is appended
        # (prefill boundary or decode) — tokens are already host-resident at
        # that point, so the hook adds ZERO device work; hosts buffer these
        # and drain them once per step as TokenEvents
        self.token_sink: Optional[callable] = None
        # stats
        self.steps = 0
        self.total_prefill_tokens = 0
        self.total_cached_tokens = 0
        self.host_hit_tokens = 0
        self.loaded_pages = 0
        self.completions = 0
        self.spec_steps = 0       # decode iterations served by decode_many
        self.spec_tokens = 0      # tokens those iterations emitted
        self.rejections = 0
        self.preemptions = 0
        self.cancellations = 0
        self.peak_running = 0
        self.peak_outstanding = 0
        self.peak_pages = 0
        self._admit_counter = 0
        # (head seq, radix content version, free pages) of the last
        # capacity-blocked admission attempt: while none of the three
        # change, re-matching the head would restamp its prefix MRU and
        # burn O(prompt) work every iteration for an identical outcome
        self._blocked: Optional[tuple] = None
        # admissions whose prefill is planned but not yet dispatched: the
        # batched-prefill plan surface. Flushed before any preemption
        # decision and at the end of begin_step, so no decision ever runs
        # while a queued sequence's tokens are still pending.
        self._prefill_q: list[tuple[Seq, int]] = []
        self.decisions: Optional[list[tuple]] = (
            [] if cfg.record_decisions else None)
        # multi-tenant fairness: the pluggable queue discipline. FCFS (the
        # default) is a pure no-op on every hook AND is never consulted in
        # the admission loop, so default decision streams stay byte-for-byte
        # identical to the pre-tenancy core.
        self.discipline = make_discipline(cfg.discipline,
                                          cache_discount=cfg.cache_discount)
        self._fair = cfg.discipline != "fcfs"
        self.sheds = 0
        self._shed_q: list[Seq] = []   # shed at submit; drained by begin_step

    # ------------------------------------------------------------ probes
    def pending_count(self) -> int:
        return len(self.pending)

    def outstanding(self) -> int:
        return len(self.pending) + len(self.running) + len(self.loading)

    def available(self) -> bool:
        """SP-P availability: no pending request (Alg. 1 line 5)."""
        return not self.pending

    def kv_utilization(self) -> float:
        return self.alloc.used_pages / self.alloc.n_pages

    @property
    def pool_pages(self) -> int:
        """Pages a sequence can ever hold (total minus reserved)."""
        return self.cfg.n_pages - self.cfg.reserved_pages

    # ------------------------------------------------------------ submit
    def submit(self, req) -> None:
        prompt, max_new, priority = _describe(req)
        seq = Seq(req, prompt, max_new, priority)
        if self.cfg.shed_deadline and should_shed(
                len(prompt), len(self.pending),
                len(self.running) + len(self.loading),
                getattr(req, "deadline_s", None),
                self.cfg.shed_params or DEFAULT_ADMISSION):
            # snapshot-only verdict (queue depths, prompt length, deadline —
            # no clocks), so every backend sheds the same rids: the record
            # parity-tests like the rest of the stream
            seq.error = "shed: predicted queueing delay exceeds deadline"
            self.sheds += 1
            self._record("shed", req.rid)
            self._shed_q.append(seq)
            return
        self.discipline.on_enqueue(tenant_of(req), req.rid,
                                   tenant_weight_of(req))
        self.pending.append(seq)
        self.peak_outstanding = max(self.peak_outstanding, self.outstanding())

    # ------------------------------------------------------------ cancel
    def cancel(self, rid) -> Optional[Seq]:
        """Abandon an in-flight request: drop it from `pending` (queued, or
        chunk-planned but not yet flushed) or reap it out of `running`
        mid-decode, freeing its pages — the radix keeps its own refs on any
        matched prefix, so allocator balance is exactly restored. Returns
        the removed Seq (the host turns it into a CANCELLED/DEADLINE
        result), or None if `rid` is not here. Recorded in the decision
        stream: backends must agree on cancels like on admissions."""
        for i, s in enumerate(self.pending):
            if s.req.rid == rid:
                del self.pending[i]
                # the blocked-head memo may reference this seq (or the head
                # behind it changed) — force a fresh admission attempt
                self._blocked = None
                self.cancellations += 1
                self._record("cancel", rid)
                # no refund — served tokens stay charged — but the tenant's
                # live-request tracking must retire the rid (idempotent)
                self.discipline.on_leave(rid)
                return s
        for s in self.running:
            if s.req.rid == rid:
                self.running.remove(s)
                if self._prefill_q:
                    self._prefill_q = [(q, c) for q, c in self._prefill_q
                                       if q is not s]
                self.alloc.free_all(s.pages)
                s.pages = []
                s.cached_pages = 0
                self.cancellations += 1
                self._record("cancel", rid)
                # no refund — served tokens stay charged — but the tenant's
                # live-request tracking must retire the rid (idempotent)
                self.discipline.on_leave(rid)
                return s
        for s in self.loading:
            if s.req.rid == rid:
                # cancel racing the load-back: drop the staged copy, release
                # the HOST pins (so demoted-then-orphaned pages can recycle)
                # and the device pages — allocator balance exactly restored
                self.loading.remove(s)
                abort = getattr(self.backend, "abort_load", None)
                if abort is not None:
                    abort(s)
                self.radix.unpin_host([hp for _, hp, _ in s.host_plan])
                s.host_plan = []
                self.alloc.free_all(s.pages)
                s.pages = []
                s.cached_pages = 0
                self.cancellations += 1
                self._record("cancel", rid)
                # no refund — served tokens stay charged — but the tenant's
                # live-request tracking must retire the rid (idempotent)
                self.discipline.on_leave(rid)
                return s
        return None

    # ------------------------------------------------------------ helpers
    def _pages(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.page_size)

    def _record(self, *evt) -> None:
        if self.decisions is not None:
            self.decisions.append(evt)

    def _oversized(self, seq: Seq) -> Optional[str]:
        """A request that can NEVER fit must be rejected, not left at the
        head of `pending` starving everything behind it (HOL deadlock)."""
        if self.cfg.max_seq_len and seq.final_len > self.cfg.max_seq_len:
            return (f"sequence length {seq.final_len} exceeds max_seq_len "
                    f"{self.cfg.max_seq_len}")
        if self._pages(seq.final_len) > self.pool_pages:
            return (f"request needs {self._pages(seq.final_len)} KV pages; "
                    f"replica budget is {self.pool_pages}")
        return None

    def _preempt_for(self, requester: Seq) -> bool:
        """Free pages for a higher-priority head by rolling the lowest-
        priority (then most recently admitted) running sequence back into
        `pending` right behind the requester. Its KV is recomputed on
        resume (tokens generated so far become part of its prompt)."""
        if not self.cfg.preemption:
            return False
        # a sequence that already finished (e.g. admitted this very step and
        # completed at prefill) must not be preempted: its pages free at the
        # coming finish_step anyway, and re-admitting it would sample one
        # token beyond its budget
        candidates = [s for s in self.running if not s.done()]
        if not candidates:
            return False
        victim = min(candidates, key=lambda s: (s.priority, -s.admit_index))
        if victim.priority >= requester.priority:
            return False
        self.running.remove(victim)
        self.alloc.free_all(victim.pages)
        victim.pages = []
        victim.cached_pages = 0
        victim.new_this_step = False
        victim.preemptions += 1
        self.preemptions += 1
        self._record("preempt", victim.req.rid)
        self.pending.insert(1, victim)
        return True

    # ------------------------------------------------------------ admit
    def begin_step(self) -> StepPlan:
        """Admission phase of one continuous-batching iteration: admit from
        `pending` while pages and batch slots allow, rejecting oversized
        requests. Prefills are PLANNED per admission and flushed in packed
        rounds (backend `prefill_batch` when available) — before any
        preemption decision and at the end of the phase — so decisions are
        identical to sequential prefill."""
        admitted: list[Seq] = []
        rejected: list[Seq] = []
        shed, self._shed_q = self._shed_q, []
        self._finish_loads(admitted)
        while self.pending:
            if self.cfg.max_batch and (len(self.running) + len(self.loading)
                                       >= self.cfg.max_batch):
                break
            if self._fair:
                # the discipline picks who gets this admission slot; moving
                # its choice to the head changes head identity, which is
                # exactly what invalidates the blocked-head memo below
                idx = self.discipline.select(self.pending)
                if idx:
                    chosen = self.pending[idx]
                    del self.pending[idx]
                    self.pending.appendleft(chosen)
            seq = self.pending[0]
            if self._blocked is not None:
                bseq, bver, bfree = self._blocked
                if (bseq is seq and bver == self.radix.content_version
                        and bfree == self.alloc.free_pages):
                    break               # nothing changed: still blocked
                self._blocked = None
            why = self._oversized(seq)
            if why is not None:
                self.pending.popleft()
                seq.error = why
                self.rejections += 1
                self._record("reject", seq.req.rid)
                self.discipline.on_leave(seq.req.rid)
                rejected.append(seq)
                continue
            ps = self.cfg.page_size
            if self.radix.host is not None:
                cached_len, cached_pages, host_nodes = \
                    self.radix.match_tiered(tuple(seq.tokens))
            else:
                cached_len, cached_pages = self.radix.match(tuple(seq.tokens))
                host_nodes = []
            # never let the cache cover the WHOLE sequence — the last token
            # must be (re)prefilled so prefill produces next-token logits.
            # Trim the HOST continuation from the end first (cheapest to
            # give up: those pages would need a load-back anyway).
            total_len = cached_len + len(host_nodes) * ps
            if total_len >= len(seq.tokens):
                drop = (total_len - len(seq.tokens)) // ps + 1
                keep_host = max(0, len(host_nodes) - drop)
                drop -= len(host_nodes) - keep_host
                host_nodes = host_nodes[:keep_host]
                if drop:
                    cached_pages = cached_pages[:len(cached_pages) - drop]
                    cached_len = len(cached_pages) * ps
                total_len = cached_len + len(host_nodes) * ps
            need = self._pages(seq.final_len) - len(cached_pages)
            # hold refs on the matched prefix BEFORE evicting so eviction
            # pressure can never free the pages this admission depends on;
            # same for the host continuation (pins block host-LRU eviction)
            self.radix.take_refs(cached_pages)
            host_pins = [nd.host_page for nd in host_nodes]
            if host_pins:
                self.radix.pin_host(host_pins)
            short = need - self.alloc.free_pages
            if short > 0:
                freed: list[int] = []
                got = self.radix.evict(short, freed)
                for p in freed:
                    self._record("evict", p)
                if got < short:
                    self.radix.release_refs(cached_pages)
                    if host_pins:
                        self.radix.unpin_host(host_pins)
                    # every already-admitted sequence must have its prefill
                    # tokens before a preemption decision (done() reads
                    # them; a queued victim's pages must not be freed with
                    # its prefill still pending)
                    self._flush_prefills()
                    if self._preempt_for(seq):
                        continue            # retry the head with freed pages
                    self._blocked = (seq, self.radix.content_version,
                                     self.alloc.free_pages)
                    break                   # head waits for capacity
            self.pending.popleft()
            fresh = self.alloc.alloc(need)
            seq.pages = list(cached_pages) + fresh
            seq.cached_pages = len(cached_pages) + len(host_nodes)
            resumed = seq.admit_index >= 0      # preempted earlier
            seq.admit_index = self._admit_counter
            self._admit_counter += 1
            if not resumed:
                # hit-rate stats cover served PROMPTS; a preemption resume
                # re-prefills recompute overhead (its cost still lands in
                # the backend), and the request keeps its first-admission
                # cached_tokens
                seq.req.cached_tokens = total_len
                self.total_prefill_tokens += len(seq.tokens)
                self.total_cached_tokens += total_len
                self.host_hit_tokens += len(host_nodes) * ps
                # VTC charging: uncached prefill at full price, cache hits
                # (device + host) at the discount — charged ONCE per request
                # (a preemption resume's recompute is the system's fault,
                # not the tenant's)
                self.discipline.on_admit(
                    tenant_of(seq.req), len(seq.tokens) - total_len,
                    total_len, tenant_weight_of(seq.req))
            if host_nodes:
                # LOADING admission: the first len(host_nodes) fresh pages
                # are the load-back targets; prefill waits for the copy
                seq.host_plan = [(nd, nd.host_page, dp)
                                 for nd, dp in zip(host_nodes, fresh)]
                self.loading.append(seq)
                self._record("admit", seq.req.rid, total_len)
                if self._fair:
                    self._record("admit_fair", seq.req.rid,
                                 tenant_of(seq.req))
                self._record("hostload", seq.req.rid, len(host_nodes))
                load = getattr(self.backend, "load_pages", None)
                if load is not None:
                    load(seq, [(hp, dp) for _, hp, dp in seq.host_plan])
                self.loaded_pages += len(host_nodes)
                continue
            self._prefill_q.append((seq, cached_len))
            seq.new_this_step = True
            self.running.append(seq)
            admitted.append(seq)
            self._record("admit", seq.req.rid, cached_len)
            if self._fair:
                self._record("admit_fair", seq.req.rid, tenant_of(seq.req))
        self._flush_prefills()
        self.steps += 1
        self.peak_running = max(self.peak_running, len(self.running))
        self.peak_outstanding = max(self.peak_outstanding, self.outstanding())
        self.peak_pages = max(self.peak_pages, self.alloc.used_pages)
        return StepPlan(admitted, rejected, shed)

    def _finish_loads(self, admitted: list) -> None:
        """Complete last step's host->device loads: promote the radix nodes
        onto the streamed-in device pages, release host pins, and move the
        sequences into `running` with their prefill planned from the end of
        the combined (device + promoted) prefix. They join THIS step's
        `admitted` plan, so hosts stamp TTFT at their true first token."""
        if not self.loading:
            return
        loads, self.loading = self.loading, []
        fin = getattr(self.backend, "finish_load", None)
        for seq in loads:
            if fin is not None:
                fin(seq)
            for node, _hp, dp in seq.host_plan:
                self.radix.promote(node, dp)
            self.radix.unpin_host([hp for _, hp, _ in seq.host_plan])
            seq.host_plan = []
            self._prefill_q.append((seq, seq.cached_pages
                                    * self.cfg.page_size))
            seq.new_this_step = True
            self.running.append(seq)
            admitted.append(seq)

    # --------------------------------------------------- KV prefix import
    def inject_prefix(self, tokens: tuple) -> tuple[int, int, list[int]]:
        """Install an externally-transferred KV prefix (cross-region
        pull-prefix): claim device pages for the FULL-page prefix of
        `tokens` not already device-cached and hand them to the radix.
        Returns (n_tokens_installed, start_block, new_pages) — the caller
        scatters the pulled KV bytes into `new_pages`, which cover token
        blocks [start_block, start_block + len(new_pages)). Capacity-capped:
        evicts for room but never preempts, installing what fits."""
        ps = self.cfg.page_size
        n = (len(tokens) // ps) * ps
        if n == 0:
            return 0, 0, []
        toks = tuple(tokens[:n])
        cached_len, cached_pages = self.radix.match(toks)
        need = n // ps - len(cached_pages)
        if need <= 0:
            return cached_len, len(cached_pages), []
        short = need - self.alloc.free_pages
        if short > 0:
            freed: list[int] = []
            self.radix.evict(short, freed)
            for p in freed:
                self._record("evict", p)
        take = min(need, self.alloc.free_pages)
        if take <= 0:
            return cached_len, len(cached_pages), []
        n = (len(cached_pages) + take) * ps
        new_pages = self.alloc.alloc(take)
        self.radix.insert(tuple(tokens[:n]), list(cached_pages) + new_pages)
        self.alloc.free_all(new_pages)       # the tree's refs survive
        return n, len(cached_pages), new_pages

    def _chunks(self, seq: Seq, cached_len: int) -> list[tuple[int, int, bool]]:
        """Chunked prefill plan over the uncached suffix: page-aligned
        chunks of at most cfg.prefill_chunk tokens; only the final chunk
        samples."""
        ps = self.cfg.page_size
        chunk = self.cfg.prefill_chunk
        if chunk:
            chunk = max(ps, (chunk // ps) * ps)
        n = len(seq.tokens)
        start, out = cached_len, []
        while start < n:
            end = n if not chunk else min(n, start + chunk)
            out.append((start, end, end == n))
            start = end
        return out

    def _flush_prefills(self) -> None:
        """Dispatch every queued admission's prefill, packing one chunk
        from each sequence per round (chunks of one sequence stay
        sequential across rounds — later chunks attend to earlier ones)."""
        if not self._prefill_q:
            return
        q, self._prefill_q = self._prefill_q, []
        plans = [(seq, self._chunks(seq, cached_len)) for seq, cached_len in q]
        batch_fn = getattr(self.backend, "prefill_batch", None)
        depth = max((len(c) for _, c in plans), default=0)
        for r in range(depth):
            items = [(seq, *chunks[r]) for seq, chunks in plans
                     if r < len(chunks)]
            if not items:
                continue
            if batch_fn is not None:
                toks = batch_fn(items)
            else:
                toks = [self.backend.prefill(seq, s, e, smp)
                        for seq, s, e, smp in items]
            for (seq, _s, _e, smp), tok in zip(items, toks):
                if smp and tok is not None:
                    seq.out.append(int(tok))
                    seq.tokens.append(int(tok))
                    if self.token_sink is not None:
                        self.token_sink(seq, int(tok), len(seq.out) - 1)

    # ------------------------------------------------------------ decode
    def finish_step(self) -> list[Seq]:
        """Decode phase: one decode iteration for every previously-running
        sequence (admissions already got theirs from prefill), then reap.
        With a speculative backend (`decode_many`) an iteration may emit
        several verified tokens per sequence; each is appended (and
        streamed through `token_sink`) in order, truncated once the
        sequence hits its budget/stop token, with the per-sequence emitted
        count recorded as ("accept", rid, n) in the decision stream."""
        batch = [s for s in self.running
                 if not s.new_this_step and not s.done()]
        if batch:
            many = getattr(self.backend, "decode_many", None)
            tok_lists = many(batch) if many is not None else None
            spec = tok_lists is not None
            if not spec:
                tok_lists = [[t] for t in self.backend.decode(batch)]
            if spec:
                self.spec_steps += 1
            for s, toks in zip(batch, tok_lists):
                n_app = 0
                for t in toks:
                    if s.done():
                        break                  # budget/stop hit mid-list
                    s.out.append(int(t))
                    s.tokens.append(int(t))
                    if self.token_sink is not None:
                        self.token_sink(s, int(t), len(s.out) - 1)
                    n_app += 1
                if spec:
                    self.spec_tokens += n_app
                    self._record("accept", s.req.rid, n_app)
                if n_app:
                    self.discipline.on_tokens(tenant_of(s.req), n_app,
                                              tenant_weight_of(s.req))
        for s in self.running:
            s.new_this_step = False
        finished = [s for s in self.running if s.done()]
        for s in finished:
            self.running.remove(s)
            # claim the sequence's FULL pages into the radix cache so the
            # next turn of this conversation reuses them (the final token
            # was sampled but never written to KV), then drop the seq refs
            full = (s.pos - 1) // self.cfg.page_size
            self.radix.insert(tuple(s.tokens[:full * self.cfg.page_size]),
                              s.pages[:full])
            self.alloc.free_all(s.pages)
            self.completions += 1
            self.discipline.on_leave(s.req.rid)
        return finished

    def tenant_counters(self) -> dict:
        """The discipline's per-tenant service counters ({} under FCFS) —
        the replica-side feed for the routing layer's `TenantLedger`."""
        return self.discipline.counters()

    def hit_rate(self) -> float:
        """COMBINED (device + host) hit rate over served prompt tokens."""
        return self.total_cached_tokens / max(1, self.total_prefill_tokens)

    def host_hit_rate(self) -> float:
        """Fraction of served prompt tokens hit in the HOST tier only —
        cache value that a device-only radix would have lost to eviction."""
        return self.host_hit_tokens / max(1, self.total_prefill_tokens)
