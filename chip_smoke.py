#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, all started together) and print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card:
     paged_decode at Llama-3.1-8B decode shapes, ragged lengths and garbage
     block tables; page_gather / page_scatter at the full-width
     Llama-3.1-8B pool (32 x 1024 x 16 x 8 x 128), bf16 and fp32, bit for
     bit, with untouched pages and a gather/scatter round trip checked;
  4. serve multi-turn sessions that share prefixes through the port's
     `Engine` on full-width Llama-3.1-8B (random bf16 weights from a seeded
     generator, all 32 layers), check every request's result, the prefix
     cache and the kernel launch counts, then hold the kernel against its
     plain version on one decode step's captured inputs;
  4b. the host KV tier at full width: a device pool small enough to force
     demotion plus `host_pages`; demotions, load-backs, host hits, the
     restored bytes and the page copy launch counts are checked;
  4c. the SkyWalker router at full width: `InProcessRouter` over two
     regions of one engine each (one shared params dict) pulls a cached
     prefix across regions; the PULL decision, the pulled request's cached
     tokens and the imported bytes are checked;
  5. check the engine's tokens against its plain CPU path on a small
     fp32 model: plain serving, the host tier, and one router pull;
  6. print measurements (engine throughput, a profile of steady decode
     steps, each kernel's time beside its bound, its plain version's and
     its library call's time, the host tier's D2H / H2D rates and a
     pull's time per MB) with the card's name and power limit,
     the kernel table as one JSON line, and last the result line
     {"ok": true, "device": {...}}.

Exits 2 without printing a result when CUDA is unavailable or when the
port's sources are not beside this script.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

DEVICE = "cuda"
MODEL = "llama31-8b"               # the paper's serving model, full width
SMALL = "llama31-8b-reduced"       # the fp32 model of the CPU token check
KERNELS = ("paged_decode", "page_copy")   # csrc/<name>.cu
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 2e-5}
# per (sequence, head) row against the plain version in fp32: two bf16
# ulps at the row's largest value; fp32 summation order alone for fp32
ROW_RTOL = {"torch.bfloat16": 8e-3, "torch.float32": 1e-4}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def device_events(prof) -> list:
    """The device's own entries of a torch.profiler run (kernels and
    copies): an operator's entry repeats the time of the kernels it
    launched, so it is left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]


def device_ms(fn, iters: int = 50, warmup: int = 5) -> tuple[float, str]:
    """Device time of one call of fn in ms: torch.profiler's kernel time
    over `iters` calls, divided by iters, so the host work between
    launches (a wrapper's checks, its allocations, the launch itself) does
    not count. Falls back to CUDA events around back-to-back calls, host
    gaps included, when the profiler sees no device time. Returns (ms,
    "profiler" | "events")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(dev_us(e) for e in device_events(prof))
    if us:
        return us / 1e3 / iters, "profiler"
    return cuda_ms(fn, iters, warmup=0), "events"


def max_abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want) -> float:
    import torch
    tol = TOL[str(got.dtype)]
    err = max_abs_err(got, want)
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"{name}: max |err| {err:.3e} beyond atol=rtol={tol}")
    return err


def check_rows(name: str, got, q, k_pages, v_pages, table, lens) -> float:
    """Hold each (sequence, head) row of a paged decode output against the
    plain version run in fp32 on the same inputs, upcast: the row's max
    error over the row's max |value|. A long context's outputs are small,
    so a fixed absolute tolerance barely binds there; this bound holds
    every row as tightly as the output's own rounding allows."""
    from repro_torch.kernels import ref
    want = ref.paged_decode_ref(q.float(), k_pages.float(), v_pages.float(),
                                table, lens)
    row_err = ((got.float() - want).abs().amax(-1)
               / want.abs().amax(-1).clamp_min(1e-30))
    worst = float(row_err.max())
    tol = ROW_RTOL[str(got.dtype)]
    if not worst <= tol:
        b, h = divmod(int(row_err.argmax()), row_err.shape[1])
        fail(f"{name}: row (seq {b}, head {h}, len {int(lens[b])}) max "
             f"|err| / max |want| = {worst:.3e} beyond {tol} against the "
             f"fp32 plain version")
    return worst


def paged_bound(q, k_pages, table, lens) -> tuple[float, str]:
    """Least time for one paged decode call: the bytes it must move (the
    live K/V rows, q, the live table entries, lens and the output) over
    the HBM rate, against its flops (QK and PV) over the peak of its
    dtype. Returns (ms, "bytes" | "operations")."""
    B, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    it = q.element_size()
    n_tok = int(lens.sum())
    n_pages = int(((lens + page - 1) // page).sum())
    nbytes = (2 * n_tok * K * hd * it + 2 * B * H * hd * it
              + 4 * n_pages + 4 * B)
    flops = 4 * n_tok * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype)]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_inputs(dtype, lens, seed: int):
    """Llama-3.1-8B decode shapes: H=32, K=8, hd=128, page=16, with every
    table entry past a sequence's ragged edge set to garbage."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, H, K, hd, page = len(lens), 32, 8, 128, 16
    npg = max(-(-n // page) for n in lens)
    n_pages = sum(-(-n // page) for n in lens) + 8
    q = torch.randn((B, H, hd), generator=g, device=DEVICE).to(dtype)
    kp = torch.randn((n_pages, page, K, hd), generator=g, device=DEVICE).to(dtype)
    vp = torch.randn((n_pages, page, K, hd), generator=g, device=DEVICE).to(dtype)
    perm = torch.randperm(n_pages, generator=g, device=DEVICE).to(torch.int32)
    table = torch.empty((B, npg), dtype=torch.int32, device=DEVICE)
    off = 0
    for i, n in enumerate(lens):
        live = -(-n // page)
        table[i, :live] = perm[off:off + live]
        table[i, live:] = -1 if i % 2 else 2 ** 31 - 1
        off += live
    return q, kp, vp, table, torch.tensor(lens, dtype=torch.int32,
                                          device=DEVICE)


def session_requests(GenRequest, SamplingParams, vocab: int, rng):
    """First turns of four chat sessions that share a system prompt; two
    greedy, two sampled."""
    system = rng.integers(0, vocab, size=256).tolist()
    kws = [dict(max_new_tokens=40),
           dict(max_new_tokens=40, temperature=0.7, top_k=50, seed=1),
           dict(max_new_tokens=40),
           dict(max_new_tokens=40, temperature=1.0, seed=2)]
    return [GenRequest(prompt_tokens=tuple(
        system + rng.integers(0, vocab, size=48 + 8 * i).tolist()),
        sampling=SamplingParams(**kw)) for i, kw in enumerate(kws)]


POOL = (32, 1024, 16, 8, 128)      # Llama-3.1-8B pool: L, P, page, K, hd
# the pull scenario of tests/test_kvtransfer.py: a slow prefill and a fast
# WAN, so pulling a cached prefix beats recomputing or forwarding it
PULL_PARAMS = dict(kv_bytes_per_token=1e5, wan_rtt_s=0.1, prefill_tps=100.0,
                   min_pull_tokens=8)


def bits(t):
    """A tensor's raw bits, for comparisons that tolerate nothing."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same_bits(a, b) -> bool:
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(bits(a), bits(b)))


def page_ids(n: int, P: int, g):
    """n unique page ids in random order, P - 1 among them."""
    import torch
    rest = torch.randperm(P - 1, generator=g, device=DEVICE)[:n - 1]
    ids = torch.cat([rest, torch.tensor([P - 1], device=DEVICE)])
    return ids[torch.randperm(n, generator=g, device=DEVICE)].to(torch.int32)


def check_page_copies(dtype, gather, scatter) -> float:
    """page_gather / page_scatter against their plain versions at the
    full-width pool, bit for bit (tolerance 0): N in {1, 5, 16, 100};
    pages outside the ids untouched; gather then scatter restores the
    pool. Returns the largest |kernel - plain| seen (0.0 when exact)."""
    import torch
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEVICE).manual_seed(11)
    P = POOL[1]
    kp = torch.randn(POOL, generator=g, device=DEVICE).to(dtype)
    vp = torch.randn(POOL, generator=g, device=DEVICE).to(dtype)
    worst = 0.0
    for n in (1, 5, 16, 100):
        ids = page_ids(n, P, g)
        name = f"page copy {str(dtype)[6:]} N={n}"
        ks, vs = gather(kp, vp, ids)
        torch.cuda.synchronize()
        want_k, want_v = ref.page_gather_ref(kp, ids), ref.page_gather_ref(vp, ids)
        worst = max(worst, max_abs_err(ks, want_k), max_abs_err(vs, want_v))
        if not (same_bits(ks, want_k) and same_bits(vs, want_v)):
            fail(f"{name}: page_gather differs from its plain version")
        new_k = torch.randn(ks.shape, generator=g, device=DEVICE).to(dtype)
        new_v = torch.randn(ks.shape, generator=g, device=DEVICE).to(dtype)
        k2, v2 = kp.clone(), vp.clone()
        scatter(k2, v2, new_k, new_v, ids)
        torch.cuda.synchronize()
        want_k = ref.page_scatter_ref(kp.clone(), new_k, ids)
        worst = max(worst, max_abs_err(k2, want_k))
        if not same_bits(k2, want_k):
            fail(f"{name}: page_scatter (K) differs from its plain version")
        del want_k
        want_v = ref.page_scatter_ref(vp.clone(), new_v, ids)
        worst = max(worst, max_abs_err(v2, want_v))
        if not same_bits(v2, want_v):
            fail(f"{name}: page_scatter (V) differs from its plain version")
        del want_v
        keep = torch.ones(P, dtype=torch.bool, device=DEVICE)
        keep[ids.long()] = False
        if not (same_bits(k2[:, keep], kp[:, keep])
                and same_bits(v2[:, keep], vp[:, keep])):
            fail(f"{name}: page_scatter changed pages outside its ids")
        k2[:, ids.long()] = 0
        v2[:, ids.long()] = 0
        scatter(k2, v2, ks, vs, ids)
        torch.cuda.synchronize()
        if not (same_bits(k2, kp) and same_bits(v2, vp)):
            fail(f"{name}: gather then scatter did not restore the pool")
        del k2, v2
    return worst


def copy_bound(n: int, itemsize: int) -> float:
    """Least time of one page copy call, in ms: N tiles of both pools read
    once and written once over the HBM rate (no arithmetic)."""
    L, _, page, K, hd = POOL
    return 1e3 * 2 * n * L * page * K * hd * itemsize * 2 / HBM_BYTES_PER_S


def time_page_copies(gather, scatter, ns=(16, 100)) -> dict:
    """Device ms of each copy at N pages on the full-width bf16 pools:
    the kernel, its plain version and its library call (`device_ms`), and
    the bound; besides, the kernel's CUDA-event ms over back-to-back
    wrapper calls, which counts the wrapper's host work where it outlasts
    the kernel. Each run of calls cycles over disjoint id sets, so the
    pages come from HBM (2 GB pools against a 50 MB L2), as a flush or a
    load-back finds them. The library yardsticks take one call per pool:
    `index_select(pool, 1, ids)` and `pool.index_copy_(1, ids,
    stack.transpose(0, 1))`."""
    import torch
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEVICE).manual_seed(12)
    P = POOL[1]
    kp = torch.randn(POOL, generator=g, device=DEVICE).to(torch.bfloat16)
    vp = torch.randn(POOL, generator=g, device=DEVICE).to(torch.bfloat16)
    out = {}
    for n in ns:
        perm = torch.randperm(P, generator=g, device=DEVICE).to(torch.int32)
        sets = [perm[i * n:(i + 1) * n] for i in range(min(8, P // n))]
        sets64 = [s.long() for s in sets]
        ks, vs = gather(kp, vp, sets[0])
        ks_t, vs_t = ks.transpose(0, 1), vs.transpose(0, 1)
        turn = [0]

        def nxt(pool):
            turn[0] += 1
            return pool[turn[0] % len(sets)]

        def g_lib():
            i = nxt(sets64)
            torch.index_select(kp, 1, i)
            torch.index_select(vp, 1, i)

        def s_plain():
            i = nxt(sets)
            ref.page_scatter_ref(kp, ks, i)
            ref.page_scatter_ref(vp, vs, i)

        def s_lib():
            i = nxt(sets64)
            kp.index_copy_(1, i, ks_t)
            vp.index_copy_(1, i, vs_t)

        def g_plain():
            i = nxt(sets)
            ref.page_gather_ref(kp, i)
            ref.page_gather_ref(vp, i)

        def g_kernel():
            gather(kp, vp, nxt(sets))

        def s_kernel():
            scatter(kp, vp, ks, vs, nxt(sets))

        out[n] = {"bound": copy_bound(n, 2)}
        for name, kern, plain, lib in (("gather", g_kernel, g_plain, g_lib),
                                       ("scatter", s_kernel, s_plain, s_lib)):
            out[n][name] = {
                "kernel": device_ms(kern), "events": cuda_ms(kern),
                "plain": device_ms(plain, iters=20),
                "library": device_ms(lib, iters=20)}
    return out


class CopyCounts:
    """What should launch the page copy kernels on the given backends
    from now on: each non-empty demotion flush (the backend's `flushes`)
    and each export launches page_gather once; each load finish and each
    import launches page_scatter once."""

    def __init__(self, backends):
        self.backends = backends
        self._flushes0 = sum(be.flushes for be in backends)
        self.exports = self.scatters = 0
        for be in backends:
            self._wrap(be)

    @property
    def gathers(self) -> int:
        return (sum(be.flushes for be in self.backends) - self._flushes0
                + self.exports)

    def _wrap(self, be) -> None:
        export, finish, imp = be.export_pages, be.finish_load, be.import_pages

        def _export(pages):
            self.exports += bool(len(pages))
            return export(pages)

        def _finish(seq):
            self.scatters += 1
            finish(seq)

        def _import(pages, k_stack, v_stack):
            self.scatters += bool(len(pages))
            imp(pages, k_stack, v_stack)

        be.export_pages, be.finish_load, be.import_pages = (_export, _finish,
                                                            _import)


def host_tier_sessions(eng, GenRequest, SamplingParams, *, system: int,
                       turn: int, follow: int, max_new: int, seed: int):
    """Six two-turn chat sessions sharing a system prompt: every first turn,
    then every follow-up (the first turn, its answer and `follow` new
    tokens). Five greedy sessions and one sampled."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vocab = eng.cfg.vocab
    sys_toks = rng.integers(1, vocab, size=system).tolist()
    kws = [dict(max_new_tokens=max_new)] * 5 + [
        dict(max_new_tokens=max_new, temperature=0.8, top_k=20, seed=3)]
    t1 = [GenRequest(prompt_tokens=tuple(
        sys_toks + rng.integers(1, vocab, size=turn).tolist()),
        sampling=SamplingParams(**kw)) for kw in kws]
    r1 = eng.generate(t1)
    t2 = [GenRequest(prompt_tokens=r.prompt_tokens + o.output_tokens + tuple(
        rng.integers(1, vocab, size=follow).tolist()), sampling=r.sampling)
        for r, o in zip(t1, r1)]
    return r1 + eng.generate(t2)


def pull_scenario(cfg, params, device, ecfg, prompt_len: int, seed: int,
                  on_ready=None):
    """`tests/test_kvtransfer.py`'s cross-region pull over the port's
    engines: eu serves a prompt, us learns that eu caches it, the replay
    at us pulls eu's KV pages. Returns (router, first rid, replay rid,
    prompt, what moved: the export's (n, k, v) and the imported length).
    `on_ready(router)` runs once the engines exist, just before the first
    request."""
    import numpy as np
    from repro_torch.routing import (KVTransferParams, PrefixTreePolicy,
                                     RoutingConfig)
    from repro_torch.serving import (Engine, GenRequest, InProcessRouter,
                                     SamplingParams)
    router = InProcessRouter(
        remote_policy=PrefixTreePolicy(),
        cfg=RoutingConfig(record_decisions=True, kv_transfer=True,
                          kv_params=KVTransferParams(**PULL_PARAMS)))
    for region in ("us", "eu"):
        router.add_region(region, PrefixTreePolicy()).add_engine(
            f"{region}-r0", Engine(cfg, params, ecfg, device=device))
    eu = router.lbs["eu"].engines["eu-r0"]
    us = router.lbs["us"].engines["us-r0"]
    moved: dict = {}
    export, import_ = eu.export_prefix, us.import_prefix

    def _export(tokens):
        moved["export"] = export(tokens)
        return moved["export"]

    def _import(tokens, k_stack, v_stack):
        moved["import_n"] = len(tokens)
        return import_(tokens, k_stack, v_stack)

    eu.export_prefix, us.import_prefix = _export, _import
    if on_ready is not None:
        on_ready(router)
    rng = np.random.default_rng(seed)
    prompt = tuple(int(t) for t in rng.integers(1, cfg.vocab, size=prompt_len))
    reqs = [GenRequest(prompt_tokens=prompt,
                       sampling=SamplingParams(max_new_tokens=8))
            for _ in range(2)]
    router.submit("eu", reqs[0])
    router.run_until_idle()
    router.lbs["us"].core.remote_policy.tree.insert(prompt, "eu")
    router.submit("us", reqs[1])
    router.run_until_idle()
    return router, reqs[0].rid, reqs[1].rid, prompt, moved


def host_tier_rates(cfg, params, n: int = 100) -> dict:
    """Seconds of the host tier's copies of n full-width pages on a backend
    of its own, through its public hooks: a demotion flush (`on_demote` of
    n pages, then `export_pages([])`, a dispatch that flushes and moves
    nothing else: page_gather, the D2H of both stacks, the copy into the
    host mirror), the D2H alone, a load-back until its H2D has landed
    (`load_pages` with `overlap_loads=False`, which waits for its copy:
    pinned staging plus the side stream's H2D), the H2D alone, and the
    scatter that finishes a load. Median of three after one warm-up."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.replica import ReplicaCore, ReplicaCoreConfig
    from repro_torch.serving import TorchPagedBackend
    be = TorchPagedBackend(cfg, params, n_pages=n + 1, page_size=16,
                           device=DEVICE, overlap_loads=False)
    be.bind(ReplicaCore(ReplicaCoreConfig(
        page_size=16, n_pages=n + 1, max_batch=1, max_seq_len=16,
        reserved_pages=1, host_pages=n), be))
    be.k_pages.normal_()
    be.v_pages.normal_()
    dev_ids = list(range(1, n + 1))
    ids = torch.tensor(dev_ids, dtype=torch.int32, device=DEVICE)
    t = {"flush": [], "d2h": [], "h2d": [], "load": [], "finish": []}
    for _ in range(4):
        for i, d in enumerate(dev_ids):
            be.on_demote(d, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.export_pages([])                  # the flush ends in its own sync
        t["flush"].append(time.perf_counter() - t0)
        ks, vs = ops.page_gather(be.k_pages, be.v_pages, ids)
        kh = torch.empty(ks.shape, dtype=ks.dtype, pin_memory=True)
        vh = torch.empty(vs.shape, dtype=vs.dtype, pin_memory=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kh.copy_(ks, non_blocking=True)
        vh.copy_(vs, non_blocking=True)
        torch.cuda.synchronize()
        t["d2h"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ks.copy_(kh, non_blocking=True)
        vs.copy_(vh, non_blocking=True)
        torch.cuda.synchronize()
        t["h2d"].append(time.perf_counter() - t0)
        key = object()
        t0 = time.perf_counter()
        be.load_pages(key, list(zip(range(n), dev_ids)))
        t["load"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        be.finish_load(key)
        torch.cuda.synchronize()
        t["finish"].append(time.perf_counter() - t0)
    if be.flushes != 4 or be.loaded_pages != 4 * n:
        fail(f"host tier rates: {be.flushes} flushes and {be.loaded_pages} "
             f"pages loaded, expected 4 and {4 * n}")
    out = {k: statistics.median(v[1:]) for k, v in t.items()}
    out["bytes"] = 2 * ks.numel() * ks.element_size()
    return out


def check_results(name: str, results, vocab: int) -> None:
    from repro_torch.serving import FinishReason
    for r in results:
        if r.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP):
            fail(f"{name}: request {r.rid} ended {r.finish_reason} "
                 f"({r.error})")
        if not r.output_tokens or not all(0 <= t < vocab
                                          for t in r.output_tokens):
            fail(f"{name}: request {r.rid}: bad tokens "
                 f"{r.output_tokens[:8]}")


def host_tier_phase(cfg, params) -> tuple:
    """The host KV tier at full width: a 64-page device pool (1024 tokens)
    under six 400-token sessions forces demotion to 256 host pages; the
    follow-up turns load their prefixes back. Checks the results, the
    demotion / load / host-hit counters, the pins, every loaded page's
    bytes against the bytes demoted there, and the copy kernels' launches.
    Returns the launches of (page_gather, page_scatter, paged_decode)."""
    from repro_torch.kernels.page_copy import page_gather, page_scatter
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                     SamplingParams)
    eng = Engine(cfg, params, EngineConfig(
        page_size=16, n_pages=64, max_batch=3, max_seq_len=2048,
        host_pages=256), seed=0, device=DEVICE)
    be, core = eng.backend, eng.core
    counts = CopyCounts([be])
    snaps, restored = {}, [0]
    demote, finish = core.radix.on_demote, be.finish_load

    def snap_demote(dev_page, host_page):
        # the device bytes of a page as the radix demotes it
        snaps[host_page] = (be.k_pages[:, dev_page].clone(),
                            be.v_pages[:, dev_page].clone())
        demote(dev_page, host_page)

    def checked_finish(seq):
        plan = [(hp, dp) for _, hp, dp in seq.host_plan]
        finish(seq)
        for hp, dp in plan:
            k, v = snaps[hp]
            if not (same_bits(be.k_pages[:, dp], k)
                    and same_bits(be.v_pages[:, dp], v)):
                fail(f"host tier: device page {dp} loaded from host page "
                     f"{hp} differs from the bytes demoted there")
            restored[0] += 1

    core.radix.on_demote, be.finish_load = snap_demote, checked_finish
    page_gather.launches = page_scatter.launches = 0   # host-tier path starts
    paged_decode.launches = 0
    res = host_tier_sessions(eng, GenRequest, SamplingParams, system=256,
                             turn=128, follow=32, max_new=16, seed=4)
    launches = (page_gather.launches, page_scatter.launches,
                paged_decode.launches)                # host-tier path ends
    expect = (counts.gathers, counts.scatters)
    check_results("host tier", res, cfg.vocab)
    if not be.demoted_pages == core.radix.demoted_pages > 0:
        fail(f"host tier: backend demoted {be.demoted_pages} pages, the "
             f"radix {core.radix.demoted_pages}")
    if not be.loaded_pages == core.loaded_pages > 0:
        fail(f"host tier: backend loaded {be.loaded_pages} pages, the "
             f"core {core.loaded_pages}")
    if not core.host_hit_tokens > 0:
        fail("host tier: no host hit")
    if core.radix.host.total_pins():
        fail(f"host tier: {core.radix.host.total_pins()} host pins left")
    if not restored[0]:
        fail("host tier: no loaded page was held against its demoted bytes")
    if launches[:2] != expect:
        fail(f"host tier: page_gather / page_scatter launched "
             f"{launches[:2]} times; non-empty flushes + exports and "
             f"finishes + imports were {expect}")
    print(f"host tier: {len(res)} requests, demoted {be.demoted_pages} "
          f"pages, loaded back {be.loaded_pages} ({restored[0]} held bit "
          f"for bit against their demoted bytes), host-hit tokens "
          f"{core.host_hit_tokens}, hit rate {eng.hit_rate():.3f}; "
          f"launches page_gather {launches[0]} = non-empty flushes, "
          f"page_scatter {launches[1]} = load finishes, paged_decode "
          f"{launches[2]}", flush=True)
    return launches


def router_phase(cfg, params) -> tuple:
    """The router at full width: two regions of one engine each on one
    shared params dict; a 384-token prompt served in eu is pulled into
    us's pool for its replay. Checks the PULL decision, the replay's
    cached tokens, the imported bytes against the exported ones and the
    copy kernels' launches. Returns the launches of (page_gather,
    page_scatter, paged_decode) and the two engines and the prompt."""
    from repro_torch.kernels.page_copy import page_gather, page_scatter
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.routing import PULL
    from repro_torch.serving import EngineConfig
    counts = {}

    def ready(router):
        counts["c"] = CopyCounts([e.backend for lb in router.lbs.values()
                                  for e in lb.engines.values()])
        page_gather.launches = page_scatter.launches = 0   # router path
        paged_decode.launches = 0                          # starts

    router, rid1, rid2, prompt, moved = pull_scenario(
        cfg, params, DEVICE, EngineConfig(page_size=16, n_pages=1024,
                                          max_batch=8, max_seq_len=2048),
        384, seed=6, on_ready=ready)
    launches = (page_gather.launches, page_scatter.launches,
                paged_decode.launches)                # router path ends
    expect = (counts["c"].gathers, counts["c"].scatters)
    us_lb = router.lbs["us"]
    us, eu = us_lb.engines["us-r0"], router.lbs["eu"].engines["eu-r0"]
    res = router.results()
    check_results("router", [res[rid1], res[rid2]], cfg.vocab)
    if not us_lb.core.kv_decisions[PULL] >= 1:
        fail(f"router: no PULL decision ({dict(us_lb.core.kv_decisions)})")
    if not res[rid2].cached_tokens > 0:
        fail("router: the pulled request hit no cache")
    if "export" not in moved or "import_n" not in moved:
        fail(f"router: nothing moved between regions ({sorted(moved)})")
    n_exp, k_exp, v_exp = moved["export"]
    n_in, k_in, v_in = us.export_prefix(prompt[:moved["import_n"]])
    if not (n_in == moved["import_n"] <= n_exp
            and same_bits(k_in, k_exp[:k_in.shape[0]])
            and same_bits(v_in, v_exp[:v_in.shape[0]])):
        fail("router: the pages imported in us differ from those exported "
             "by eu")
    if launches[:2] != expect or not min(launches[:2]) > 0:
        fail(f"router: page_gather / page_scatter launched {launches[:2]} "
             f"times; non-empty flushes + exports and finishes + imports "
             f"were {expect}")
    print(f"router: PULL decisions {us_lb.core.kv_decisions[PULL]}, pulled "
          f"{us_lb.core.pulled_tokens} tokens ({k_exp.shape[0]} pages "
          f"exported, {n_in} tokens imported, equal bit for bit); the "
          f"replay's cached tokens {res[rid2].cached_tokens}; launches "
          f"page_gather {launches[0]}, page_scatter {launches[1]}, "
          f"paged_decode {launches[2]}", flush=True)
    return launches, (eu, us, prompt[:n_in])


def pull_ms_per_mb(eu, us, prefix) -> tuple:
    """One export from eu and import into us of the pulled prefix's pages,
    the bytes crossing the host as on the WAN: median seconds of three
    after one warm-up, and the MB of K+V moved. The pages land where us
    already caches that prefix, whose bytes the router phase found equal
    to eu's, so us's cache does not change."""
    import torch
    _, src = eu.core.radix.match(prefix)
    _, dst = us.core.radix.match(prefix)
    if not len(src) == len(dst) > 0:
        fail(f"pull timing: eu caches {len(src)} pages of the pulled "
             f"prefix, us {len(dst)}")
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks, vs = eu.backend.export_pages(src)
        us.backend.import_pages(dst, ks, vs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (statistics.median(times[1:]), len(src),
            2 * ks.numel() * ks.element_size() / 1e6)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are not at {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.page_copy import page_gather, page_scatter
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.models import init_params, param_count
    from repro_torch.routing import PULL
    from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                     SamplingParams)

    # fp32 products in full fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:     # one nvcc per source
        built = list(ex.map(build.compile_library, KERNELS))
    for name, (lib_path, nvcc_s) in zip(KERNELS, built):
        print(f"build: {name}.cu -> {lib_path.name} (nvcc {nvcc_s:.2f} s)",
              flush=True)
    print(f"build: {len(KERNELS)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel against its plain version at Llama-3.1-8B decode shapes
    lens = [1, 16, 17, 32, 100, 1000, 2048, 3001]
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, table, ln = kernel_inputs(dtype, lens, seed=1)
        got = paged_decode(q, kp, vp, table, ln)
        torch.cuda.synchronize()
        want = ref.paged_decode_ref(q, kp, vp, table, ln)
        err = check_close(f"paged_decode {dtype}", got, want)
        row = check_rows(f"paged_decode {dtype}", got, q, kp, vp, table, ln)
        print(f"kernel check: paged_decode {str(dtype)[6:]} lens={lens} "
              f"max|err|={err:.3e} (tol {TOL[str(dtype)]}); against fp32 "
              f"per row {row:.3e} (tol {ROW_RTOL[str(dtype)]})", flush=True)

    copy_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        copy_err = max(copy_err,
                       check_page_copies(dtype, page_gather, page_scatter))
        torch.cuda.empty_cache()
        print(f"kernel check: page_gather / page_scatter {str(dtype)[6:]} "
              f"pools {POOL}, N in (1, 5, 16, 100): bit-exact against the "
              f"plain versions (tolerance 0), pages outside the ids "
              f"untouched, gather then scatter restores the pool",
              flush=True)

    # ---- 4. the engine at full width: Llama-3.1-8B, random bf16 weights
    cfg = get_config(MODEL)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.bfloat16, DEVICE,
                         torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"weights: {cfg.name} {n_params / 1e9:.3f} B params bf16 "
          f"({n_params * 2 / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ecfg = EngineConfig(page_size=16, n_pages=1024, max_batch=8,
                        max_seq_len=2048)
    eng = Engine(cfg, params, ecfg, seed=0, device=DEVICE)
    rng = np.random.default_rng(0)

    # warm-up: one short request of its own tokens (cuBLAS handles, the
    # kernel library) before anything is counted or timed
    eng.generate([GenRequest(prompt_tokens=tuple(
        rng.integers(0, cfg.vocab, size=40).tolist()),
        sampling=SamplingParams(max_new_tokens=4))])

    # time every prefill round and decode step (each ends in its host sync)
    be = eng.backend
    prefill_s, decode_s, decode_tokens = [], [], [0]
    orig_prefill, orig_decode = be.prefill_batch, be.decode

    def timed_prefill(items):
        t = time.perf_counter()
        out = orig_prefill(items)
        prefill_s.append(time.perf_counter() - t)
        return out

    def timed_decode(seqs):
        t = time.perf_counter()
        out = orig_decode(seqs)
        decode_s.append(time.perf_counter() - t)
        decode_tokens[0] += len(out)
        return out

    # capture one decode step's layer-0 attention inputs on the main path
    captured = {}
    orig_ops = ops.paged_decode

    def capturing(q, k_pages, v_pages, table, seq_lens):
        out = orig_ops(q, k_pages, v_pages, table, seq_lens)
        if len(decode_s) == 10 and not captured:
            captured.update(q=q.clone(), k=k_pages.clone(), v=v_pages.clone(),
                            table=table.clone(), lens=seq_lens.clone(),
                            out=out.clone())
        return out

    be.prefill_batch, be.decode = timed_prefill, timed_decode
    ops.paged_decode = capturing
    prefill_before = eng.prefill_tokens - eng.cached_tokens
    paged_decode.launches = 0                          # main path starts
    turn1 = session_requests(GenRequest, SamplingParams, cfg.vocab, rng)
    res1 = eng.generate(turn1)
    turn2 = [GenRequest(prompt_tokens=r.prompt_tokens + o.output_tokens + tuple(
        rng.integers(0, cfg.vocab, size=24).tolist()),
        sampling=r.sampling) for r, o in zip(turn1, res1)]
    res2 = eng.generate(turn2)
    launches = paged_decode.launches                   # main path ends
    ops.paged_decode = orig_ops
    be.prefill_batch, be.decode = orig_prefill, orig_decode
    prefilled = eng.prefill_tokens - eng.cached_tokens - prefill_before

    check_results("engine", res1 + res2, cfg.vocab)
    if not all(r.cached_tokens > 0 for r in res2):
        fail(f"follow-up turns hit no cache: "
             f"{[r.cached_tokens for r in res2]}")
    want_launches = cfg.n_layers * len(decode_s)
    if launches != want_launches:
        fail(f"paged_decode launched {launches} times on the main path; "
             f"expected n_layers x decode steps = {want_launches}")
    if not captured:
        fail("no decode step was captured")
    c = captured
    want = ref.paged_decode_ref(c["q"], c["k"], c["v"], c["table"], c["lens"])
    main_err = check_close("paged_decode on a captured decode step",
                           c["out"], want)
    main_row = check_rows("paged_decode on a captured decode step", c["out"],
                          c["q"], c["k"], c["v"], c["table"], c["lens"])
    print(f"engine: {len(res1) + len(res2)} requests, "
          f"{sum(len(r.output_tokens) for r in res1 + res2)} tokens out, "
          f"cached tokens on follow-ups {[r.cached_tokens for r in res2]}, "
          f"{len(decode_s)} decode steps, paged_decode launches {launches} "
          f"= {cfg.n_layers} x {len(decode_s)}; captured step "
          f"max|err|={main_err:.3e}, against fp32 per row {main_row:.3e}",
          flush=True)

    # ---- 4b / 4c. the host KV tier and the router at full width
    host_launches = host_tier_phase(cfg, params)
    router_launches, pull = router_phase(cfg, params)

    # ---- 5. the engine's tokens against its plain CPU path (small, fp32)
    small = get_config("llama31-8b-reduced")
    cpu_params = init_params(small, torch.float32, "cpu",
                             torch.Generator().manual_seed(0))
    gpu_params = _to(cpu_params, DEVICE)
    specs = [(12, dict(max_new_tokens=6)),
             (23, dict(max_new_tokens=5, temperature=0.7, top_k=3, seed=1)),
             (9, dict(max_new_tokens=7, temperature=1.1)),
             (31, dict(max_new_tokens=4))]
    streams = []
    for dev, p in ((DEVICE, gpu_params), ("cpu", cpu_params)):
        r = np.random.default_rng(3)
        reqs = [GenRequest(prompt_tokens=tuple(
            r.integers(0, small.vocab, size=n).tolist()),
            sampling=SamplingParams(**kw)) for n, kw in specs]
        e = Engine(small, p, EngineConfig(page_size=8, n_pages=64,
                                          max_batch=4, max_seq_len=256,
                                          prefill_pad=16), device=dev)
        streams.append([o.output_tokens for o in e.generate(reqs)])
    if streams[0] != streams[1]:
        fail(f"small fp32 engine: card tokens {streams[0]} != plain CPU "
             f"path {streams[1]}")
    print(f"reference: small fp32 engine tokens on the card equal the plain "
          f"CPU path ({sum(map(len, streams[0]))} tokens)", flush=True)
    host_runs = []
    for dev, p in ((DEVICE, gpu_params), ("cpu", cpu_params)):
        e = Engine(small, p, EngineConfig(
            page_size=8, n_pages=23, max_batch=3, max_seq_len=256,
            prefill_pad=16, host_pages=64), device=dev)
        out = host_tier_sessions(e, GenRequest, SamplingParams, system=40,
                                 turn=32, follow=16, max_new=8, seed=9)
        host_runs.append(([o.output_tokens for o in out],
                          e.core.host_hit_tokens, e.backend.demoted_pages,
                          e.backend.loaded_pages))
    if host_runs[0] != host_runs[1]:
        fail(f"small fp32 engine with the host tier: card (tokens, host "
             f"hits, demoted, loaded) {host_runs[0][1:]} != plain CPU path "
             f"{host_runs[1][1:]} or the tokens differ")
    if not host_runs[0][1] > 0:
        fail("small fp32 engine with the host tier: no host hit")
    pulls = []
    for dev, p in ((DEVICE, gpu_params), ("cpu", cpu_params)):
        rt, r1, r2, _, _ = pull_scenario(
            small, p, dev, EngineConfig(page_size=8, n_pages=64, max_batch=2,
                                        max_seq_len=128, prefill_pad=16),
            48, seed=5)
        res = rt.results()
        pulls.append((res[r1].output_tokens, res[r2].output_tokens,
                      res[r2].cached_tokens,
                      dict(rt.lbs["us"].core.kv_decisions)))
    if pulls[0] != pulls[1]:
        fail(f"small fp32 router pull: card {pulls[0]} != plain CPU path "
             f"{pulls[1]}")
    if not (pulls[0][3].get(PULL) == 1 and pulls[0][2] > 0):
        fail(f"small fp32 router pull: no pull ({pulls[0][2:]})")
    print(f"reference: with the host tier on (host hits {host_runs[0][1]}, "
          f"{host_runs[0][2]} pages demoted, {host_runs[0][3]} loaded) and "
          f"through one router pull (cached {pulls[0][2]}), the card's "
          f"tokens equal the plain CPU path's", flush=True)

    # ---- 6. measurements
    dec_tok_s = decode_tokens[0] / sum(decode_s)
    pre_tok_s = prefilled / sum(prefill_s)
    step_ms = 1e3 * statistics.median(decode_s)
    q, kp, vp, table, ln = (c["q"], c["k"], c["v"], c["table"], c["lens"])
    k_ms = cuda_ms(lambda: paged_decode(q, kp, vp, table, ln))
    p_ms = cuda_ms(lambda: ref.paged_decode_ref(q, kp, vp, table, ln))
    b_ms, b_by = paged_bound(q, kp, table, ln)
    print(f"[{card}] engine {cfg.name} bf16 page=16 max_batch=8: prefill "
          f"{pre_tok_s:.1f} tok/s ({prefilled} uncached tokens in "
          f"{len(prefill_s)} rounds), decode {dec_tok_s:.1f} tok/s, median "
          f"decode step {step_ms:.2f} ms", flush=True)
    print(f"[{card}] paged_decode at the captured step (B={q.shape[0]}, "
          f"lens={ln.tolist()}): kernel {k_ms * 1e3:.1f} us, plain "
          f"{p_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}), "
          f"{launches // len(decode_s)} launches per decode step", flush=True)
    big = kernel_inputs(torch.bfloat16, lens, seed=2)
    kb_ms = cuda_ms(lambda: paged_decode(*big))
    pb_ms = cuda_ms(lambda: ref.paged_decode_ref(*big), iters=10)
    bb_ms, _ = paged_bound(big[0], big[1], big[3], big[4])
    print(f"[{card}] paged_decode bf16 lens={lens}: kernel "
          f"{kb_ms * 1e3:.1f} us, plain {pb_ms * 1e3:.1f} us, bound "
          f"{bb_ms * 1e3:.2f} us", flush=True)
    decode_profile(eng, card, GenRequest, SamplingParams, rng)

    # the page copies: kernel, plain, library and bound at N = 16 and 100
    # pages of the full-width bf16 pools
    copy_t = time_page_copies(page_gather, page_scatter)
    for n, t in copy_t.items():
        for name in ("gather", "scatter"):
            r = t[name]
            (k, how), (pl, _), (lib, _) = r["kernel"], r["plain"], r["library"]
            print(f"[{card}] page_{name} bf16 N={n} pools {POOL}: kernel "
                  f"{k * 1e3:.1f} us ({how}; CUDA events over back-to-back "
                  f"wrapper calls {r['events'] * 1e3:.1f} us), plain "
                  f"{pl * 1e3:.1f} us, library {lib * 1e3:.1f} us, bound "
                  f"{t['bound'] * 1e3:.1f} us (bytes; roofline share "
                  f"{100 * t['bound'] / k:.1f}%)", flush=True)
    rates = host_tier_rates(cfg, params)
    gb = rates["bytes"] / 1e9
    print(f"[{card}] host tier, 100 full-width pages ({gb:.3f} GB of K+V): "
          f"demotion flush {1e3 * rates['flush']:.2f} ms = "
          f"{gb / rates['flush']:.2f} GB/s (page_gather + D2H + host "
          f"mirror), its D2H alone {gb / rates['d2h']:.2f} GB/s; load-back "
          f"{1e3 * rates['load']:.2f} ms = {gb / rates['load']:.2f} GB/s "
          f"until the H2D lands (pinned staging + side-stream H2D), its "
          f"H2D alone {gb / rates['h2d']:.2f} GB/s; finish (page_scatter) "
          f"{1e3 * rates['finish']:.2f} ms",
          flush=True)
    pull_t, pull_pages, pull_mb = pull_ms_per_mb(*pull)
    print(f"[{card}] cross-region pull, export + import of {pull_pages} "
          f"full-width pages ({pull_mb:.1f} MB of K+V through the host): "
          f"{1e3 * pull_t:.2f} ms = {1e3 * pull_t / pull_mb:.3f} ms/MB",
          flush=True)

    copy_launches = {"gather": host_launches[0] + router_launches[0],
                     "scatter": host_launches[1] + router_launches[1]}
    rows = [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:122",
        "launches": launches, "max_abs_err": main_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]
    for name, line in (("gather", 52), ("scatter", 86)):
        r = copy_t[16][name]
        k, pl, lib = r["kernel"][0], r["plain"][0], r["library"][0]
        rows.append({
            "name": f"page_{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/page_copy.cu",
            "replaces": f"src/repro/kernels/page_copy.py:{line}",
            "launches": copy_launches[name], "max_abs_err": copy_err,
            "ms": k, "plain_ms": pl, "bound_ms": copy_t[16]["bound"],
            "bound_by": "bytes", "library_ms": lib,
            "shape": f"N=16 pages of bf16 pools {list(POOL)}"})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def decode_profile(eng, card, GenRequest, SamplingParams, rng) -> None:
    """Where a steady decode step's time goes, at a full batch (8
    sequences): the wall time of four steps, then torch.profiler (device
    activity only) over the next four. Prints the device's busy time per
    step against the unprofiled wall and the top kernels' time per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    vocab = eng.cfg.vocab
    for _ in range(8):
        eng.submit(GenRequest(prompt_tokens=tuple(
            rng.integers(0, vocab, size=200).tolist()),
            sampling=SamplingParams(max_new_tokens=16)))
    eng.step()                              # admit + prefill
    eng.step()                              # first decode: uploads state
    steps = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run_until_idle()
    events = device_events(prof)
    busy = sum(dev_us(e) for e in events) / 1e6 / steps      # s per step
    print(f"[{card}] decode profile, batch 8: wall {1e3 * wall:.2f} ms/step "
          f"(unprofiled), device busy "
          + (f"{1e3 * busy:.2f} ms/step = {100 * busy / wall:.1f}% of the "
             f"wall" if busy else
             "not measured (the profiler saw no device time)"), flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"[{card}]   {dev_us(e) / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d}/step  {e.key[:80]}", flush=True)


def _to(tree: dict, device: str) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
