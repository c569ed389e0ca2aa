#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, all started together) and print the build seconds, and
     `nvcc -Xptxas -v`'s registers, spills and stack of each kernel of
     `flash_attention.cu`, `paged_verify.cu`, `paged_decode.cu` and
     `ssd_scan.cu`;
  3. hold each kernel against its plain PyTorch version on the card:
     paged_decode at Llama-3.1-8B decode shapes, ragged lengths and garbage
     block tables: lens from 1 to 3001 (B=8), lens at its split plan's
     edges (a split boundary +-1 at B=8 and, on a table as wide, at B=1)
     and one sequence over the whole pool (NPG 1024), each with the plan
     printed; paged_verify at Llama-3.1-8B verify shapes (Q=4) on a
     layer of the full-width pool, with garbage tables: lens from Q to 3001
     across page edges (B=8), lens at its split plan's edges (len = Q, a
     split boundary +-1, last splits that hold candidates only, so some
     rows' partials are fully masked), one sequence over the whole pool
     (NPG 1024), and at Q=1 against the paged_decode kernel;
     page_gather / page_scatter at the full-width
     Llama-3.1-8B pool (32 x 1024 x 16 x 8 x 128), bf16 and fp32, bit for
     bit, with untouched pages and a gather/scatter round trip checked;
     flash_attention (Llama-3.1-8B attention widths, causal and full, S = T
     and S != T, S and T that are no multiple of 64, bf16 and fp32) and
     ssd_scan (Mamba2-780m widths, B=2,
     S=2048, chunks 256 and 128, the test sweeps and chunk invariance)
     through their entry points `ops.flash_attention` / `ops.ssd_scan`,
     with their launches counted;
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
  4d. speculation at full width (spec_k=3) on phase 4's requests, with the
     target as its own drafter and with a random 2-layer drafter: every
     request's exact budget, paged_verify launched n_layers x spec
     dispatches and paged_decode drafter layers x (k+1) x spec dispatches;
     with the target as drafter, more than one token per sequence-step;
     acceptance and agreement with phase 4's streams are printed;
  4e. the MoE FFN at full width on granite-moe-1b-a400m (24 layers, d
     1024, 16/8 heads, hd 64, 32 experts, top-8; random bf16 weights):
     paged_decode and paged_verify against their plain versions at its
     attention widths (ragged lens, split edges, the whole pool) and the
     page copies bit for bit on its pool; phase 4's sessions twice through
     `Engine(device=None)` with identical tokens, exact budgets, cached
     follow-ups and paged_decode = layers x decode steps; the host tier;
     speculation with the target as its own drafter; a small fp32 MoE
     engine that drops tokens past capacity at prefill gives the CPU
     path's tokens, plain and speculative; `repro_torch.launch.serve`'s
     `serve_single` and `serve_multiregion` answer 24 requests with a hit
     rate > 0; prints the plain decode step at batch 8 (wall, tok/s,
     device busy, device ms of the expert products, the dispatch,
     paged_decode and the rest) and the four paged kernels' times at
     these widths, which the kernels line carries under "moe";
  5. check the engine's tokens against its plain CPU path on a small
     fp32 model: plain serving, the host tier, one router pull, and
     speculation (both drafters) against the plain non-speculative tokens;
  6. print measurements (engine throughput, each kernel's time beside its
     bound, its plain version's and its library call's time (for
     flash_attention, scaled_dot_product_attention), profiles of
     steady plain and speculative decode steps at batch 8, the host
     tier's D2H / H2D rates and a pull's time per MB, the split plans of
     paged_decode and paged_verify, their split and combine kernels apart,
     per call and per step, and ssd_scan's four passes apart beside its
     bounds at the 3xTF32 tensor-core peak, its products' form, and for
     reference the fp32 FMA peak) with the card's
     name and power limit,
     the kernel table as one JSON line, and last the result line
     {"ok": true, "device": {...}}.

Exits 2 without printing a result when CUDA is unavailable or when the
port's sources are not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

DEVICE = "cuda"
MODEL = "llama31-8b"               # the paper's serving model, full width
SMALL = "llama31-8b-reduced"       # the fp32 model of the CPU token check
KERNELS = ("paged_decode", "paged_verify", "page_copy", "flash_attention",
           "ssd_scan")                                 # csrc/<name>.cu
PTXAS = ("flash_attention", "paged_verify", "paged_decode",
         "ssd_scan")                   # sources whose -Xptxas -v report is
                                       # printed
SPEC_K = 3                         # drafts per speculative step
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# ssd_scan's fp32 work: first the peak of the form the kernel runs its
# products in, 3xTF32 on the tensor cores (three TF32 products for one),
# which is its bound; second, printed for reference only, the fp32 peak
# outside the tensor cores (the card's rate for the type)
SSD_PEAKS = (("3xTF32 tensor-core", 495e12 / 3),
             ("fp32 FMA", PEAK_FLOPS["torch.float32"]))
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 2e-5}
# per (sequence, head) row against the plain version in fp32: two bf16
# ulps at the row's largest value; fp32 summation order alone for fp32
ROW_RTOL = {"torch.bfloat16": 8e-3, "torch.float32": 1e-4}
SSD_ATOL, SSD_RTOL = 5e-5, 5e-4    # tests/test_kernels.py:221
ATTN = "llama31-8b"                # flash_attention's full widths
SSM = "mamba2-780m"                # ssd_scan's full widths
POOL = (32, 1024, 16, 8, 128)      # Llama-3.1-8B pool: L, P, page, K, hd
MOE = "granite-moe-1b-a400m"       # phase 4e's MoE model, full width
MOE_SMALL = "granite-moe-1b-a400m-reduced"   # its fp32 CPU token check


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


def ptxas_report(name: str) -> list[str]:
    """`nvcc -Xptxas -v`'s report (registers, spills, stack and shared
    memory of each kernel) on `csrc/<name>.cu` for the library's target, as
    ptxas prints it (a cubin in the git-ignored build directory, not
    kept)."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = build.BUILD_DIR / f"{name}.ptxas.cubin"
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         str(cubin), str(build.CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    cubin.unlink(missing_ok=True)
    if proc.returncode != 0:
        fail(f"nvcc -Xptxas -v failed on {name}.cu:\n{proc.stderr}")
    return [line for line in proc.stderr.splitlines() if line.strip()]


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
    gaps included, when three profiles in a row see no device time.
    Returns (ms, "profiler" | "events"); `timing` carries the second into
    the kernels line."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(dev_us(e) for e in device_events(prof))
        if us:
            return us / 1e3 / iters, "profiler"
    return cuda_ms(fn, iters, warmup=0), "events"


def timing(**readings: tuple[float, str]) -> dict:
    """A kernels-line row's times from `device_ms` readings, keyed as the
    row keys them (ms, plain_ms, library_ms), and under "timed_by" how
    each was taken, so an events reading (host gaps included) is not read
    as device time."""
    out = {key: ms for key, (ms, _) in readings.items()}
    out["timed_by"] = {key: how for key, (_, how) in readings.items()}
    return out


def kernel_parts(fn, iters: int = 10) -> dict:
    """Device ms per call of each kernel fn launches (torch.profiler),
    keyed by the kernel's name without its namespace and arguments."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in device_events(prof):
        m = re.search(r"(\w+)(<[^>]*>)?\(", e.key)
        parts[m.group(1) if m else e.key] = dev_us(e) / 1e3 / iters
    return parts


def roofline(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    """The least time of a call, in ms: the larger of its bytes over the HBM
    rate and its flops over `peak`, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want, atol=None, rtol=None) -> float:
    """got against want at atol and rtol, by default both TOL of got's
    dtype; fails the run beyond them or on a non-finite value."""
    import torch
    atol = TOL[str(got.dtype)] if atol is None else atol
    rtol = TOL[str(got.dtype)] if rtol is None else rtol
    err = max_abs_err(got, want)
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        fail(f"{name}: max |err| {err:.3e} beyond atol={atol} rtol={rtol}")
    return err


def check_rows(name: str, got, q, k_pages, v_pages, table, lens,
               plain=None) -> float:
    """Hold each (sequence, [query,] head) row of a paged attention output
    against the plain version (`paged_decode_ref` unless `plain` is given)
    run in fp32 on the same inputs, upcast: the row's max error over the
    row's max |value|. A long context's outputs are small, so a fixed
    absolute tolerance barely binds there; this bound holds every row as
    tightly as the output's own rounding allows."""
    from repro_torch.kernels import ref
    want = (plain or ref.paged_decode_ref)(
        q.float(), k_pages.float(), v_pages.float(), table, lens)
    worst, at = worst_row(got, want)
    tol = ROW_RTOL[str(got.dtype)]
    if not worst <= tol:
        fail(f"{name}: row {at} (seq, [query,] head; len "
             f"{int(lens[at[0]])}) max |err| / max |want| = {worst:.3e} "
             f"beyond {tol} against the fp32 plain version")
    return worst


def worst_row(got, want) -> tuple[float, tuple]:
    """The largest over rows (the last axis) of a row's max |got - want|
    over the row's max |want|, and the index of that row."""
    import numpy as np
    row_err = ((got.float() - want).abs().amax(-1)
               / want.abs().amax(-1).clamp_min(1e-30))
    at = np.unravel_index(int(row_err.argmax()), tuple(row_err.shape))
    return float(row_err.max()), tuple(int(i) for i in at)


def check_flash_rows(name: str, got, q, k, v, causal: bool) -> float:
    """Hold each (batch, head, query) row of a flash attention output against
    `flash_attention_ref` run in fp32 on the same inputs, upcast, at
    ROW_RTOL of the row's max |value|, as `check_rows` does for the paged
    kernels: the bf16 plain version rounds its logits to bf16, so `got`
    against it alone leaves room for a bf16-only fault."""
    from repro_torch.kernels import ref
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal)
    worst, at = worst_row(got, want)
    tol = ROW_RTOL[str(got.dtype)]
    if not worst <= tol:
        fail(f"{name}: row {at} (batch, head, query) max |err| / max |want| "
             f"= {worst:.3e} beyond {tol} against the fp32 plain version")
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
    return roofline(nbytes, flops, PEAK_FLOPS[str(q.dtype)])


def kernel_inputs(dtype, lens, seed: int, Q=None, npg=None, pool=None,
                  H: int = 32):
    """Attention shapes of `pool` (L, P, page, K, hd) with H query heads,
    by default Llama-3.1-8B's: H=32, K=8, hd=128, page=16, with every
    table entry past a sequence's ragged edge set to garbage (-1 or
    2**31-1). Decode (Q None): q (B, H, hd) over a pool just large enough;
    verify: q (B, Q, H, hd) over one layer of the full-width pool, lens
    counting the Q candidates. The table is `npg` entries wide, by default
    the longest sequence's live pages."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, (_, P, page, K, hd) = len(lens), pool or POOL
    npg = npg or max(-(-n // page) for n in lens)
    n_pages = (sum(-(-n // page) for n in lens) + 8 if Q is None else P)
    q = torch.randn((B, H, hd) if Q is None else (B, Q, H, hd),
                    generator=g, device=DEVICE).to(dtype)
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


def paged_checks(pool, H: int) -> tuple[list, list]:
    """paged_decode and paged_verify against their plain versions at the
    attention widths of `pool` (L, P, page, K, hd) with H query heads, bf16
    and fp32, over garbage tables: decode at ragged lens up to 3001, at its
    split plan's edges and over the whole pool; verify (Q = SPEC_K + 1) at
    ragged lens, at Q=1 against the decode kernel, at its split plan's
    edges (some partials fully masked) and over the whole pool. Returns
    the decode and verify lens of the ragged checks."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_verify import paged_verify
    page = pool[2]
    widths = f"H={H} K={pool[3]} hd={pool[4]}"
    lens = [1, 16, 17, 32, 100, 1000, 2048, 3001]
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, table, ln = kernel_inputs(dtype, lens, seed=1, pool=pool,
                                             H=H)
        got = paged_decode(q, kp, vp, table, ln)
        torch.cuda.synchronize()
        want = ref.paged_decode_ref(q, kp, vp, table, ln)
        err = check_close(f"paged_decode {dtype} {widths}", got, want)
        row = check_rows(f"paged_decode {dtype} {widths}", got, q, kp, vp,
                         table, ln)
        print(f"kernel check: paged_decode {str(dtype)[6:]} {widths} "
              f"lens={lens} max|err|={err:.3e} (tol {TOL[str(dtype)]}); against fp32 "
              f"per row {row:.3e} (tol {ROW_RTOL[str(dtype)]})", flush=True)
        del q, kp, vp
        for label, lens_set, npg in decode_split_lens(dtype, pool):
            name = f"paged_decode {str(dtype)[6:]} {widths} {label}"
            args = kernel_inputs(dtype, lens_set, seed=8, npg=npg,
                                 Q=1 if npg == pool[1] else None, pool=pool,
                                 H=H)
            if npg == pool[1]:             # one layer of the full pool
                args = (args[0][:, 0].contiguous(), *args[1:])
            got = paged_decode(*args)
            torch.cuda.synchronize()
            err = check_close(name, got, ref.paged_decode_ref(*args))
            row = check_rows(name, got, *args)
            plan = split_note(args[0], args[1], args[3], args[4])[0]
            print(f"kernel check: {name} lens={lens_set}, NPG {npg}, garbage "
                  f"tables: {plan}: max|err|={err:.3e} (tol "
                  f"{TOL[str(dtype)]}); against "
                  f"fp32 per row {row:.3e} (tol {ROW_RTOL[str(dtype)]})",
                  flush=True)
            del args, got
        torch.cuda.empty_cache()

    v_lens = [SPEC_K + 1, 16, 17, 32, 33, 100, 1000, 3001]
    for dtype in (torch.bfloat16, torch.float32):
        name = f"paged_verify {str(dtype)[6:]} {widths}"
        args = kernel_inputs(dtype, v_lens, seed=3, Q=SPEC_K + 1, pool=pool,
                             H=H)
        got = paged_verify(*args)
        torch.cuda.synchronize()
        err = check_close(name, got, ref.paged_verify_ref(*args))
        row = check_rows(name, got, *args, plain=ref.paged_verify_ref)
        # Q=1 is a decode step: the verify kernel against the decode kernel
        q1, kp, vp, table, ln = kernel_inputs(dtype, v_lens, seed=4, Q=1,
                                              pool=pool, H=H)
        one = paged_verify(q1, kp, vp, table, ln)[:, 0]
        dec = paged_decode(q1[:, 0].contiguous(), kp, vp, table, ln)
        torch.cuda.synchronize()
        q1_err = check_close(f"{name} at Q=1 against paged_decode", one, dec)
        print(f"kernel check: {name} B=8 Q={SPEC_K + 1} page={page}, "
              f"pool {pool[1:]}, lens={v_lens}, garbage tables: "
              f"max|err|={err:.3e} (tol {TOL[str(dtype)]}); against fp32 "
              f"per row {row:.3e} (tol {ROW_RTOL[str(dtype)]}); at Q=1 "
              f"against the paged_decode kernel max|err|={q1_err:.3e}"
              f"{' (bit-identical)' if same_bits(one, dec) else ''}",
              flush=True)
        del args, q1, kp, vp
        for label, lens_set in verify_split_lens(dtype, pool):
            args = kernel_inputs(dtype, lens_set, seed=7, Q=SPEC_K + 1,
                                 pool=pool, H=H)
            got = paged_verify(*args)
            torch.cuda.synchronize()
            err = check_close(f"{name} {label}", got,
                              ref.paged_verify_ref(*args))
            row = check_rows(f"{name} {label}", got, *args,
                             plain=ref.paged_verify_ref)
            plan, masked = split_note(args[0], args[1], args[3], args[4])
            if label == "split edges" and not masked:
                fail(f"{name} {label}: lens {lens_set} leave no fully "
                     f"masked partial under the plan {plan}")
            print(f"kernel check: {name} {label} B={len(lens_set)} "
                  f"lens={lens_set if len(lens_set) < 10 else '...'}, "
                  f"garbage tables: {plan}, {masked} fully masked "
                  f"(sequence, split, candidate) partials: max|err|="
                  f"{err:.3e} (tol {TOL[str(dtype)]}); "
                  f"against fp32 per row {row:.3e} (tol "
                  f"{ROW_RTOL[str(dtype)]})", flush=True)
            del args, got
        torch.cuda.empty_cache()
    return lens, v_lens


def verify_bound(q, k_pages, table, lens) -> tuple[float, str]:
    """Least time for one paged verify call: the bytes it must move (each
    live K/V row once, q, the live table entries, lens and the output) over
    the HBM rate, against its flops (QK and PV of each query over the
    positions it attends, len - Q + qi + 1) over the peak of its dtype.
    Returns (ms, "bytes" | "operations")."""
    B, Q, H, hd = q.shape
    _, page, K, _ = k_pages.shape
    it = q.element_size()
    horizon = table.shape[1] * page
    ln = [min(int(n), horizon) for n in lens.tolist()]
    n_tok = sum(ln)
    n_pages = sum(-(-n // page) for n in ln)
    attended = sum(min(int(n) - Q + qi + 1, horizon)
                   for n in lens.tolist() for qi in range(Q))
    nbytes = (2 * n_tok * K * hd * it + 2 * B * Q * H * hd * it
              + 4 * n_pages + 4 * B)
    flops = 4 * attended * H * hd
    return roofline(nbytes, flops, PEAK_FLOPS[str(q.dtype)])


def split_note(q, k_pages, table, lens) -> tuple[str, int]:
    """The split plan of the paged kernel these inputs go to (decode for q
    (B, H, hd), verify for q (B, Q, H, hd)), as text with the blocks it
    launches and those that find live pages, and how many (sequence,
    split, candidate) partials hold no position the candidate sees (fully
    masked: the combine's weight-0 case; none at Q = 1)."""
    from repro_torch.kernels import paged_decode, paged_verify
    kern = paged_decode if q.dim() == 3 else paged_verify
    B, (H, hd) = q.shape[0], q.shape[-2:]
    Q = 1 if q.dim() == 3 else q.shape[1]
    _, page, K, _ = k_pages.shape
    npg = table.shape[1]
    ppr, chunk, n_split = kern.split_plan(B, K, npg, page, hd,
                                          q.element_size(),
                                          paged_decode.sm_count(q.device))
    live = masked = 0
    for n in lens.tolist():
        ranges = paged_decode.split_ranges(n, page, npg, chunk, n_split)
        live += len(ranges)
        masked += sum(p0 * page >= n - Q + qi + 1 for p0, _ in ranges
                      for qi in range(Q))
    return (f"split plan {ppr} pages per round, {chunk} per split, "
            f"n_split={n_split}: {B * K * n_split} blocks per launch, "
            f"{live * K} with live pages"), masked


def verify_split_lens(dtype, pool=None) -> list[tuple[str, list[int]]]:
    """Lens that reach paged_verify's split machinery at Q = SPEC_K + 1 on
    a layer of the full-width pool: at the edges of the plan that phase 3's
    shapes (B=8, NPG=188) get, E slots per split: len = Q, E - 1, E, E + 1
    and 2E + 1 (a last split of one candidate), E + 3 (of three) beside 3001
    (which sets NPG); and one sequence over every page of the pool (NPG
    1024)."""
    import torch
    from repro_torch.kernels.paged_decode import sm_count
    from repro_torch.kernels.paged_verify import split_plan
    pool = pool or POOL
    Q, page = SPEC_K + 1, pool[2]
    E = split_plan(8, pool[3], -(-3001 // page), page, pool[4],
                   torch.empty((), dtype=dtype).element_size(),
                   sm_count(torch.device(DEVICE, 0)))[1] * page
    return [("split edges", [Q, E - 1, E, E + 1, E + 2, E + 3, 2 * E + 1,
                             3001]),
            ("one sequence over the whole pool", [page * pool[1]])]


def decode_split_lens(dtype, pool=None) -> list[tuple[str, list[int], int]]:
    """(label, lens, table width) that reach paged_decode's split machinery
    at phase 3's shapes: B=8 with lens up to 3001 (NPG 188) at the edges of
    its plan, E slots per split: len = 1, E - 1, E, E + 1, 2E - 1, 2E,
    2E + 1 beside 3001; B=1 on a table 188 wide at its own plan's edges
    E1 - 1, E1, E1 + 1; and one sequence over every page of the full-width
    pool (NPG 1024)."""
    import torch
    from repro_torch.kernels.paged_decode import sm_count, split_plan
    pool = pool or POOL
    page, K, hd = pool[2], pool[3], pool[4]
    npg = -(-3001 // page)
    it = torch.empty((), dtype=dtype).element_size()
    sms = sm_count(torch.device(DEVICE, 0))
    E = split_plan(8, K, npg, page, hd, it, sms)[1] * page
    E1 = split_plan(1, K, npg, page, hd, it, sms)[1] * page
    return ([("split edges, B=8", [1, E - 1, E, E + 1, 2 * E - 1, 2 * E,
                                   2 * E + 1, 3001], npg)]
            + [("split edge, B=1", [n], npg) for n in (E1 - 1, E1, E1 + 1)]
            + [("one sequence over the whole pool", [page * pool[1]],
                pool[1])])


def flash_inputs(B, H, K, S, T, hd, dtype, seed: int):
    """q (B, H, S, hd) and k, v (B, K, T, hd), standard normal, on the
    card."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=DEVICE).to(dtype)
            for shape in ((B, H, S, hd), (B, K, T, hd), (B, K, T, hd))]


def flash_bound(q, k, causal: bool) -> tuple[float, str]:
    """Least time for one flash attention call: q, k, v read once and the
    output written once over the HBM rate, against 4 * hd flops (QK and PV)
    per (query, key) pair a head attends, over the peak of the dtype:
    causal row s attends min(s + 1, T) keys. Returns (ms, "bytes" |
    "operations")."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    nbytes = (2 * B * H * S + 2 * B * K * T) * hd * q.element_size()
    if not causal:
        pairs = S * T
    elif S <= T:
        pairs = S * (S + 1) // 2
    else:
        pairs = T * (T + 1) // 2 + (S - T) * T
    return roofline(nbytes, 4 * B * H * hd * pairs, PEAK_FLOPS[str(q.dtype)])


def ssd_inputs(B, H, S, P, G, N, seed: int, a_hi: float = 4.0):
    """x, dt, a, B_, C_ on the card, drawn as tests/test_kernels.py draws
    them: x, B_, C_ standard normal, dt ~ U(0.01, 0.2), a ~ -U(0.5, a_hi)."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=DEVICE)

    x = torch.randn((B, H, S, P), generator=g, device=DEVICE)
    dt = uniform((B, H, S), 0.01, 0.2)
    a = -uniform((H,), 0.5, a_hi)
    B_ = torch.randn((B, G, S, N), generator=g, device=DEVICE)
    C_ = torch.randn((B, G, S, N), generator=g, device=DEVICE)
    return x, dt, a, B_, C_


def check_ssd(name: str, got, want) -> float:
    return check_close(name, got, want, atol=SSD_ATOL, rtol=SSD_RTOL)


def ssd_bound(x, B_, chunk: int,
              peak: float = SSD_PEAKS[0][1]) -> tuple[float, str]:
    """Least time for one SSD scan call: every input read once and y
    written once (fp32) over the HBM rate, against the flops the scan
    itself needs, whatever the chunking, over `peak`: per (token, head)
    the state update dt x B^T and the readout C h, N x P multiply-adds
    each (4 N P flops), plus the state's decay once per chunk of `chunk`
    (N P per chunk and head). The intra-chunk products of the chunked form
    (C B^T and the masked M x) are overhead of that form and not counted.
    `peak` is that of the form the kernel runs its products in, 3xTF32,
    unless given (SSD_PEAKS). Returns (ms, "bytes" | "operations")."""
    Bb, H, S, P = x.shape
    G, N = B_.shape[1], B_.shape[3]
    nbytes = 4 * (2 * Bb * H * S * P + Bb * H * S + H + 2 * Bb * G * S * N)
    flops = Bb * H * N * P * (4 * S + S // chunk)
    return roofline(nbytes, flops, peak)


def ssd_chunked_flops(x, B_, chunk: int) -> float:
    """The flops the kernel's chunked form does (its four passes' products,
    as tiled): C B^T per (batch, group, chunk) on the tiles on or below
    the diagonal, each chunk's state (2 N P per token and head), the state
    passing (2 N P per chunk and head) and the output: the state's part (2
    N P per token and head, none in chunk 0) and the masked (C B^T o L) x
    on the tiles on or below the diagonal. The achieved rate is this over
    the kernel's time."""
    Bb, H, S, P = x.shape
    G, N = B_.shape[1], B_.shape[3]
    nc, nt = S // chunk, -(-chunk // 64)
    pairs = nt * (nt + 1) // 2                  # 64 x 64 tiles, J <= I
    tile = min(64, chunk) ** 2                  # elements of one tile
    cb = 2 * Bb * G * nc * pairs * tile * N
    state = 2 * Bb * H * S * N * P
    passing = 2 * Bb * H * nc * N * P
    out = 2 * Bb * H * (S - chunk) * N * P + 2 * Bb * H * nc * pairs * tile * P
    return float(cb + state + passing + out)


def dense_kernels_phase() -> dict:
    """flash_attention and ssd_scan through their entry points
    (`ops.flash_attention`, `ops.ssd_scan`) on the card, each output held
    against its plain version on the same inputs. flash_attention at
    Llama-3.1-8B's attention widths (H 32, K 8, hd 128): B=1, S=T=2048
    causal; B=2, S=T=384 causal and full; B=1, S=128, T=2048 full (a prefill
    extending a cached prefix); B=1, S=128, T=256 causal (the absolute
    mask); B=1, S=T=100 causal and full, and S=64, T=384 causal (rows and
    columns past S and T inside a 64-wide tile; T=192 lies outside the JAX
    kernel's domain, which the wrapper refuses); then tests/test_kernels.py's
    small shapes (hd 16, 32, 64), all in bf16 (2e-2) and fp32 (2e-5).
    ssd_scan at Mamba2-780m's widths (H 48, P 64, N 128, G 1), B=2,
    S=2048, at chunk 256 (its config) and 128 (the kernel's default), at
    its widths with a ~ -U(0.5, 12) so that the cumsum passes -88 inside a
    chunk, tests/test_kernels.py's three sweeps and its chunk
    invariance (chunks 16, 32, 48, 96 on one input, each against the plain
    scan and against chunk 16's output), at atol 5e-5 / rtol 5e-4. Counts
    the launches of this path. Returns the errors, the launches and the
    full-width inputs for phase 6."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    acfg, scfg = get_config(ATTN), get_config(SSM)
    H, K = acfg.n_heads, acfg.n_kv_heads
    hd = acfg.head_dim or acfg.d_model // acfg.n_heads
    ssm = scfg.ssm
    sH, P, N, G = (ssm.expand * scfg.d_model // ssm.head_dim, ssm.head_dim,
                   ssm.state, ssm.n_groups)
    full = [(1, H, K, 2048, 2048, hd, True), (2, H, K, 384, 384, hd, True),
            (2, H, K, 384, 384, hd, False), (1, H, K, 128, 2048, hd, False),
            (1, H, K, 128, 256, hd, True), (1, H, K, 100, 100, hd, True),
            (1, H, K, 100, 100, hd, False), (1, H, K, 64, 384, hd, True)]
    small = [(B, h, k, S, S, d, causal)
             for B, h, k, S, d in ((1, 4, 4, 128, 32), (2, 8, 2, 256, 32),
                                   (1, 4, 1, 128, 64), (1, 2, 2, 384, 16))
             for causal in (True, False)]
    out = {"flash_err": {}, "flash_row": {}, "ssd_err": {}}
    calls = {"flash": 0, "ssd": 0}
    flash_attention.launches = ssd_scan.launches = 0   # entry points start
    for dtype in (torch.bfloat16, torch.float32):
        worst = worst_rows = 0.0
        for i, (B, h, k, S, T, d, causal) in enumerate(full + small):
            q, kk, vv = flash_inputs(B, h, k, S, T, d, dtype, seed=20 + i)
            got = ops.flash_attention(q, kk, vv, causal=causal)
            calls["flash"] += 1
            torch.cuda.synchronize()
            name = (f"flash_attention {str(dtype)[6:]} B={B} H={h} K={k} "
                    f"S={S} T={T} hd={d} {'causal' if causal else 'full'}")
            err = check_close(name, got, ref.flash_attention_ref(
                q, kk, vv, causal=causal))
            row = check_flash_rows(name, got, q, kk, vv, causal)
            if i < len(full):
                print(f"kernel check: {name}: max|err|={err:.3e} (tol "
                      f"{TOL[str(dtype)]}), against fp32 per row "
                      f"{row:.3e} (tol {ROW_RTOL[str(dtype)]})", flush=True)
            if i == 0:
                out["flash_err"][str(dtype)] = err
            worst = max(worst, err)
            worst_rows = max(worst_rows, row)
            del q, kk, vv, got
        print(f"kernel check: flash_attention {str(dtype)[6:]} at "
              f"tests/test_kernels.py's {len(small)} small shapes (hd 16, "
              f"32, 64) and the {len(full)} above: worst max|err|="
              f"{worst:.3e} (tol {TOL[str(dtype)]}), against fp32 per row "
              f"{worst_rows:.3e} (tol {ROW_RTOL[str(dtype)]})", flush=True)
        out["flash_row"][str(dtype)] = worst_rows
        torch.cuda.empty_cache()

    args = ssd_inputs(2, sH, 2048, P, G, N, seed=30)
    want = ref.ssd_scan_ref(*args, chunk=ssm.chunk)     # chunk-free scan
    for chunk in (ssm.chunk, 128):
        got = ops.ssd_scan(*args, chunk=chunk)
        calls["ssd"] += 1
        torch.cuda.synchronize()
        name = (f"ssd_scan B=2 H={sH} S=2048 P={P} G={G} N={N} "
                f"chunk={chunk}")
        err = check_ssd(name, got, want)
        out["ssd_err"][chunk] = err
        print(f"kernel check: {name}: max|err|={err:.3e} (atol {SSD_ATOL}, "
              f"rtol {SSD_RTOL}; |y| up to {float(want.abs().max()):.2f})",
              flush=True)
    out["ssd_args"] = args
    del want
    for i, (B, h, S, p, g, n, chunk) in enumerate(
            ((1, 2, 64, 16, 1, 16, 16), (2, 4, 128, 16, 2, 24, 32),
             (1, 8, 96, 8, 4, 16, 48))):
        sargs = ssd_inputs(B, h, S, p, g, n, seed=31 + i)
        got = ops.ssd_scan(*sargs, chunk=chunk)
        calls["ssd"] += 1
        err = check_ssd(f"ssd_scan sweep {(B, h, S, p, g, n, chunk)}", got,
                        ref.ssd_scan_ref(*sargs, chunk=chunk))
        print(f"kernel check: ssd_scan (B,H,S,P,G,N,chunk)="
              f"{(B, h, S, p, g, n, chunk)}: max|err|={err:.3e}", flush=True)
    # a ~ -U(0.5, 12): the cumsum of dt * a passes -88 inside a chunk,
    # where exp(cum_i) * exp(-cum_j) would overflow fp32
    sargs = ssd_inputs(1, 8, 512, P, G, N, seed=35, a_hi=12.0)
    chunks = (sargs[1] * sargs[2][None, :, None]).reshape(1, 8, 2, 256)
    deepest = float(chunks.cumsum(-1).min())
    if not deepest < -88:
        fail(f"ssd_scan deep-decay case: cumsum reaches only {deepest:.1f}")
    got = ops.ssd_scan(*sargs, chunk=256)
    calls["ssd"] += 1
    err = check_ssd("ssd_scan deep decay", got,
                    ref.ssd_scan_ref(*sargs, chunk=256))
    print(f"kernel check: ssd_scan B=1 H=8 S=512 P={P} G={G} N={N} "
          f"chunk=256, a ~ -U(0.5, 12) (cumsum down to "
          f"{deepest:.1f} inside a chunk): max|err|={err:.3e}", flush=True)
    sargs = ssd_inputs(1, 2, 96, 8, 1, 16, seed=34, a_hi=2.0)
    want = ref.ssd_scan_ref(*sargs, chunk=16)
    outs = []
    for chunk in (16, 32, 48, 96):
        outs.append(ops.ssd_scan(*sargs, chunk=chunk))
        calls["ssd"] += 1
        check_ssd(f"ssd_scan chunk={chunk}", outs[-1], want)
        check_ssd(f"ssd_scan chunk={chunk} against chunk=16", outs[-1],
                  outs[0])
    print(f"kernel check: ssd_scan chunk invariance, chunks 16/32/48/96: "
          f"max|err| against the plain scan "
          f"{max(max_abs_err(o, want) for o in outs):.3e}, against chunk "
          f"16 {max(max_abs_err(o, outs[0]) for o in outs):.3e}", flush=True)
    out["launches"] = {"flash": flash_attention.launches,
                       "ssd": ssd_scan.launches}       # entry points end
    if out["launches"] != calls:
        fail(f"flash_attention / ssd_scan launched {out['launches']} times "
             f"for {calls} calls through ops")
    out["full"] = (H, K, hd, sH, P, N, G, ssm.chunk)
    return out


def time_dense_kernels(card: str, dense: dict) -> dict:
    """Device time per launch of flash_attention (bf16 and fp32, B=1,
    S=T=2048 causal, Llama-3.1-8B widths) and ssd_scan (Mamba2-780m widths,
    B=2, S=2048, chunk 256 and 128) beside their plain versions, their
    bounds and, for flash_attention, the library call
    `scaled_dot_product_attention(..., is_causal=True, enable_gqa=True)`
    (a yardstick only, held against the plain version once before it is
    timed). Returns the bf16 flash and chunk-256 ssd numbers for the
    kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    H, K, hd, sH, P, N, G, chunk = dense["full"]
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(1, H, K, 2048, 2048, hd, dtype, seed=40)
        plain = ref.flash_attention_ref(q, k, v, causal=True)
        lib_err = check_close(
            f"scaled_dot_product_attention {str(dtype)[6:]} against the "
            f"plain version", F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), plain)
        del plain
        t = timing(
            ms=device_ms(lambda: flash_attention(q, k, v, causal=True),
                         iters=20),
            plain_ms=device_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True), iters=5, warmup=2),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), iters=20))
        kern, pl, lib = t["ms"], t["plain_ms"], t["library_ms"]
        how = t["timed_by"]["ms"]
        b_ms, b_by = flash_bound(q, k, True)
        print(f"[{card}] flash_attention {str(dtype)[6:]} B=1 H={H} K={K} "
              f"S=T=2048 hd={hd} causal: kernel {kern * 1e3:.1f} us ({how}), "
              f"plain {pl * 1e3:.1f} us, library (SDPA, max|err| against "
              f"plain {lib_err:.3e}) {lib * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}; roofline share "
              f"{100 * b_ms / kern:.1f}%)", flush=True)
        rows[str(dtype)] = dict(t, bound_ms=b_ms, bound_by=b_by)
        del q, k, v
        torch.cuda.empty_cache()
    args = dense["ssd_args"]
    plain = device_ms(lambda: ref.ssd_scan_ref(*args, chunk=chunk), iters=2,
                      warmup=1)
    pl = plain[0]
    # one bound for both timings: the scan's work at the configured chunk,
    # at each peak of SSD_PEAKS; the kernels line takes the first, the
    # peak of the kernel's own form (3xTF32)
    bounds = [(name, pk, *ssd_bound(args[0], args[3], chunk, pk))
              for name, pk in SSD_PEAKS]
    b_ms, b_by = bounds[0][2:]
    for c in (128, chunk):
        kern, how = device_ms(lambda: ssd_scan(*args, chunk=c), iters=20)
        passes = kernel_parts(lambda: ssd_scan(*args, chunk=c), iters=10)
        gflop = ssd_chunked_flops(args[0], args[3], c) / 1e9
        print(f"[{card}] ssd_scan B=2 H={sH} S=2048 P={P} G={G} N={N} "
              f"chunk={c}: kernel {kern * 1e3:.1f} us ({how}; "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in passes.items())
              + f" us), plain (token-by-token scan) {pl * 1e3:.1f} us, "
              + "; ".join(f"bound {ms * 1e3:.2f} us ({by} at the {name} peak, "
                          f"{pk / 1e12:.0f} TFLOP/s; roofline share "
                          f"{100 * ms / kern:.1f}%)"
                          for name, pk, ms, by in bounds)
              + f"; the chunked form's products {gflop:.2f} GFLOP = "
              f"{gflop / kern:.1f} TFLOP/s", flush=True)
    # the kernels line reports the configured chunk, timed last
    rows["ssd"] = dict(timing(ms=(kern, how), plain_ms=plain),
                       bound_ms=b_ms, bound_by=b_by)
    return rows


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


def check_page_copies(dtype, gather, scatter, pool=None) -> float:
    """page_gather / page_scatter against their plain versions at the
    full-width pool (by default Llama-3.1-8B's), bit for bit (tolerance
    0): N in {1, 5, 16, 100}; pages outside the ids untouched; gather then
    scatter restores the pool. Returns the largest |kernel - plain| seen
    (0.0 when exact)."""
    import torch
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEVICE).manual_seed(11)
    pool = pool or POOL
    P = pool[1]
    kp = torch.randn(pool, generator=g, device=DEVICE).to(dtype)
    vp = torch.randn(pool, generator=g, device=DEVICE).to(dtype)
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


def copy_bound(n: int, itemsize: int, pool=None) -> float:
    """Least time of one page copy call, in ms: N tiles of both pools read
    once and written once over the HBM rate (no arithmetic)."""
    L, _, page, K, hd = pool or POOL
    return 1e3 * 2 * n * L * page * K * hd * itemsize * 2 / HBM_BYTES_PER_S


def time_page_copies(gather, scatter, ns=(16, 100), pool=None) -> dict:
    """Device ms of each copy at N pages on the full-width bf16 pools:
    the kernel, its plain version and its library call (`device_ms`), and
    the bound; besides, the kernel's CUDA-event ms over back-to-back
    wrapper calls, which counts the wrapper's host work where it outlasts
    the kernel. Each run of calls cycles over disjoint id sets, each with
    its own staged stacks, so the pages and the stacks come from HBM (2 GB
    pools and 8 stacks of 12.6-210 MB against a 50 MB L2), as a flush or
    a load-back finds them. The library yardsticks take one call per pool:
    `index_select(pool, 1, ids)` and `pool.index_copy_(1, ids,
    stack.transpose(0, 1))`."""
    import torch
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEVICE).manual_seed(12)
    pool = pool or POOL
    P = pool[1]
    kp = torch.randn(pool, generator=g, device=DEVICE).to(torch.bfloat16)
    vp = torch.randn(pool, generator=g, device=DEVICE).to(torch.bfloat16)
    out = {}
    for n in ns:
        perm = torch.randperm(P, generator=g, device=DEVICE).to(torch.int32)
        sets = [perm[i * n:(i + 1) * n] for i in range(min(8, P // n))]
        sets64 = [s.long() for s in sets]
        stacks = [gather(kp, vp, s) for s in sets]
        turn = [0]

        def nxt():
            turn[0] += 1
            return turn[0] % len(sets)

        def g_lib():
            i = sets64[nxt()]
            torch.index_select(kp, 1, i)
            torch.index_select(vp, 1, i)

        def s_plain():
            j = nxt()
            ref.page_scatter_ref(kp, stacks[j][0], sets[j])
            ref.page_scatter_ref(vp, stacks[j][1], sets[j])

        def s_lib():
            j = nxt()
            kp.index_copy_(1, sets64[j], stacks[j][0].transpose(0, 1))
            vp.index_copy_(1, sets64[j], stacks[j][1].transpose(0, 1))

        def g_plain():
            i = sets[nxt()]
            ref.page_gather_ref(kp, i)
            ref.page_gather_ref(vp, i)

        def g_kernel():
            gather(kp, vp, sets[nxt()])

        def s_kernel():
            j = nxt()
            scatter(kp, vp, *stacks[j], sets[j])

        out[n] = {"bound": copy_bound(n, 2, pool)}
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


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def serve_sessions(eng, rng, label: str) -> dict:
    """Phase 4's workload on `eng`: a warm-up request of its own tokens
    (cuBLAS handles, the kernel library) before anything is counted or
    timed, then the first turns of four chat sessions sharing a system
    prompt (`session_requests`) and their follow-ups (the first turn, its
    answer and 24 new tokens). Times every prefill round and decode step
    (each ends in its host sync), counts paged_decode's launches over the
    sessions (the path's counts: set to 0 just before, read just after)
    and captures one decode step's layer-0 attention inputs and output.
    Checks every result at its exact budget, cached tokens on every
    follow-up and launches = layers x decode steps. Returns the turns,
    results, launches, capture, timings and uncached prefill tokens."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.serving import GenRequest, SamplingParams
    cfg = eng.cfg
    eng.generate([GenRequest(prompt_tokens=tuple(
        rng.integers(0, cfg.vocab, size=40).tolist()),
        sampling=SamplingParams(max_new_tokens=4))])

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
    paged_decode.launches = 0                          # the path starts
    turn1 = session_requests(GenRequest, SamplingParams, cfg.vocab, rng)
    res1 = eng.generate(turn1)
    turn2 = [GenRequest(prompt_tokens=r.prompt_tokens + o.output_tokens + tuple(
        rng.integers(0, cfg.vocab, size=24).tolist()),
        sampling=r.sampling) for r, o in zip(turn1, res1)]
    res2 = eng.generate(turn2)
    launches = paged_decode.launches                   # the path ends
    ops.paged_decode = orig_ops
    be.prefill_batch, be.decode = orig_prefill, orig_decode
    prefilled = eng.prefill_tokens - eng.cached_tokens - prefill_before

    check_results(label, res1 + res2, cfg.vocab)
    got = [len(r.output_tokens) for r in res1 + res2]
    budgets = [r.sampling.max_new_tokens for r in turn1 + turn2]
    if got != budgets:
        fail(f"{label}: output lengths {got} != budgets {budgets}")
    if not all(r.cached_tokens > 0 for r in res2):
        fail(f"{label}: follow-up turns hit no cache: "
             f"{[r.cached_tokens for r in res2]}")
    want_launches = cfg.n_layers * len(decode_s)
    if launches != want_launches:
        fail(f"{label}: paged_decode launched {launches} times; expected "
             f"n_layers x decode steps = {want_launches}")
    if not captured:
        fail(f"{label}: no decode step was captured")
    return dict(turns=[turn1, turn2], results=[res1, res2],
                launches=launches, captured=captured, prefill_s=prefill_s,
                decode_s=decode_s, decode_tokens=decode_tokens[0],
                prefilled=prefilled)


def spec_phase(cfg, params, ecfg, turns, base, drafter, label: str,
               capture_at=None) -> dict:
    """Speculation at full width: phase 4's requests (`turns`, each a list
    of (prompt, sampling) served in order, so turn 2 hits turn 1's cache)
    through an engine with spec_k=SPEC_K and the drafter (cfg, params).
    Checks every request's exact budget and both kernels' launches against
    the spec dispatches; prints acceptance, tokens per sequence-step and the
    agreement with phase 4's non-speculative streams `base`. With
    `capture_at` = n, the layer-0 inputs and output of the n-th dispatch's
    verify call are captured. Returns the engine, the launches of
    (paged_verify, paged_decode), tokens per sequence-step, the output
    streams and the capture."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_verify import paged_verify
    from repro_torch.serving import Engine, GenRequest
    dcfg, dparams = drafter
    eng = Engine(cfg, params, dataclasses.replace(ecfg, spec_k=SPEC_K),
                 seed=0, draft_cfg=dcfg, draft_params=dparams, device=DEVICE)
    be = eng.backend
    captured = {}
    orig_ops = ops.paged_verify

    def capturing(q, k_pages, v_pages, table, seq_lens):
        out = orig_ops(q, k_pages, v_pages, table, seq_lens)
        if be.spec_dispatches + 1 == capture_at and not captured:
            captured.update(q=q.clone(), k=k_pages.clone(), v=v_pages.clone(),
                            table=table.clone(), lens=seq_lens.clone(),
                            out=out.clone())
        return out

    ops.paged_verify = capturing
    paged_verify.launches = paged_decode.launches = 0   # 4d path starts
    res = []
    for turn in turns:
        res += eng.generate([GenRequest(prompt_tokens=p, sampling=sp)
                             for p, sp in turn])
    launches = (paged_verify.launches, paged_decode.launches)  # path ends
    ops.paged_verify = orig_ops
    check_results(f"speculation ({label})", res, cfg.vocab)
    budgets = [sp.max_new_tokens for turn in turns for _, sp in turn]
    got = [len(r.output_tokens) for r in res]
    if got != budgets:
        fail(f"speculation ({label}): output lengths {got} != budgets "
             f"{budgets}")
    disp = be.spec_dispatches
    want = (cfg.n_layers * disp, dcfg.n_layers * (SPEC_K + 1) * disp)
    if not disp > 0 or launches != want:
        fail(f"speculation ({label}): paged_verify / paged_decode launched "
             f"{launches} times over {disp} spec dispatches; expected "
             f"{want} = ({cfg.n_layers} x dispatches, {dcfg.n_layers} x "
             f"{SPEC_K + 1} x dispatches)")
    seq_steps = be.spec_drafted // SPEC_K
    per_step = eng.core.spec_tokens / seq_steps
    outs = [r.output_tokens for r in res]
    same = sum(o == b for o, b in zip(outs, base))
    agree = sum(common_prefix(o, b) for o, b in zip(outs, base))
    print(f"speculation ({label}): {len(res)} requests at their exact "
          f"budgets, {disp} spec dispatches, acceptance "
          f"{be.spec_accepted}/{be.spec_drafted} = "
          f"{be.spec_accepted / be.spec_drafted:.3f}, "
          f"{per_step:.3f} tokens per sequence-step; launches paged_verify "
          f"{launches[0]} = {cfg.n_layers} x {disp}, paged_decode "
          f"{launches[1]} = {dcfg.n_layers} x {SPEC_K + 1} x {disp}; "
          f"against the plain engine's bf16 streams: {same}/{len(res)} "
          f"requests "
          f"identical, common prefixes {agree}/{sum(map(len, base))} "
          f"tokens", flush=True)
    if capture_at is not None and not captured:
        fail(f"speculation ({label}): no verify step was captured")
    return dict(eng=eng, launches=launches, per_step=per_step, outs=outs,
                captured=captured)


def moe_phase(card: str) -> dict:
    """Phase 4e, the MoE FFN at full width on granite-moe-1b-a400m (24
    layers, d 1024, 16/8 heads, hd 64, 32 experts, top-8, d_expert 512,
    seeded random bf16 weights, the router fp32). Holds paged_decode and
    paged_verify at its attention widths and the page copies on its pool
    against their plain versions; serves phase 4's two-turn sessions twice
    through `Engine(device=None)` (the same tokens both times, exact
    budgets, cached follow-ups, paged_decode = layers x decode steps), the
    host tier, and speculation with the target as its own drafter; checks
    that a small fp32 MoE engine whose prefill drops tokens past capacity
    gives the CPU path's tokens, plain and speculative; serves the CLI's
    two modes (24 requests, a hit rate > 0). Prints the plain decode step
    at batch 8 (wall, tok/s, device busy) with the device ms of its parts.
    Returns the MoE numbers of rows 1-4 of the kernels line."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.page_copy import page_gather, page_scatter
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_verify import paged_verify
    from repro_torch.launch import serve
    from repro_torch.models import init_params, leaves, moe, param_count
    from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                     SamplingParams)
    from repro_torch.serving import model_runner as mr

    cfg = get_config(MOE)
    pool = (cfg.n_layers, 1024, 16, cfg.n_kv_heads, cfg.hd)
    widths = f"{cfg.name} H={cfg.n_heads} K={pool[3]} hd={pool[4]}"
    paged_checks(pool, cfg.n_heads)
    copy_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        copy_err = max(copy_err,
                       check_page_copies(dtype, page_gather, page_scatter,
                                         pool))
        torch.cuda.empty_cache()
        print(f"kernel check: page_gather / page_scatter {str(dtype)[6:]} "
              f"pools {pool} ({cfg.name}), N in (1, 5, 16, 100): bit-exact "
              f"against the plain versions (tolerance 0), pages outside the "
              f"ids untouched, gather then scatter restores the pool",
              flush=True)

    t0 = time.perf_counter()
    params = init_params(cfg, torch.bfloat16, DEVICE,
                         torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = param_count(params)
    gb = sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9
    print(f"weights: {cfg.name} {n_params / 1e9:.3f} B params bf16, the "
          f"router fp32 ({gb:.2f} GB) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # two runs of phase 4's sessions: the combine's fixed order makes the
    # bf16 streams repeat
    ecfg = EngineConfig(page_size=16, n_pages=pool[1], max_batch=8,
                        max_seq_len=2048)
    outs = []
    for i in range(2):
        eng = Engine(cfg, params, ecfg, seed=0, device=None)   # the card
        run = serve_sessions(eng, np.random.default_rng(0),
                             f"MoE engine, run {i + 1}")
        res = run["results"][0] + run["results"][1]
        steps, launches = len(run["decode_s"]), run["launches"]
        outs.append([r.output_tokens for r in res])
        print(f"MoE engine ({cfg.name} bf16), run {i + 1}: {len(res)} "
              f"requests at their exact budgets, "
              f"{sum(map(len, outs[-1]))} tokens out, cached tokens on "
              f"follow-ups {[r.cached_tokens for r in run['results'][1]]}, "
              f"{steps} decode steps, paged_decode launches {launches} = "
              f"{cfg.n_layers} x {steps}", flush=True)
    if outs[0] != outs[1]:
        fail("MoE engine: two bf16 runs gave different tokens")
    c = run["captured"]
    c_args = (c["q"], c["k"], c["v"], c["table"], c["lens"])
    m_err = check_close("MoE paged_decode on a captured decode step",
                        c["out"], ref.paged_decode_ref(*c_args))
    m_row = check_rows("MoE paged_decode on a captured decode step",
                       c["out"], *c_args)
    print(f"MoE engine: the two bf16 runs' tokens are identical "
          f"({sum(map(len, outs[0]))} tokens); captured step (B="
          f"{c['q'].shape[0]}, lens={c['lens'].tolist()}) max|err|="
          f"{m_err:.3e}, against fp32 per row {m_row:.3e}", flush=True)

    host_launches = host_tier_phase(cfg, params)
    turns = [[(r.prompt_tokens, r.sampling) for r in t]
             for t in run["turns"]]
    spec = spec_phase(cfg, params, ecfg, turns, outs[1], (cfg, params),
                      f"{cfg.name}, drafter = target", capture_at=5)
    vc = spec["captured"]
    v_args = (vc["q"], vc["k"], vc["v"], vc["table"], vc["lens"])
    v_err = check_close("MoE paged_verify on a captured verify step",
                        vc["out"], ref.paged_verify_ref(*v_args))
    v_row = check_rows("MoE paged_verify on a captured verify step",
                       vc["out"], *v_args, plain=ref.paged_verify_ref)
    print(f"MoE speculation: captured verify step (B={vc['q'].shape[0]}, "
          f"Q={vc['q'].shape[1]}, lens={vc['lens'].tolist()}) max|err|="
          f"{v_err:.3e}, against fp32 per row {v_row:.3e}", flush=True)

    # a small fp32 MoE engine on the card against the plain CPU path;
    # request 0 opens with 100 equal tokens, whose hidden states route
    # alike and overflow two experts at prefill
    small = get_config(MOE_SMALL)
    cpu_params = init_params(small, torch.float32, "cpu",
                             torch.Generator().manual_seed(0))
    gpu_params = _to(cpu_params, DEVICE)
    r = np.random.default_rng(5)

    def tok(n):
        return tuple(int(t) for t in r.integers(1, small.vocab, n))

    specs = [((7,) * 100 + tok(8), dict(max_new_tokens=6)),
             (tok(23), dict(max_new_tokens=5, temperature=0.7, top_k=3,
                            seed=1)),
             (tok(9), dict(max_new_tokens=7, temperature=1.1, seed=4)),
             (tok(31), dict(max_new_tokens=4))]
    small_ecfg = EngineConfig(page_size=8, n_pages=64, max_batch=4,
                              max_seq_len=256, prefill_pad=16)
    dropped: dict = {}
    orig_dispatch = moe._dispatch_group

    def counting(gate_vals, eids, E, C):
        out = orig_dispatch(gate_vals, eids, E, C)
        dev = eids.device.type
        dropped[dev] = dropped.get(dev, 0) + int((out[2] == E * C).sum())
        return out

    moe._dispatch_group = counting
    streams, accept = {}, ""
    for label, dev, p, k in (("card", DEVICE, gpu_params, 0),
                             ("CPU", "cpu", cpu_params, 0),
                             ("card, spec", DEVICE, gpu_params, SPEC_K),
                             ("CPU, spec", "cpu", cpu_params, SPEC_K)):
        e = Engine(small, p, dataclasses.replace(small_ecfg, spec_k=k),
                   draft_cfg=small if k else None,
                   draft_params=p if k else None, device=dev)
        streams[label] = [o.output_tokens for o in e.generate([
            GenRequest(prompt_tokens=pr, sampling=SamplingParams(**kw))
            for pr, kw in specs])]
        if label == "card, spec":
            accept = (f"{e.backend.spec_accepted}/"
                      f"{e.backend.spec_drafted}")
    moe._dispatch_group = orig_dispatch
    if streams["card"] != streams["CPU"]:
        fail(f"small fp32 MoE engine: card tokens {streams['card']} != plain "
             f"CPU path {streams['CPU']}")
    if streams["card, spec"] != streams["CPU, spec"]:
        fail(f"small fp32 MoE engine, speculation: card tokens "
             f"{streams['card, spec']} != plain CPU path "
             f"{streams['CPU, spec']}")
    card_drops = dropped.get(torch.device(DEVICE).type, 0)
    if not card_drops > 0:
        fail("small fp32 MoE engine: no assignment dropped past capacity")
    print(f"reference: small fp32 MoE engine ({small.name}) tokens on the "
          f"card equal the plain CPU path's, plain and speculative (spec_k="
          f"{SPEC_K}, drafter = target, acceptance {accept}; the same as "
          f"the plain stream: {streams['card, spec'] == streams['card']}); "
          f"{card_drops} assignments dropped past capacity on the card",
          flush=True)

    # the serve CLI on the card
    paged_decode.launches = 0                         # CLI path starts
    single = serve.serve_single(MOE, 24, 8)
    multi = serve.serve_multiregion(MOE, 24, 8)
    cli_launches = paged_decode.launches              # CLI path ends
    print(f"[{card}] repro_torch.launch.serve.serve_single({MOE!r}, 24, 8): "
          f"{single}", flush=True)
    print(f"[{card}] repro_torch.launch.serve.serve_multiregion({MOE!r}, "
          f"24, 8): {multi}", flush=True)
    multi_rates = [x for lb in multi["hit_rates"].values()
                   for x in lb.values()]
    if not (single["requests"] == multi["requests"] == 24
            and single["hit_rate"] > 0 and max(multi_rates) > 0):
        fail(f"serve CLI: requests {single['requests']} / "
             f"{multi['requests']} (want 24 each), hit rates "
             f"{single['hit_rate']} / {multi_rates} (want some > 0)")
    if not cli_launches > 0:
        fail("serve CLI: paged_decode never launched")
    print(f"serve CLI: both modes answered 24 requests; paged_decode "
          f"launches {cli_launches}", flush=True)
    torch.cuda.empty_cache()

    # the plain decode step at batch 8, and its parts' device time: the
    # MoE layers and their expert products replayed on one steady step's
    # captured inputs
    moe_calls, exp_calls = [], []

    def capture_layers(e):
        apply, experts = mr.apply_moe, moe._experts

        def rec_apply(p, x, c):
            moe_calls.append((p, x.clone()))
            return apply(p, x, c)

        def rec_experts(p, xe):
            exp_calls.append((p, xe.clone()))
            return experts(p, xe)

        mr.apply_moe, moe._experts = rec_apply, rec_experts
        try:
            e.step()
        finally:
            mr.apply_moe, moe._experts = apply, experts

    step_ms, step_tps, busy, paged = decode_profile(
        eng, card, f"{cfg.name} plain decode", GenRequest, SamplingParams,
        np.random.default_rng(1), on_steady=capture_layers)
    if not len(moe_calls) == len(exp_calls) == cfg.n_layers:
        fail(f"MoE profile: captured {len(moe_calls)} / {len(exp_calls)} "
             f"layer calls, not {cfg.n_layers}")
    moe_ms, _ = device_ms(lambda: [mr.apply_moe(p, x, cfg)
                                   for p, x in moe_calls], iters=10)
    exp_ms, _ = device_ms(lambda: [moe._experts(p, xe)
                                   for p, xe in exp_calls], iters=10)
    w_bytes = sum(p[k].numel() * p[k].element_size() for p, _ in exp_calls
                  for k in ("w_gate", "w_up", "w_down"))
    exp_bound = 1e3 * w_bytes / HBM_BYTES_PER_S
    dec_ms = paged["paged_decode"]
    xe = exp_calls[0][1]
    print(f"[{card}] {cfg.name} plain decode step, batch 8: wall "
          f"{step_ms:.2f} ms, {step_tps:.1f} tok/s, device busy {busy:.2f} "
          f"ms = {100 * busy / step_ms:.1f}% of the wall; device ms per "
          f"step: expert products {exp_ms:.3f} (G x E x C = "
          f"{' x '.join(map(str, xe.shape[:3]))} rows per layer; "
          f"{w_bytes / 1e9:.2f} GB of expert weights, bound "
          f"{exp_bound:.3f} ms, bytes), dispatch (router, softmax, top-k, "
          f"sort, gather, combine) {moe_ms - exp_ms:.3f}, paged_decode "
          f"{dec_ms:.3f}, the rest {busy - moe_ms - dec_ms:.3f}", flush=True)

    # rows 1-4 at these widths
    dec_t = timing(ms=device_ms(lambda: paged_decode(*c_args)),
                   plain_ms=device_ms(lambda: ref.paged_decode_ref(*c_args),
                                      iters=20))
    k_ms, p_ms = dec_t["ms"], dec_t["plain_ms"]
    b_ms, b_by = paged_bound(c["q"], c["k"], c["table"], c["lens"])
    ver_t = timing(ms=device_ms(lambda: paged_verify(*v_args)),
                   plain_ms=device_ms(lambda: ref.paged_verify_ref(*v_args),
                                      iters=20))
    vk_ms, vp_ms = ver_t["ms"], ver_t["plain_ms"]
    vb_ms, vb_by = verify_bound(vc["q"], vc["k"], vc["table"], vc["lens"])
    print(f"[{card}] paged_decode at the MoE captured step ({widths}, B="
          f"{c['q'].shape[0]}, lens={c['lens'].tolist()}): "
          f"{split_note(c['q'], c['k'], c['table'], c['lens'])[0]}; kernel "
          f"{k_ms * 1e3:.1f} us ({dec_t['timed_by']['ms']}), plain "
          f"{p_ms * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}), {cfg.n_layers} launches per "
          f"decode step", flush=True)
    print(f"[{card}] paged_verify at the MoE captured verify step ({widths},"
          f" B={vc['q'].shape[0]}, Q={vc['q'].shape[1]}, lens="
          f"{vc['lens'].tolist()}): "
          f"{split_note(vc['q'], vc['k'], vc['table'], vc['lens'])[0]}; "
          f"kernel {vk_ms * 1e3:.1f} us ({ver_t['timed_by']['ms']}), plain "
          f"{vp_ms * 1e3:.1f} us, bound {vb_ms * 1e3:.2f} us ({vb_by})",
          flush=True)
    copy_t = time_page_copies(page_gather, page_scatter, ns=(16,), pool=pool)
    t = copy_t[16]
    for name in ("gather", "scatter"):
        (k, how), (pl, _), (lib, _) = (t[name]["kernel"], t[name]["plain"],
                                       t[name]["library"])
        print(f"[{card}] page_{name} bf16 N=16 pools {pool}: kernel "
              f"{k * 1e3:.1f} us ({how}), plain {pl * 1e3:.1f} us, library "
              f"{lib * 1e3:.1f} us, bound {t['bound'] * 1e3:.1f} us (bytes; "
              f"roofline share {100 * t['bound'] / k:.1f}%)", flush=True)
    rows = {
        "paged_decode": dict(dec_t, launches=launches, max_abs_err=m_err,
                             bound_ms=b_ms, bound_by=b_by),
        "paged_verify": dict(ver_t, launches=spec["launches"][0],
                             max_abs_err=v_err, bound_ms=vb_ms,
                             bound_by=vb_by)}
    for i, name in enumerate(("gather", "scatter")):
        rows[f"page_{name}"] = dict(
            timing(ms=t[name]["kernel"], plain_ms=t[name]["plain"],
                   library_ms=t[name]["library"]),
            launches=host_launches[i], max_abs_err=copy_err,
            bound_ms=t["bound"], bound_by="bytes")
    for name, row in rows.items():
        row["shape"] = (f"N=16 pages of bf16 pools {list(pool)}"
                        if name.startswith("page_") else widths)
    return rows


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
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.page_copy import page_gather, page_scatter
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.paged_verify import paged_verify
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
    with ThreadPoolExecutor(len(KERNELS) + len(PTXAS)) as ex:
        reports = ex.map(ptxas_report, PTXAS)        # one nvcc per source
        built = list(ex.map(build.compile_library, KERNELS))
        reports = list(reports)
    for name, (lib_path, nvcc_s) in zip(KERNELS, built):
        print(f"build: {name}.cu -> {lib_path.name} (nvcc {nvcc_s:.2f} s)",
              flush=True)
    print(f"build: {len(KERNELS)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, lines in zip(PTXAS, reports):
        for line in lines:
            print(f"build: ptxas -v {name}.cu: {line}", flush=True)

    # ---- 3. kernel against its plain version at Llama-3.1-8B decode shapes
    lens, v_lens = paged_checks(POOL, 32)
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

    # flash_attention and ssd_scan through their entry points
    dense = dense_kernels_phase()

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
    run = serve_sessions(eng, rng, "engine")
    turn1, turn2, res1, res2 = run["turns"] + run["results"]
    launches, captured, decode_s = (run["launches"], run["captured"],
                                    run["decode_s"])
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

    # ---- 4d. speculation at full width on phase 4's requests: the target
    # as its own drafter (one params dict, its own drafter pool), then a
    # random 2-layer drafter of the target's widths
    turns = [[(r.prompt_tokens, r.sampling) for r in t]
             for t in (turn1, turn2)]
    base = [o.output_tokens for o in res1 + res2]
    spec_a = spec_phase(cfg, params, ecfg, turns, base, (cfg, params),
                        "drafter = target", capture_at=5)
    if not spec_a["per_step"] > 1:
        fail(f"speculation (drafter = target): {spec_a['per_step']:.3f} "
             f"tokens per sequence-step, not more than 1")
    dcfg = dataclasses.replace(cfg, n_layers=2)
    dparams = init_params(dcfg, torch.bfloat16, DEVICE,
                          torch.Generator(device=DEVICE).manual_seed(1))
    spec_b = spec_phase(cfg, params, ecfg, turns, base, (dcfg, dparams),
                        "2-layer drafter")
    vc = spec_a["captured"]
    v_args = (vc["q"], vc["k"], vc["v"], vc["table"], vc["lens"])
    v_err = check_close("paged_verify on a captured verify step", vc["out"],
                        ref.paged_verify_ref(*v_args))
    v_row = check_rows("paged_verify on a captured verify step", vc["out"],
                       *v_args, plain=ref.paged_verify_ref)
    same_ab = sum(a == b for a, b in zip(spec_a["outs"], spec_b["outs"]))
    print(f"speculation: the two drafters' streams are identical on "
          f"{same_ab}/{len(base)} requests; captured verify step "
          f"(B={vc['q'].shape[0]}, Q={vc['q'].shape[1]}, "
          f"lens={vc['lens'].tolist()}) max|err|={v_err:.3e}, against fp32 "
          f"per row {v_row:.3e}", flush=True)

    # ---- 4e. the MoE FFN at full width: granite-moe-1b-a400m
    moe_rows = moe_phase(card)

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
    small_ecfg = EngineConfig(page_size=8, n_pages=64, max_batch=4,
                              max_seq_len=256, prefill_pad=16)

    def small_reqs():
        r = np.random.default_rng(3)
        return [GenRequest(prompt_tokens=tuple(
            r.integers(0, small.vocab, size=n).tolist()),
            sampling=SamplingParams(**kw)) for n, kw in specs]

    for dev, p in ((DEVICE, gpu_params), ("cpu", cpu_params)):
        e = Engine(small, p, small_ecfg, device=dev)
        streams.append([o.output_tokens for o in e.generate(small_reqs())])
    if streams[0] != streams[1]:
        fail(f"small fp32 engine: card tokens {streams[0]} != plain CPU "
             f"path {streams[1]}")
    print(f"reference: small fp32 engine tokens on the card equal the plain "
          f"CPU path ({sum(map(len, streams[0]))} tokens)", flush=True)
    # speculation on the card against the plain CPU path's NON-speculative
    # tokens: the target as drafter, and tests/test_speculative.py's small
    # random drafter
    small_d = dataclasses.replace(small, name="drafter", n_layers=2,
                                  d_model=32, n_heads=2, n_kv_heads=1,
                                  d_ff=64, head_dim=16)
    small_dp = init_params(small_d, torch.float32, DEVICE,
                           torch.Generator(device=DEVICE).manual_seed(99))
    spec_small = []
    for label, d in (("drafter = target", (small, gpu_params)),
                     ("small random drafter", (small_d, small_dp))):
        e = Engine(small, gpu_params,
                   dataclasses.replace(small_ecfg, spec_k=SPEC_K),
                   draft_cfg=d[0], draft_params=d[1], device=DEVICE)
        out = [o.output_tokens for o in e.generate(small_reqs())]
        if out != streams[1]:
            fail(f"small fp32 engine, speculation ({label}): card tokens "
                 f"{out} != plain CPU path {streams[1]}")
        b = e.backend
        spec_small.append(f"{label}: acceptance {b.spec_accepted}/"
                          f"{b.spec_drafted}")
    print(f"reference: small fp32 speculative engine (spec_k={SPEC_K}) on "
          f"the card gives the plain CPU path's non-speculative tokens; "
          f"{'; '.join(spec_small)}", flush=True)
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
    prefill_s, prefilled = run["prefill_s"], run["prefilled"]
    dec_tok_s = run["decode_tokens"] / sum(decode_s)
    pre_tok_s = prefilled / sum(prefill_s)
    step_ms = 1e3 * statistics.median(decode_s)
    q, kp, vp, table, ln = (c["q"], c["k"], c["v"], c["table"], c["lens"])
    k_ms = cuda_ms(lambda: paged_decode(q, kp, vp, table, ln))
    p_ms = cuda_ms(lambda: ref.paged_decode_ref(q, kp, vp, table, ln))
    # the same two as device time, which the kernels line reports as every
    # row does; the events above stay in the printed line only
    dec_t = timing(
        ms=device_ms(lambda: paged_decode(q, kp, vp, table, ln)),
        plain_ms=device_ms(lambda: ref.paged_decode_ref(q, kp, vp, table, ln),
                           iters=20))
    k_dev, p_dev = dec_t["ms"], dec_t["plain_ms"]
    b_ms, b_by = paged_bound(q, kp, table, ln)
    k_parts = kernel_parts(lambda: paged_decode(q, kp, vp, table, ln))
    print(f"[{card}] engine {cfg.name} bf16 page=16 max_batch=8: prefill "
          f"{pre_tok_s:.1f} tok/s ({prefilled} uncached tokens in "
          f"{len(prefill_s)} rounds), decode {dec_tok_s:.1f} tok/s, median "
          f"decode step {step_ms:.2f} ms", flush=True)
    print(f"[{card}] paged_decode at the captured step (B={q.shape[0]}, "
          f"NPG={table.shape[1]}, lens={ln.tolist()}): "
          f"{split_note(q, kp, table, ln)[0]}", flush=True)
    print(f"[{card}] paged_decode at the captured step (B={q.shape[0]}, "
          f"lens={ln.tolist()}): kernel {k_ms * 1e3:.1f} us, plain "
          f"{p_ms * 1e3:.1f} us (CUDA events over back-to-back calls; "
          f"device time ({dec_t['timed_by']['ms']}): kernel "
          f"{k_dev * 1e3:.1f} us, plain {p_dev * 1e3:.1f} us; split and "
          f"combine "
          + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in k_parts.items())
          + f" us), bound {b_ms * 1e3:.2f} us ({b_by}), "
          f"{launches // len(decode_s)} launches per decode step", flush=True)
    big = kernel_inputs(torch.bfloat16, lens, seed=2)
    kb_ms = cuda_ms(lambda: paged_decode(*big))
    pb_ms = cuda_ms(lambda: ref.paged_decode_ref(*big), iters=10)
    kb_dev, _ = device_ms(lambda: paged_decode(*big))
    kb_parts = kernel_parts(lambda: paged_decode(*big))
    pb_dev, _ = device_ms(lambda: ref.paged_decode_ref(*big), iters=10)
    bb_ms, _ = paged_bound(big[0], big[1], big[3], big[4])
    print(f"[{card}] paged_decode bf16 lens={lens}: "
          f"{split_note(big[0], big[1], big[3], big[4])[0]}; kernel "
          f"{kb_ms * 1e3:.1f} us, plain {pb_ms * 1e3:.1f} us (events; "
          f"device time: kernel {kb_dev * 1e3:.1f} us ("
          + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in kb_parts.items())
          + f"), plain {pb_dev * 1e3:.1f} us), bound {bb_ms * 1e3:.2f} us",
          flush=True)
    # paged_verify at the captured verify step and at the phase 3 lens
    ver_t = timing(ms=device_ms(lambda: paged_verify(*v_args)),
                   plain_ms=device_ms(lambda: ref.paged_verify_ref(*v_args),
                                      iters=20))
    vk_ms, vp_ms = ver_t["ms"], ver_t["plain_ms"]
    v_how = ver_t["timed_by"]["ms"]
    vk_ev = cuda_ms(lambda: paged_verify(*v_args))
    vb_ms, vb_by = verify_bound(v_args[0], v_args[1], v_args[3], v_args[4])
    print(f"[{card}] paged_verify at the captured verify step "
          f"(B={v_args[0].shape[0]}, Q={v_args[0].shape[1]}, "
          f"NPG={v_args[3].shape[1]}, lens={v_args[4].tolist()}): "
          f"{split_note(v_args[0], v_args[1], v_args[3], v_args[4])[0]}",
          flush=True)
    print(f"[{card}] paged_verify at the captured verify step: kernel "
          f"{vk_ms * 1e3:.1f} us ({v_how}, split and combine; CUDA events "
          f"over back-to-back wrapper calls {vk_ev * 1e3:.1f} us), plain "
          f"{vp_ms * 1e3:.1f} us, bound {vb_ms * 1e3:.2f} us ({vb_by}), "
          f"{cfg.n_layers} launches per spec dispatch", flush=True)
    big_v = kernel_inputs(torch.bfloat16, v_lens, seed=5, Q=SPEC_K + 1)
    vkb_ms, vkb_how = device_ms(lambda: paged_verify(*big_v))
    vpb_ms, _ = device_ms(lambda: ref.paged_verify_ref(*big_v), iters=10)
    vbb_ms, vbb_by = verify_bound(big_v[0], big_v[1], big_v[3], big_v[4])
    print(f"[{card}] paged_verify bf16 Q={SPEC_K + 1} lens={v_lens}: "
          f"{split_note(big_v[0], big_v[1], big_v[3], big_v[4])[0]}; kernel "
          f"{vkb_ms * 1e3:.1f} us ({vkb_how}), plain {vpb_ms * 1e3:.1f} us, "
          f"bound {vbb_ms * 1e3:.2f} us ({vbb_by})", flush=True)
    del big_v
    # the speculative step against the plain one, batch 8, one after the
    # other on this card
    step_t = [(label, *decode_profile(e, card, label, GenRequest,
                                      SamplingParams, rng)[:2])
              for label, e in (("plain decode", eng),
                               ("spec, drafter = target", spec_a["eng"]),
                               ("spec, 2-layer drafter", spec_b["eng"]))]
    print(f"[{card}] decode step at batch 8 (200-token prompts, spec_k="
          f"{SPEC_K}): " + "; ".join(
              f"{label} {ms:.2f} ms/step, {tps:.1f} tok/s"
              for label, ms, tps in step_t), flush=True)

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

    dense_t = time_dense_kernels(card, dense)

    copy_launches = {"gather": host_launches[0] + router_launches[0],
                     "scatter": host_launches[1] + router_launches[1]}
    rows = [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:122",
        "launches": launches, "max_abs_err": main_err, **dec_t,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}, {
        "name": "paged_verify", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_verify.cu",
        "replaces": "src/repro/kernels/paged_verify.py:130",
        "launches": spec_a["launches"][0] + spec_b["launches"][0],
        "max_abs_err": v_err, **ver_t, "bound_ms": vb_ms, "bound_by": vb_by,
        "library_ms": None}]
    for name, line in (("gather", 52), ("scatter", 86)):
        r = copy_t[16][name]
        rows.append({
            "name": f"page_{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/page_copy.cu",
            "replaces": f"src/repro/kernels/page_copy.py:{line}",
            "launches": copy_launches[name], "max_abs_err": copy_err,
            **timing(ms=r["kernel"], plain_ms=r["plain"],
                     library_ms=r["library"]),
            "bound_ms": copy_t[16]["bound"], "bound_by": "bytes",
            "shape": f"N=16 pages of bf16 pools {list(POOL)}"})
    H, K, hd, sH, P, N, G, chunk = dense["full"]
    rows += [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": dense["launches"]["flash"],
        "max_abs_err": dense["flash_err"][str(torch.bfloat16)],
        **dense_t[str(torch.bfloat16)],
        "shape": f"bf16 q (1, {H}, 2048, {hd}), k/v (1, {K}, 2048, {hd}), "
                 f"causal"}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:86",
        "launches": dense["launches"]["ssd"],
        "max_abs_err": dense["ssd_err"][chunk], **dense_t["ssd"],
        "library_ms": None,
        "shape": f"fp32 x (2, {sH}, 2048, {P}), B/C (2, {G}, 2048, {N}), "
                 f"chunk {chunk}"}]
    for row in rows[:4]:                  # the four kernels of 4e's path
        row["moe"] = moe_rows[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def decode_profile(eng, card, label, GenRequest, SamplingParams,
                   rng, on_steady=None) -> tuple:
    """Where a steady decode step's time goes, at a full batch (8
    sequences of 200-token prompts): the wall time and the tokens emitted
    in four steps, then torch.profiler (device activity only) over the
    next four; `on_steady(eng)`, when given, runs after them, before the
    requests are cancelled. Prints the device's busy time per step against
    the unprofiled wall and the top kernels' time per step. Returns (ms
    per step, tokens per second, device-busy ms per step, and the paged
    kernels' device ms per step by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    vocab = eng.cfg.vocab
    reqs = [GenRequest(prompt_tokens=tuple(
        rng.integers(0, vocab, size=200).tolist()),
        sampling=SamplingParams(max_new_tokens=64)) for _ in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.step()                              # admit + prefill
    eng.step()                              # first decode: uploads state
    n0 = sum(len(s.out) for s in eng.core.running)
    steps = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    n = sum(len(s.out) for s in eng.core.running) - n0
    if len(eng.core.running) != 8:
        fail(f"{label} profile: {len(eng.core.running)} sequences running, "
             f"not 8")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    if on_steady is not None:
        on_steady(eng)
    for r in reqs:
        eng.cancel(r.rid)
    events = device_events(prof)
    busy = sum(dev_us(e) for e in events) / 1e6 / steps      # s per step
    print(f"[{card}] {label} profile, batch 8: wall {1e3 * wall:.2f} ms/step "
          f"(unprofiled), {n / steps / 8:.2f} tokens per sequence-step, "
          f"{n / wall / steps:.1f} tok/s; device busy "
          + (f"{1e3 * busy:.2f} ms/step = {100 * busy / wall:.1f}% of the "
             f"wall" if busy else
             "not measured (the profiler saw no device time)"), flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"[{card}]   {dev_us(e) / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d}/step  {e.key[:80]}", flush=True)
    # the combine is one kernel template for both: Q = 1 fixed (decode's)
    # or Q at run time (verify's)
    paged = {}
    for kernel, keys in (("paged_verify (split + combine)",
                          r"paged_verify|split_combine_kernel<[^>]*false>"),
                         ("paged_decode (split + combine)",
                          r"paged_decode|split_combine_kernel<[^>]*true>")):
        mine = [e for e in events if re.search(keys, e.key)]
        paged[kernel.split()[0]] = sum(map(dev_us, mine)) / 1e3 / steps
        if mine:
            parts = ", ".join(
                f"{re.search(r'(\w+)<', e.key).group(1)} "
                f"{dev_us(e) / 1e3 / steps:.3f}" for e in mine)
            print(f"[{card}]   {label}: {kernel} "
                  f"{sum(map(dev_us, mine)) / 1e3 / steps:.3f} ms/step "
                  f"({parts}) over {sum(e.count for e in mine) // steps} "
                  f"kernel launches per step", flush=True)
    return 1e3 * wall, n / wall / steps, 1e3 * busy, paged


def _to(tree: dict, device: str) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}



if __name__ == "__main__":
    sys.exit(main())
