#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `src/repro_torch/kernels/csrc` (nvcc) and
     print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card at
     Llama-3.1-8B decode shapes, ragged lengths and garbage block tables;
  4. serve multi-turn sessions that share prefixes through the port's
     `Engine` on full-width Llama-3.1-8B (random bf16 weights from a seeded
     generator, all 32 layers), check every request's result, the prefix
     cache and the kernel launch counts, then hold the kernel against its
     plain version on one decode step's captured inputs;
  5. check the engine's tokens against its plain CPU path on a small
     fp32 model;
  6. print measurements (engine throughput, a profile of steady decode
     steps, kernel time beside its bound and the plain version's time)
     with the card's name and power limit,
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
from pathlib import Path

DEVICE = "cuda"
MODEL = "llama31-8b"               # the paper's serving model, full width
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
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.models import init_params, param_count
    from repro_torch.serving import (Engine, EngineConfig, FinishReason,
                                     GenRequest, SamplingParams)

    # fp32 products in full fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path, nvcc_s = build.compile_library("paged_decode")
    print(f"build: paged_decode.cu -> {lib_path.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {nvcc_s:.2f} s)",
          flush=True)

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

    for r in res1 + res2:
        if r.finish_reason not in (FinishReason.LENGTH, FinishReason.STOP):
            fail(f"request {r.rid} ended {r.finish_reason} ({r.error})")
        if not r.output_tokens or not all(0 <= t < cfg.vocab
                                          for t in r.output_tokens):
            fail(f"request {r.rid}: bad tokens {r.output_tokens[:8]}")
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
    print(json.dumps({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:122",
        "launches": launches, "max_abs_err": main_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]}), flush=True)
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
    from torch.autograd import DeviceType
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

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # kernels only: an operator's entry repeats the device time of the
    # kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
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
