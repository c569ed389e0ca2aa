"""Alternating A/B of the port's paged attention wrappers between source
trees on one CUDA card: the host time of one `paged_decode` wrapper call,
the device time of `paged_decode` and `paged_verify` (each kernel apart),
and the wall of a plain decode step at batch 8 (Llama-3.1-8B at full
width, random bf16 weights, 200-token prompts).

    python3 scripts/torch_paged_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository whose `src/` is imported; each
runs in a process of its own, in the order given, so give them in turns
(A B B A) to see the card's and the host's drift. Every ROOT's kernels are
first held against the plain versions (chip_smoke.TOL). Prints one JSON
line per ROOT, then the card's name and power limit. The input helpers
are this checkout's `chip_smoke.py`; the paged attention wrappers keep
their signatures across the trees compared.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
DECODE_LENS = [315, 322, 331, 339]     # a captured decode step, NPG 32
VERIFY_LENS = [318, 327, 338, 348]     # a captured verify step, Q = 4
LONG_LENS = [1, 16, 17, 32, 100, 1000, 2048, 3001]   # chip_smoke phase 3's
VERIFY_LONG = [4, 16, 17, 32, 33, 100, 1000, 3001]


def host_us(fn, n: int = 2000, rounds: int = 5) -> float:
    """Host time of one call of fn in us, the device running behind: the
    median wall over n calls, the least over `rounds` rounds (a shared
    host's waits inflate some rounds)."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    medians = []
    for _ in range(rounds):
        w = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            w.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        medians.append(statistics.median(w))
    return 1e6 * min(medians)


def kernels_us(fn, iters: int = 50) -> dict:
    """Device us per call of each kernel fn launches (torch.profiler)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"(\w+)(<[^(]*>)?\(", e.key).group(0)[:-1]:
            chip_smoke.dev_us(e) / iters
            for e in chip_smoke.device_events(prof)}


def step_walls(n: int = 48) -> list[float]:
    """ms of each of n plain decode steps at batch 8, after two steps that
    admit, prefill and upload state."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                     SamplingParams)
    cfg = get_config("llama31-8b")
    params = init_params(cfg, torch.bfloat16, "cuda",
                         torch.Generator(device="cuda").manual_seed(0))
    eng = Engine(cfg, params, EngineConfig(page_size=16, n_pages=1024,
                                           max_batch=8, max_seq_len=2048),
                 seed=0, device="cuda")
    rng = np.random.default_rng(0)
    for r in [GenRequest(prompt_tokens=tuple(
            rng.integers(0, cfg.vocab, size=200).tolist()),
            sampling=SamplingParams(max_new_tokens=n + 8))
            for _ in range(8)]:
        eng.submit(r)
    eng.step()
    eng.step()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    if len(eng.core.running) != 8:
        raise SystemExit(f"{len(eng.core.running)} sequences running, not 8")
    return walls


def one(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import paged_decode as pd_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_verify import paged_verify
    if not Path(pd_mod.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {pd_mod.__file__}, not from {root}")
    paged_decode = pd_mod.paged_decode
    dec = chip_smoke.kernel_inputs(torch.bfloat16, DECODE_LENS, seed=1,
                                   npg=32)
    dec_long = chip_smoke.kernel_inputs(torch.bfloat16, LONG_LENS, seed=2)
    ver = chip_smoke.kernel_inputs(torch.bfloat16, VERIFY_LENS, seed=3,
                                   Q=4, npg=32)
    ver_long = chip_smoke.kernel_inputs(torch.bfloat16, VERIFY_LONG, seed=4,
                                        Q=4)
    tol = chip_smoke.TOL[str(torch.bfloat16)]
    for name, fn, plain, args in (
            ("paged_decode", paged_decode, ref.paged_decode_ref, dec),
            ("paged_decode", paged_decode, ref.paged_decode_ref, dec_long),
            ("paged_verify", paged_verify, ref.paged_verify_ref, ver),
            ("paged_verify", paged_verify, ref.paged_verify_ref, ver_long)):
        got, want = fn(*args).float(), plain(*args).float()
        err = (got - want).abs().max().item()
        if not err <= tol:
            raise SystemExit(f"{name} max|err| {err:.3e} > {tol} in {root}")
    host = host_us(lambda: paged_decode(*dec))
    walls = step_walls()
    return {"root": str(root),
            "paged_decode_host_us": host,
            "device_us": {
                "decode_captured": kernels_us(lambda: paged_decode(*dec)),
                "decode_long": kernels_us(lambda: paged_decode(*dec_long)),
                "verify_captured": kernels_us(lambda: paged_verify(*ver)),
                "verify_long": kernels_us(lambda: paged_verify(*ver_long))},
            "plain_step_ms": {"median": statistics.median(walls),
                              "min": min(walls), "max": max(walls)}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_paged_ab: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(Path(sys.argv[2]))), flush=True)
        return 0
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    sys.path.insert(0, str(HERE))
    import chip_smoke
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
