"""Serving launcher over the port's torch engines (PyTorch port of
`repro.launch.serve`): the paged continuous-batching engine on one model
with batched multi-turn requests, single replica, or the two-layer SkyLB
router over several in-process replicas across simulated regions. Both
modes drive the unified front API (`repro_torch.frontend.Client`): submit
returns a streaming `RequestHandle`, and the reported TTFT comes from each
request's first TokenEvent, not from the terminal result.

Weights are fp32 from the port's seeded init (seed 0), as the JAX launcher
builds fp32 params from `PRNGKey(0)`; the draws differ from `jax.random`'s.
The engines run on the card unless `--device cpu` asks for the CPU.

The multi-process socket plane (`--procs`, with its `--regions` and
`--replicas`) is not ported yet and raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch granite-moe-1b-a400m-reduced --requests 24 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --multiregion \\
      --variant skylb --arch granite-moe-1b-a400m
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.frontend import Client, EngineHost, RequestState, RouterHost
from repro_torch.models import init_params
from repro_torch.routing import build_routing
from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                 InProcessRouter, SamplingParams)
from repro_torch.serving.engine import resolve_device

REGIONS = ("us", "eu", "asia")


def make_requests(vocab: int, n: int, *, sessions: int = 6,
                  turns: int = 2, max_new: int = 16, seed: int = 0):
    """Multi-turn style requests: `sessions` users, each turn extends the
    previous prompt (prefix-shareable)."""
    rng = np.random.default_rng(seed)
    reqs, histories = [], {}
    for i in range(n):
        u = i % sessions
        hist = histories.get(u, tuple(rng.integers(1, vocab, size=24).tolist()))
        new = tuple(rng.integers(1, vocab, size=int(rng.integers(8, 24))).tolist())
        prompt = hist + new
        reqs.append(GenRequest(
            prompt_tokens=prompt, user_id=f"u{u}", session_key=f"u{u}",
            sampling=SamplingParams(max_new_tokens=max_new)))
        histories[u] = prompt + tuple(int(x) for x in
                                      rng.integers(1, vocab, size=max_new))
    return reqs


def _drain_and_stats(client: Client, handles: list) -> dict:
    t0 = time.time()
    client.drain()
    dt = time.time() - t0
    done = [h for h in handles if h.state is RequestState.FINISHED]
    out_toks = sum(len(h.result.output_tokens) for h in done)
    # client-observed TTFT: submission -> first streamed TokenEvent
    ttfts = [h.events[0].t - h.request.arrival_s for h in done
             if h.events and h.request.arrival_s is not None]
    return {"requests": len(done), "wall_s": round(dt, 2),
            "tok_per_s": round(out_toks / dt, 1),
            "ttft_p50_s": round(statistics.median(ttfts), 3) if ttfts
            else None}


def init_weights(cfg, device: torch.device) -> dict:
    """The launcher's fp32 weights for `cfg`, seed 0, made on `device`."""
    return init_params(cfg, torch.float32, device,
                       torch.Generator(device=device).manual_seed(0))


def serve_single(arch: str, n_requests: int, max_new: int,
                 device: Optional[str] = None) -> dict:
    dev = resolve_device(device)
    cfg = get_config(arch)
    eng = Engine(cfg, init_weights(cfg, dev),
                 EngineConfig(page_size=8, n_pages=256, max_batch=8,
                              max_seq_len=1024, prefill_pad=32),
                 device=dev.type)
    client = Client(EngineHost(eng))
    handles = [client.submit(r)
               for r in make_requests(cfg.vocab, n_requests, max_new=max_new)]
    out = _drain_and_stats(client, handles)
    out.update({"hit_rate": round(eng.hit_rate(), 3),
                "engine_steps": eng.steps})
    return out


def serve_multiregion(arch: str, n_requests: int, max_new: int,
                      variant: str = "skylb",
                      device: Optional[str] = None) -> dict:
    dev = resolve_device(device)
    cfg = get_config(arch)
    params = init_weights(cfg, dev)
    # the same build_routing() spec the simulator's ServingSystem uses
    router = InProcessRouter.from_spec(build_routing(variant))
    for region in REGIONS:
        lb = router.add_region(region)
        for k in range(2):
            lb.add_engine(f"{region}-r{k}", Engine(
                cfg, params, EngineConfig(page_size=8, n_pages=128,
                                          max_batch=4, max_seq_len=1024,
                                          prefill_pad=32),
                device=dev.type))
    client = Client(RouterHost(router))
    reqs = make_requests(cfg.vocab, n_requests, max_new=max_new)
    # skew arrivals: most load lands on 'us' (the diurnal-peak region)
    handles = [client.submit(req,
                             region="us" if i % 4 < 2 else REGIONS[i % 3])
               for i, req in enumerate(reqs)]
    out = _drain_and_stats(client, handles)
    out["forwarded"] = {r: lb.forwarded_out for r, lb in router.lbs.items()}
    out["hit_rates"] = {
        r: {e: round(lb.engines[e].hit_rate(), 3) for e in lb.engines}
        for r, lb in router.lbs.items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b-reduced")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--multiregion", action="store_true")
    ap.add_argument("--procs", action="store_true",
                    help="multi-process socket plane (not ported yet)")
    # --procs's own options; they configure nothing else, so they raise
    # with it until the plane is ported
    ap.add_argument("--regions", default=None,
                    help="--procs: comma-separated region list (us,eu)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="--procs: replica processes per region (2)")
    ap.add_argument("--variant", default="skylb",
                    help="routing variant (see repro_torch.routing.VARIANTS)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    plane = [f for f, on in (("--procs", args.procs),
                             ("--regions", args.regions is not None),
                             ("--replicas", args.replicas is not None)) if on]
    if plane:
        raise NotImplementedError(
            f"{', '.join(plane)}: the multi-process socket plane, which the "
            "port does not carry yet (repro_torch.plane, the plane slice)")
    if args.multiregion:
        out = serve_multiregion(args.arch, args.requests, args.max_new,
                                args.variant.lower(), device=args.device)
    else:
        out = serve_single(args.arch, args.requests, args.max_new,
                           device=args.device)
    print(out)
    return out


if __name__ == "__main__":
    main()
