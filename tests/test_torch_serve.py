"""The port's front API and serve CLI against the JAX package's.

`Client(SimHost(ServingSystem(...)))` (the copies of `frontend/` and
`core/`) gives the same event stream as the originals on one seed;
`EngineHost` and `RouterHost` over torch engines give the tokens the same
hosts give over JAX engines with the converted weights; the port's
`serve_single` and `serve_multiregion` (`device="cpu"`, 24 requests of 8
new tokens) give the JAX launcher's request count, engine steps, hit rates
and forwards on a dense and an MoE reduced config, with the JAX weights
converted into the port. The launcher needs CUDA unless asked for the CPU,
refuses `--procs`, and `ProcessHost` waits for the plane slice."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.frontend as jfront
from repro.configs import get_config as jax_config
from repro.core.simulator import ReplicaConfig as JaxReplicaConfig
from repro.core.system import ServingSystem as JaxServingSystem
from repro.launch import serve as jserve
from repro.models import build_model
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import GenRequest as JaxGenRequest
from repro.serving import InProcessRouter as JaxRouter
from repro.serving import SamplingParams as JaxSamplingParams
import repro_torch.frontend as tfront
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.simulator import ReplicaConfig
from repro_torch.core.system import ServingSystem
from repro_torch.launch import serve as tserve
from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                 InProcessRouter, SamplingParams)

N_REQ, MAX_NEW = 24, 8
ECFG = dict(page_size=8, n_pages=64, max_batch=4, max_seq_len=256,
            prefill_pad=16)


def _stream(h) -> tuple:
    res = h.result
    return (h.state.value, tuple((e.index, e.token, e.t) for e in h.events),
            res.finish_reason.value if res else None,
            res.output_tokens if res else None,
            (res.ttft_s, res.e2e_s) if res else None)


def _sim_run(front, System, RCfg, R, SP) -> list:
    """Six requests over two regions (two sessions sharing prefixes, one
    with predetermined tokens), one cancelled mid-stream, one past its
    deadline at submit; every handle's state, events and result."""
    client = front.Client(front.SimHost(System(
        "skylb", {"us": 2, "eu": 1}, replica_cfg=RCfg(kv_budget=8192),
        seed=0)))
    rng = np.random.default_rng(4)
    base = tuple(int(t) for t in rng.integers(1, 500, 40))
    handles = []
    for i in range(6):
        prompt = base[:20 + 4 * i] + tuple(int(t) for t in
                                           rng.integers(1, 500, 6))
        kw = dict(deadline_s=-1.0) if i == 5 else {}
        out = tuple(range(300, 310)) if i == 1 else ()
        handles.append(client.submit(
            R(prompt_tokens=prompt, user_id=f"u{i % 2}",
              session_key=f"u{i % 2}",
              sampling=SP(max_new_tokens=10), **kw),
            region=("us", "eu")[i % 3 == 2], output_tokens=out))
    for _ in range(40):
        client.poll()
    handles[3].cancel()
    client.drain()
    return [_stream(h) for h in handles]


def test_sim_host_event_stream_matches_jax_package():
    got = _sim_run(tfront, ServingSystem, ReplicaConfig, GenRequest,
                   SamplingParams)
    want = _sim_run(jfront, JaxServingSystem, JaxReplicaConfig,
                    JaxGenRequest, JaxSamplingParams)
    assert got == want
    states = [s[0] for s in got]
    assert states.count("finished") == 4
    assert "cancelled" in states and "deadline" in states


@pytest.fixture(scope="module")
def qwen_pair(qwen_reduced, qwen_model_params):
    _, jp = qwen_model_params
    tcfg = get_config("qwen3-0.6b").reduced()
    return (qwen_reduced, jp, tcfg,
            from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                            torch.float32))


def _host_tokens(front, host: str, make_engine, Router, R, SP) -> list:
    if host == "engine":
        client = front.Client(front.EngineHost(make_engine()))
    else:
        router = Router()
        for region in ("us", "eu"):
            router.add_region(region).add_engine(f"{region}-e0",
                                                 make_engine())
        client = front.Client(front.RouterHost(router))
    rng = np.random.default_rng(8)
    handles = [client.submit(R(
        prompt_tokens=tuple(int(t) for t in rng.integers(1, 500, 9 + 5 * i)),
        sampling=SP(max_new_tokens=5, temperature=0.8 * (i % 2), seed=i)),
        region=("us", "eu")[i % 2]) for i in range(5)]
    client.drain()
    return [(h.state.value, h.tokens, h.result.output_tokens)
            for h in handles]


@pytest.mark.parametrize("host", ["engine", "router"])
def test_engine_and_router_hosts_match_jax(qwen_pair, host):
    jcfg, jp, tcfg, tp = qwen_pair
    got = _host_tokens(tfront, host, lambda: Engine(
        tcfg, tp, EngineConfig(**ECFG), device="cpu"), InProcessRouter,
        GenRequest, SamplingParams)
    want = _host_tokens(jfront, host, lambda: JaxEngine(
        jcfg, jp, JaxEngineConfig(**ECFG)), JaxRouter, JaxGenRequest,
        JaxSamplingParams)
    assert got == want
    assert all(s == "finished" and len(t) == 5 for s, t, _ in got)


WALL = ("wall_s", "tok_per_s", "ttft_p50_s")


@pytest.mark.parametrize("mode", ["single", "multiregion"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b-reduced",
                                  "granite-moe-1b-a400m-reduced"])
def test_cli_matches_jax_launcher(monkeypatch, arch, mode):
    """The JAX launcher's fp32 `PRNGKey(0)` weights go into the port's
    launcher; every count of the result dict agrees (the wall-clock
    entries are only checked to be there)."""
    jcfg = jax_config(arch)
    jp = build_model(jcfg, jnp.float32).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config(arch),
                         "cpu", torch.float32)
    monkeypatch.setattr(tserve, "init_weights", lambda cfg, device: tp)
    if mode == "single":
        want = jserve.serve_single(arch, N_REQ, MAX_NEW)
        got = tserve.serve_single(arch, N_REQ, MAX_NEW, device="cpu")
    else:
        want = jserve.serve_multiregion(arch, N_REQ, MAX_NEW)
        got = tserve.serve_multiregion(arch, N_REQ, MAX_NEW, device="cpu")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in WALL} == \
        {k: v for k, v in want.items() if k not in WALL}
    assert got["requests"] == N_REQ
    rates = ([got["hit_rate"]] if mode == "single" else
             [r for lb in got["hit_rates"].values() for r in lb.values()])
    assert max(rates) > 0


def test_cli_entry_points_refuse():
    """`--device` unset means the card, which this machine lacks; `--procs`
    (the socket plane) raises until the plane slice lands; so does
    `repro_torch.frontend.ProcessHost`."""
    with pytest.raises(NotImplementedError, match="plane"):
        tserve.main(["--procs", "--device", "cpu"])
    with pytest.raises(ModuleNotFoundError, match="repro_torch.plane"):
        tfront.ProcessHost
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--requests", "2", "--max-new", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve_multiregion("qwen3-0.6b-reduced", 2, 2)


@pytest.mark.parametrize("argv", [["--regions", "us,eu"],
                                  ["--replicas", "2"],
                                  ["--multiregion", "--regions", "us"]])
def test_cli_plane_options_refuse(argv):
    """`--regions` and `--replicas` configure only the plane, so either one
    raises as `--procs` does instead of being ignored."""
    with pytest.raises(NotImplementedError, match=argv[-2]):
        tserve.main(argv + ["--device", "cpu"])


def test_cli_main_runs_on_the_cpu(capsys):
    out = tserve.main(["--device", "cpu", "--arch",
                       "granite-moe-1b-a400m-reduced", "--requests", "6",
                       "--max-new", "3", "--multiregion"])
    assert out["requests"] == 6
    assert str(out) in capsys.readouterr().out
