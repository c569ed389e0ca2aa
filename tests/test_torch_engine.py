"""Engine parity: the port's `Engine(..., device="cpu")` gives the JAX
`Engine`'s token streams on the hot-path MIXED workload for both reduced
models; its own hot-path invariants hold (bucketed == exact, packed ==
sequential, chunked prefill, no upload in steady state, bounded decode
shapes); `ReplicaCore` + `TorchPagedBackend` makes the decision stream
`JaxPagedBackend` makes on the replica-parity trace; and the entry points
refuse what the port does not carry yet."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model
from repro.replica import ReplicaCore as JaxReplicaCore
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import GenRequest as JaxGenRequest
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving.bucketing import n_buckets
from repro.serving.jax_backend import JaxPagedBackend
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import init_params
from repro_torch.replica import ReplicaCore, ReplicaCoreConfig
from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                 SamplingParams, TorchPagedBackend)

import test_replica_parity as rp
from test_serving_hotpath import MIXED

ECFG = dict(page_size=8, n_pages=64, max_batch=4, max_seq_len=256,
            prefill_pad=16)


@pytest.fixture(scope="module")
def llama_model_params():
    cfg = jax_config("llama31-8b").reduced()
    return cfg, build_model(cfg, jnp.float32).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_qwen(qwen_model_params):
    _, params = qwen_model_params
    cfg = get_config("qwen3-0.6b").reduced()
    return cfg, from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                "cpu", torch.float32)


def _reqs(R, SP, vocab, specs, seed=0):
    rng = np.random.default_rng(seed)
    return [R(prompt_tokens=tuple(rng.integers(0, vocab, size=n).tolist()),
              sampling=SP(**kw)) for n, kw in specs]


def _torch_run(cfg, params, specs, **kw):
    eng = Engine(cfg, params, EngineConfig(**{**ECFG, **kw}), seed=0,
                 device="cpu")
    res = eng.generate(_reqs(GenRequest, SamplingParams, cfg.vocab, specs))
    return [r.output_tokens for r in res]


@pytest.mark.parametrize("name", ["qwen3-0.6b", "llama31-8b"])
def test_token_streams_match_jax_engine(name, request):
    """Greedy, temperature and top-k rows: identical token streams, same
    finish reasons and cached-token counts."""
    if name == "qwen3-0.6b":
        jcfg, (_, jp) = (request.getfixturevalue("qwen_reduced"),
                         request.getfixturevalue("qwen_model_params"))
    else:
        jcfg, jp = request.getfixturevalue("llama_model_params")
    jres = JaxEngine(jcfg, jp, JaxEngineConfig(**ECFG), seed=0).generate(
        _reqs(JaxGenRequest, JaxSamplingParams, jcfg.vocab, MIXED))
    tcfg = get_config(name).reduced()
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                         torch.float32)
    tres = Engine(tcfg, tp, EngineConfig(**ECFG), seed=0,
                  device="cpu").generate(
        _reqs(GenRequest, SamplingParams, tcfg.vocab, MIXED))
    assert [r.output_tokens for r in tres] == [r.output_tokens for r in jres]
    assert [(r.finish_reason.value, r.cached_tokens) for r in tres] == \
        [(r.finish_reason.value, r.cached_tokens) for r in jres]


@pytest.mark.parametrize("variant", ["bucketed_vs_exact",
                                     "packed_vs_sequential",
                                     "chunked_prefill"])
def test_hot_path_invariants(torch_qwen, variant):
    cfg, params = torch_qwen
    if variant == "bucketed_vs_exact":
        a = _torch_run(cfg, params, MIXED, bucket_shapes=True)
        b = _torch_run(cfg, params, MIXED, bucket_shapes=False)
        assert a == b
    elif variant == "packed_vs_sequential":
        a = _torch_run(cfg, params, MIXED, packed_prefill=True)
        b = _torch_run(cfg, params, MIXED, packed_prefill=False)
        assert a == b
    else:
        specs = [(40, dict(max_new_tokens=4)),
                 (25, dict(max_new_tokens=4, temperature=0.8, top_k=5)),
                 (33, dict(max_new_tokens=3))]
        a = _torch_run(cfg, params, specs, prefill_chunk=16)
        b = _torch_run(cfg, params, specs, packed_prefill=False,
                       prefill_chunk=16)
        c = _torch_run(cfg, params, specs)
        assert a == b == c


def test_steady_state_uploads_nothing_and_shapes_stay_bounded(torch_qwen):
    cfg, params = torch_qwen
    eng = Engine(cfg, params, EngineConfig(**ECFG), device="cpu")
    events = []
    for r in _reqs(GenRequest, SamplingParams, cfg.vocab,
                   [(10, dict(max_new_tokens=20)),
                    (14, dict(max_new_tokens=20))]):
        r.on_token = lambda req, tok, idx, t: events.append((req.rid, idx))
        eng.submit(r)
    eng.step()                                  # admits both (prefill only)
    eng.step()                                  # first decode -> sync
    syncs = {"n": 0}
    orig = eng.backend._sync_slots

    def counting(seqs):
        syncs["n"] += 1
        return orig(seqs)

    eng.backend._sync_slots = counting
    for _ in range(10):
        eng.step()
    assert syncs["n"] == 0                      # membership never changed
    eng.run_until_idle()
    assert eng.completions == 2 and len(events) == 40
    # a varied workload runs a bounded set of (batch, pages) decode shapes
    rng = np.random.default_rng(9)
    specs = [(int(n), dict(max_new_tokens=int(m)))
             for n, m in zip(rng.integers(5, 60, size=10),
                             rng.integers(3, 12, size=10))]
    eng.generate(_reqs(GenRequest, SamplingParams, cfg.vocab, specs, seed=9))
    bound = n_buckets(ECFG["max_batch"]) * n_buckets(
        -(-ECFG["max_seq_len"] // ECFG["page_size"]))
    assert 0 < len(eng.backend.decode_buckets) <= bound


def test_replica_decisions_match_jax_backend(qwen_reduced, qwen_model_params,
                                             torch_qwen):
    """`tests/test_replica_parity.py`'s trace (preemption, prefix caching,
    eviction, rejection, cancellation): byte-identical decision streams."""
    _, jparams = qwen_model_params
    tcfg, tparams = torch_qwen
    trace = rp._trace(qwen_reduced.vocab)
    CFG = rp.CFG

    jb = JaxPagedBackend(qwen_reduced, jparams, n_pages=CFG.n_pages,
                         page_size=CFG.page_size, prefill_pad=16)
    jcore = JaxReplicaCore(CFG, jb)
    jb.bind(jcore)
    jcached = rp._drive(jcore, trace)

    tb = TorchPagedBackend(tcfg, tparams, n_pages=CFG.n_pages,
                           page_size=CFG.page_size, device="cpu",
                           prefill_pad=16)
    tcore = ReplicaCore(ReplicaCoreConfig(**dataclasses.asdict(CFG)), tb)
    tb.bind(tcore)
    tcached = _drive_torch(tcore, trace)

    assert tcore.decisions == jcore.decisions
    assert repr(tcore.decisions).encode() == repr(jcore.decisions).encode()
    assert tcached == jcached
    kinds = {e[0] for e in tcore.decisions}
    assert kinds == {"admit", "evict", "reject", "preempt", "cancel"}
    assert tcore.completions == jcore.completions == 6
    assert tcore.total_cached_tokens == jcore.total_cached_tokens


def _drive_torch(core, trace: dict) -> dict:
    """`test_replica_parity._drive` with the port's request types."""
    cached: dict[int, int] = {}
    for step in range(rp.N_STEPS):
        for rid, prompt, max_new, prio in trace.get(step, ()):
            core.submit(GenRequest(
                prompt_tokens=prompt, rid=rid, priority=prio,
                sampling=SamplingParams(max_new_tokens=max_new)))
        for rid in rp.CANCELS.get(step, ()):
            assert core.cancel(rid) is not None
        plan = core.begin_step()
        for seq in plan.admitted:
            cached[seq.req.rid] = seq.req.cached_tokens
        core.finish_step()
    return cached


# ------------------------------------------------------------ entry points

def test_engine_needs_cuda_unless_asked_for_cpu(torch_qwen):
    cfg, params = torch_qwen
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, device="cuda")
    with pytest.raises(ValueError, match="params live on"):
        Engine(cfg, init_params(cfg, torch.float32, "meta"), device="cpu")


@pytest.mark.parametrize("what", ["spec_k", "host_pages", "moe"])
def test_unported_paths_raise(torch_qwen, what):
    """MoE is refused. The host KV tier and speculation, each refused until
    its slice landed, are now accepted: the tier allocates its host mirror;
    speculation without a drafter raises ValueError, as the JAX backend
    does, and with one the backend builds the drafter's pools."""
    cfg, params = torch_qwen
    if what == "spec_k":
        with pytest.raises(ValueError, match="draft"):
            Engine(cfg, params, EngineConfig(**{what: 2}), device="cpu")
        eng = Engine(cfg, params, EngineConfig(**{what: 2}), draft_cfg=cfg,
                     draft_params=params, device="cpu")
        be = eng.backend
        assert be.spec_k == 2
        assert be.dk_pages.shape == be.dv_pages.shape == be.k_pages.shape
        assert be.dk_pages.dtype == be.k_pages.dtype
        assert be.dk_pages.data_ptr() != be.k_pages.data_ptr()
        return
    if what == "host_pages":
        eng = Engine(cfg, params, EngineConfig(**{what: 2}), device="cpu")
        assert eng.core.cfg.host_pages == 2
        assert eng.backend._h_k.shape == (2,) + eng.backend.k_pages.shape[:1] \
            + eng.backend.k_pages.shape[2:]
        return
    if what == "moe":
        moe = get_config("granite-moe-1b-a400m").reduced()
        with pytest.raises(NotImplementedError, match="MoE"):
            Engine(moe, params, device="cpu")
        with pytest.raises(NotImplementedError, match="MoE"):
            init_params(moe, torch.float32, "cpu")
