"""Speculative decoding in the port against the JAX package's.

`spec_decode_step` on the same inputs gives JAX's target samples, accepted
counts, advanced batch state and KV pools (1e-4, page 0 excluded), with a
perfect drafter, with a small random drafter under the synthetic
acceptance coin, and with a row whose candidates cross the bucket horizon.
The engine mirrors `tests/test_speculative.py`: a perfect drafter gives the
non-speculative torch engine's and the JAX speculative engine's streams
byte for byte with acceptance 1.0; an adversarial drafter costs only
wasted drafts; multi-token steps stream in order; accept events reconcile
with the budget. `ReplicaCore` over the speculative `TorchPagedBackend`
makes `JaxPagedBackend(spec_k=3)`'s decision stream, with and without the
host tier, and the hot path keeps its invariants with speculation on."""
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
from repro.replica import ReplicaCoreConfig as JaxReplicaCoreConfig
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import GenRequest as JaxGenRequest
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving import model_runner as jmr
from repro.serving.bucketing import n_buckets
from repro.serving.jax_backend import JaxPagedBackend
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.replica import ReplicaCore, ReplicaCoreConfig
from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                 SamplingParams, TorchPagedBackend)
from repro_torch.serving import model_runner as tmr
from repro_torch.serving.sampling import fold_in, fold_key, prng_key, uniform

import test_replica_parity as rp
from test_torch_engine import _drive_torch

TOL = dict(atol=1e-4, rtol=1e-4)
K_SPEC = 3
ECFG = dict(page_size=8, n_pages=64, max_batch=4, max_seq_len=256,
            prefill_pad=16)
SPECS = [(10, dict(max_new_tokens=12)), (23, dict(max_new_tokens=7)),
         (17, dict(max_new_tokens=16, temperature=0.8, seed=5)),
         (5, dict(max_new_tokens=10, temperature=0.6, top_k=8, seed=9))]


def _to_torch(params, cfg):
    return from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu",
                           torch.float32)


def _small_drafter(jcfg, name):
    """`tests/test_speculative.py`'s random drafter: other dims, the
    target's vocab, its own seed."""
    dims = dict(name="drafter", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=1, d_ff=64, head_dim=16)
    jd = dataclasses.replace(jcfg, **dims)
    jdp = build_model(jd, jnp.float32).init(jax.random.PRNGKey(99))
    td = dataclasses.replace(get_config(name).reduced(), **dims)
    return jd, jdp, td, _to_torch(jdp, td)


@pytest.fixture(scope="module")
def torch_qwen(qwen_model_params):
    _, params = qwen_model_params
    cfg = get_config("qwen3-0.6b").reduced()
    return cfg, _to_torch(params, cfg)


@pytest.fixture(scope="module")
def drafter(qwen_reduced):
    return _small_drafter(qwen_reduced, "qwen3-0.6b")


# ------------------------------------------------------------- step parity

@pytest.fixture(scope="module", params=["qwen3-0.6b", "llama31-8b",
                                        "granite-moe-1b-a400m"])
def models(request):
    jcfg = jax_config(request.param).reduced()
    jp = build_model(jcfg, jnp.float32).init(jax.random.PRNGKey(0))
    tcfg = get_config(request.param).reduced()
    return request.param, jcfg, jp, tcfg, _to_torch(jp, tcfg)


PS, NP, SCRATCH = 8, 24, 0


def _pool(rng, cfg):
    shp = (cfg.n_layers, NP, PS, cfg.n_kv_heads, cfg.hd)
    return rng.normal(size=shp).astype(np.float32)


@pytest.mark.parametrize("mode", ["exact", "synth"])
def test_spec_decode_step_matches_jax(models, mode):
    """Two speculative steps over a 4-row bucket of an (8 x 8) capacity
    state: row 0 greedy, row 1 sampled and crossing the 4-page horizon
    (positions 32, 33 go to the scratch page), row 2 inactive, row 3
    top-k. `exact`: the drafter is the target on a copy of its pool, so
    every draft is accepted; `synth`: the small random drafter under
    `synth_rate=0.6`, whose coin decides acceptance."""
    name, jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(21)
    if mode == "exact":
        jd, jdp, td, tdp, rate = jcfg, jp, tcfg, tp, None
    else:
        jd, jdp, td, tdp = _small_drafter(jcfg, name)
        rate = 0.6
    pools = [_pool(rng, jcfg), _pool(rng, jcfg)]
    dpools = list(pools) if mode == "exact" else [_pool(rng, jd),
                                                  _pool(rng, jd)]
    bt = np.zeros((4, 8), np.int32)
    bt[0, :4], bt[1, :4], bt[3, :4] = [3, 4, 5, 6], [7, 8, 9, 10], \
        [11, 12, 13, 14]
    state = dict(bt=bt, lens=np.array([13, 30, 0, 5], np.int32),
                 toks=rng.integers(0, jcfg.vocab, size=4).astype(np.int32),
                 temps=np.array([0.0, 1.3, 0.0, 0.8], np.float32),
                 top_ks=np.array([0, 0, 0, 5], np.int32),
                 seeds=np.array([2, 7, 0, 3], np.int32))
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.tensor(v) for k, v in state.items()}
    jpools = [jnp.asarray(a) for a in pools + dpools]
    tpools = [torch.tensor(a) for a in pools + dpools]
    active = state["lens"] > 0
    kw = dict(page_size=PS, nb=4, npgb=4, k_spec=K_SPEC, synth_rate=rate)
    for _ in range(2):
        jT, jn, jstate, *jpools = jmr.spec_decode_step(
            jp, jdp, jstate, *jpools, jax.random.PRNGKey(0),
            jnp.int32(SCRATCH), cfg=jcfg, dcfg=jd, **kw)
        tT, tn, tstate, *tpools = tmr.spec_decode_step(
            tp, tdp, tstate, *tpools, prng_key(0), SCRATCH, cfg=tcfg,
            dcfg=td, **kw)
        assert tT.shape == (4, K_SPEC + 1) and tn.shape == (4,)
        assert tT.numpy()[active].tolist() == np.asarray(jT)[active].tolist()
        assert tn.numpy()[active].tolist() == np.asarray(jn)[active].tolist()
        for k in ("lens", "toks"):
            assert tstate[k].tolist() == np.asarray(jstate[k]).tolist()
        for t, j in zip(tpools, jpools):
            np.testing.assert_allclose(t[:, 1:].numpy(),
                                       np.asarray(j)[:, 1:], **TOL)
        if mode == "exact":
            assert tn.numpy()[active].tolist() == [K_SPEC] * 3
    if mode == "synth":
        # the coin both accepted and rejected somewhere
        assert 0 < int(tn[active].sum()) < 3 * K_SPEC


def test_synthetic_coin_matches_jax_scalar_uniform():
    """`jax.random.uniform(key)` of shape () draws the bits of counter 0,
    the first element of the port's `uniform(keys, n)`: the synthetic
    coin's keys and values agree bit for bit."""
    seeds = np.array([0, 7, 2 ** 31 - 1, 123456], np.int32)
    pos = np.array([1, 33, 5, 2 ** 20], np.int32)
    want = np.asarray(jax.vmap(lambda s, p: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(3), s), p), 7)))(seeds, pos))
    keys = fold_in(fold_key(prng_key(3), torch.tensor(seeds),
                            torch.tensor(pos)), torch.tensor(7))
    got = uniform(keys, 1)[:, 0].numpy()
    assert got.dtype == np.float32
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()


# ----------------------------------------------------------------- engine

def _reqs(R, SP, vocab, specs, seed=0):
    rng = np.random.default_rng(seed)
    return [R(prompt_tokens=tuple(int(t) for t in
                                  rng.integers(1, vocab, size=n)),
              sampling=SP(**kw)) for n, kw in specs]


def _run(cfg, params, ecfg, *, draft=None, events=None, specs=SPECS):
    dcfg, dparams = draft if draft is not None else (None, None)
    eng = Engine(cfg, params, ecfg, seed=0, draft_cfg=dcfg,
                 draft_params=dparams, device="cpu")
    reqs = _reqs(GenRequest, SamplingParams, cfg.vocab, specs)
    if events is not None:
        for r in reqs:
            r.on_token = (lambda req, tok, idx, t:
                          events.append((req.rid, tok, idx)))
    res = eng.generate(reqs)
    return eng, [tuple(r.output_tokens) for r in res]


def _run_jax(cfg, params, ecfg, draft):
    eng = JaxEngine(cfg, params, ecfg, seed=0, draft_cfg=draft[0],
                    draft_params=draft[1])
    res = eng.generate(_reqs(JaxGenRequest, JaxSamplingParams, cfg.vocab,
                             SPECS))
    return eng, [tuple(r.output_tokens) for r in res]


@pytest.mark.parametrize("bucketed,packed", [(True, True), (True, False),
                                             (False, True)])
def test_perfect_drafter_byte_identical(qwen_reduced, qwen_model_params,
                                        torch_qwen, bucketed, packed):
    """drafter == target: acceptance exactly 1.0 and the stream
    byte-identical to the non-speculative torch engine and to the JAX
    speculative engine, greedy and sampled requests alike."""
    _, jparams = qwen_model_params
    cfg, params = torch_qwen
    ecfg = EngineConfig(**ECFG, bucket_shapes=bucketed, packed_prefill=packed)
    _, base = _run(cfg, params, ecfg)
    eng, out = _run(cfg, params, dataclasses.replace(ecfg, spec_k=K_SPEC),
                    draft=(cfg, params))
    jeng, jout = _run_jax(qwen_reduced, jparams, JaxEngineConfig(
        **ECFG, bucket_shapes=bucketed, packed_prefill=packed,
        spec_k=K_SPEC), (qwen_reduced, jparams))
    assert out == base == jout
    b = eng.backend
    assert b.spec_dispatches == jeng.backend.spec_dispatches > 0
    assert b.spec_accepted == b.spec_drafted == jeng.backend.spec_drafted
    assert eng.core.spec_tokens > eng.core.spec_steps


def test_adversarial_drafter_graceful(qwen_reduced, qwen_model_params,
                                      torch_qwen, drafter):
    """A random drafter of other dims: acceptance collapses (to JAX's own
    count) but no unverified token is emitted, and every request ends."""
    _, jparams = qwen_model_params
    cfg, params = torch_qwen
    jd, jdp, td, tdp = drafter
    ecfg = EngineConfig(**ECFG)
    _, base = _run(cfg, params, ecfg)
    eng, out = _run(cfg, params, dataclasses.replace(ecfg, spec_k=K_SPEC),
                    draft=(td, tdp))
    jeng, jout = _run_jax(qwen_reduced, jparams,
                          JaxEngineConfig(**ECFG, spec_k=K_SPEC), (jd, jdp))
    assert out == base == jout
    b = eng.backend
    assert b.spec_drafted > 0
    assert b.spec_accepted / b.spec_drafted < 0.2
    assert (b.spec_accepted, b.spec_drafted) == \
        (jeng.backend.spec_accepted, jeng.backend.spec_drafted)
    assert eng.completions == len(SPECS)


def test_synthetic_acceptance_matches_jax(qwen_reduced, qwen_model_params,
                                          torch_qwen, drafter):
    """`EngineConfig.spec_synth_rate`: the coin, not the drafts, decides
    acceptance, so the random drafter is accepted at about the set rate;
    the emitted tokens (no longer the plain stream) and the accept counts
    equal the JAX engine's under the same knob, at every request's
    budget."""
    _, jparams = qwen_model_params
    cfg, params = torch_qwen
    jd, jdp, td, tdp = drafter
    eng, out = _run(cfg, params, EngineConfig(
        **ECFG, spec_k=K_SPEC, spec_synth_rate=0.6), draft=(td, tdp))
    jeng, jout = _run_jax(qwen_reduced, jparams, JaxEngineConfig(
        **ECFG, spec_k=K_SPEC, spec_synth_rate=0.6), (jd, jdp))
    assert out == jout
    assert [len(o) for o in out] == [kw["max_new_tokens"] for _, kw in SPECS]
    b = eng.backend
    assert (b.spec_accepted, b.spec_drafted) == \
        (jeng.backend.spec_accepted, jeng.backend.spec_drafted)
    assert 0.2 < b.spec_accepted / b.spec_drafted < 0.8


def test_spec_stream_multi_token_ordering(torch_qwen):
    """Every request's token events arrive with contiguous indices
    0..n-1, in order, exactly once, and match the final result, though a
    step appends several tokens to one sequence."""
    cfg, params = torch_qwen
    events: list = []
    eng, _ = _run(cfg, params, EngineConfig(**ECFG, spec_k=K_SPEC),
                  draft=(cfg, params), events=events)
    per: dict = {}
    for rid, tok, idx in events:
        per.setdefault(rid, []).append((idx, tok))
    assert len(per) == len(SPECS)
    for rid, got in per.items():
        res = eng.results[rid]
        assert [i for i, _ in got] == list(range(len(res.output_tokens)))
        assert tuple(t for _, t in got) == res.output_tokens
    assert eng.core.spec_tokens > eng.core.spec_steps


def test_accept_events_and_budget_truncation(torch_qwen):
    """One ("accept", rid, n) decision per sequence per speculative step,
    1 <= n <= k+1, and the counts reconcile with each request's exact
    budget."""
    cfg, params = torch_qwen
    eng = Engine(cfg, params, EngineConfig(**ECFG, spec_k=K_SPEC), seed=0,
                 draft_cfg=cfg, draft_params=params, device="cpu")
    eng.core.decisions = []                       # start recording
    res = eng.generate(_reqs(GenRequest, SamplingParams, cfg.vocab,
                             [(9, dict(max_new_tokens=5)),
                              (12, dict(max_new_tokens=9))]))
    accepts = [d for d in eng.core.decisions if d[0] == "accept"]
    assert accepts
    per: dict = {}
    for _, rid, n in accepts:
        assert 1 <= n <= K_SPEC + 1
        per[rid] = per.get(rid, 0) + n
    for r in res:
        # the first token comes from prefill, every later one from a burst
        assert per[r.rid] == len(r.output_tokens) - 1
    assert sorted(len(r.output_tokens) for r in res) == [5, 9]


# -------------------------------------------------------- decision streams

def test_replica_decisions_match_jax_spec_backend(qwen_reduced,
                                                  qwen_model_params,
                                                  torch_qwen):
    """`tests/test_replica_parity.py`'s trace (preemption, prefix caching,
    eviction, rejection, cancellation) with speculation on, drafter ==
    target: byte-identical decision streams, accept events included."""
    _, jparams = qwen_model_params
    tcfg, tparams = torch_qwen
    trace = rp._trace(qwen_reduced.vocab)
    CFG = rp.CFG
    jb = JaxPagedBackend(qwen_reduced, jparams, n_pages=CFG.n_pages,
                         page_size=CFG.page_size, prefill_pad=16,
                         spec_k=K_SPEC, draft_cfg=qwen_reduced,
                         draft_params=jparams)
    jcore = JaxReplicaCore(CFG, jb)
    jb.bind(jcore)
    jcached = rp._drive(jcore, trace)
    tb = TorchPagedBackend(tcfg, tparams, n_pages=CFG.n_pages,
                           page_size=CFG.page_size, device="cpu",
                           prefill_pad=16, spec_k=K_SPEC, draft_cfg=tcfg,
                           draft_params=tparams)
    tcore = ReplicaCore(ReplicaCoreConfig(**dataclasses.asdict(CFG)), tb)
    tb.bind(tcore)
    tcached = _drive_torch(tcore, trace)

    assert repr(tcore.decisions).encode() == repr(jcore.decisions).encode()
    assert tcached == jcached
    kinds = {e[0] for e in tcore.decisions}
    assert kinds == {"admit", "evict", "reject", "preempt", "cancel",
                     "accept"}
    assert tcore.spec_tokens == jcore.spec_tokens > tcore.spec_steps
    assert tcore.completions == jcore.completions == 6


def test_spec_with_host_tier_matches_jax(qwen_reduced, qwen_model_params,
                                         torch_qwen):
    """The host-tier parity trace of `tests/test_torch_hosttier.py` with
    speculation on: the same admit / evict / hostload / accept stream as
    the JAX backend. The tier moves the target pools only, in both."""
    _, jparams = qwen_model_params
    tcfg, tparams = torch_qwen
    kw = dict(page_size=8, n_pages=12, max_batch=2, max_seq_len=256,
              reserved_pages=1, host_pages=24, record_decisions=True)
    rng = np.random.default_rng(13)
    tok = lambda n: tuple(int(t) for t in              # noqa: E731
                          rng.integers(1, qwen_reduced.vocab, size=n))
    p0, p1 = tok(40), tok(56)
    trace = {0: [(0, p0, 8)], 30: [(1, p1, 8)], 60: [(2, p0, 8)]}

    def drive(core, R, SP):
        out = {}
        for step in range(100):
            for rid, prompt, max_new in trace.get(step, ()):
                core.submit(R(prompt_tokens=prompt, rid=rid,
                              sampling=SP(max_new_tokens=max_new)))
            core.begin_step()
            for s in core.finish_step():
                out[s.req.rid] = tuple(s.out)
        return out

    jb = JaxPagedBackend(qwen_reduced, jparams, n_pages=12, page_size=8,
                         prefill_pad=16, spec_k=K_SPEC,
                         draft_cfg=qwen_reduced, draft_params=jparams)
    jcore = JaxReplicaCore(JaxReplicaCoreConfig(**kw), jb)
    jb.bind(jcore)
    jout = drive(jcore, JaxGenRequest, JaxSamplingParams)
    tb = TorchPagedBackend(tcfg, tparams, n_pages=12, page_size=8,
                           device="cpu", prefill_pad=16, spec_k=K_SPEC,
                           draft_cfg=tcfg, draft_params=tparams)
    tcore = ReplicaCore(ReplicaCoreConfig(**kw), tb)
    tb.bind(tcore)
    tout = drive(tcore, GenRequest, SamplingParams)

    assert repr(tcore.decisions).encode() == repr(jcore.decisions).encode()
    assert tout == jout and len(tout) == 3
    kinds = {e[0] for e in tcore.decisions}
    assert {"hostload", "accept"} <= kinds
    assert tb.loaded_pages == jb.loaded_pages > 0
    assert tb.spec_accepted == jb.spec_accepted
    assert tcore.radix.host.total_pins() == 0


# ---------------------------------------------------- hot-path invariants

_SYNCS = ("cpu", "item", "tolist", "__int__", "__float__", "__bool__",
          "__index__")


def test_spec_hot_path_invariants(torch_qwen, monkeypatch):
    """With speculation on: steady-state steps upload nothing (no batch
    state sync while membership is stable), one speculative step moves
    data to the host exactly once (T and n_acc together), and a varied
    workload runs a bounded set of (batch, pages) buckets."""
    cfg, params = torch_qwen
    eng = Engine(cfg, params, EngineConfig(**ECFG, spec_k=K_SPEC),
                 draft_cfg=cfg, draft_params=params, device="cpu")
    for r in _reqs(GenRequest, SamplingParams, cfg.vocab,
                   [(10, dict(max_new_tokens=60)),
                    (14, dict(max_new_tokens=60, temperature=0.9, seed=4))]):
        eng.submit(r)
    eng.step()                                  # admits both (prefill only)
    eng.step()                                  # first spec step -> sync
    syncs = {"slots": 0, "host": 0}
    orig = eng.backend._sync_slots

    def counting(seqs):
        syncs["slots"] += 1
        return orig(seqs)

    eng.backend._sync_slots = counting
    for _ in range(6):
        eng.step()
    assert syncs["slots"] == 0                  # membership never changed
    steps0 = eng.core.spec_steps
    with monkeypatch.context() as m:
        for name in _SYNCS:
            fn = getattr(torch.Tensor, name)

            def wrapped(self, *a, _fn=fn, **k):
                syncs["host"] += 1
                return _fn(self, *a, **k)

            m.setattr(torch.Tensor, name, wrapped)
        eng.step()
    assert eng.core.spec_steps == steps0 + 1
    assert syncs["host"] == 1
    eng.run_until_idle()
    assert eng.completions == 2
    rng = np.random.default_rng(9)
    specs = [(int(n), dict(max_new_tokens=int(m)))
             for n, m in zip(rng.integers(5, 60, size=10),
                             rng.integers(3, 12, size=10))]
    eng.generate(_reqs(GenRequest, SamplingParams, cfg.vocab, specs, seed=9))
    bound = n_buckets(ECFG["max_batch"]) * n_buckets(
        -(-ECFG["max_seq_len"] // ECFG["page_size"]))
    assert 0 < len(eng.backend.decode_buckets) <= bound
    assert eng.backend.spec_accepted == eng.backend.spec_drafted
