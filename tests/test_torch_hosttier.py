"""The port's host KV tier against the JAX package's: the engine with
`host_pages` gives the JAX engine's tokens, host-hit tokens, demotions and
hit rate under eviction pressure (`tests/test_hosttier.py`'s engine
scenario); `ReplicaCore` + `TorchPagedBackend` with the tier on makes the
decision stream `JaxPagedBackend` makes on the host-tier parity trace; a
load-back restores the demoted bytes exactly; a cancel racing a load-back
releases every host pin, and so does the engine's deadline sweep, as the
JAX engine's does; the backend refuses page ids outside its pool."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.replica import ReplicaCore as JaxReplicaCore
from repro.replica import ReplicaCoreConfig as JaxReplicaCoreConfig
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import GenRequest as JaxGenRequest
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving.jax_backend import JaxPagedBackend
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.replica import ReplicaCore, ReplicaCoreConfig
from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                 SamplingParams, TorchPagedBackend)

SMALL = dict(page_size=8, n_pages=23, max_batch=3, max_seq_len=256,
             prefill_pad=16)


@pytest.fixture(scope="module")
def torch_qwen(qwen_model_params):
    _, params = qwen_model_params
    cfg = get_config("qwen3-0.6b").reduced()
    return cfg, from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                "cpu", torch.float32)


def _gen(R, SP, rid, prompt, max_new):
    return R(prompt_tokens=tuple(prompt), rid=rid,
             sampling=SP(max_new_tokens=max_new))


def _prompts(vocab):
    """`tests/test_hosttier.py`'s engine scenario: six prompts sharing a
    40-token base, each run twice."""
    rng = np.random.default_rng(9)
    base = tuple(int(t) for t in rng.integers(1, vocab, size=40))
    return [base + tuple(int(t) for t in rng.integers(1, vocab, size=32))
            for _ in range(6)]


def _run_twice(eng, R, SP, prompts):
    out = []
    for rid0 in (100, 200):
        out += eng.generate([_gen(R, SP, rid0 + i, p, 8)
                             for i, p in enumerate(prompts)])
    return out


@pytest.mark.parametrize("overlap_loads", [True, False])
def test_host_tier_engine_matches_jax(qwen_reduced, qwen_model_params,
                                      torch_qwen, overlap_loads):
    """Equal tokens, finish reasons, cached tokens, host-hit tokens,
    demotions, promotions and hit rate; pins drained; every demotion
    flushed through the backend."""
    _, jparams = qwen_model_params
    tcfg, tparams = torch_qwen
    prompts = _prompts(qwen_reduced.vocab)
    jeng = JaxEngine(qwen_reduced, jparams,
                     JaxEngineConfig(**SMALL, host_pages=64))
    jout = _run_twice(jeng, JaxGenRequest, JaxSamplingParams, prompts)
    teng = Engine(tcfg, tparams,
                  EngineConfig(**SMALL, host_pages=64,
                               overlap_loads=overlap_loads), device="cpu")
    tout = _run_twice(teng, GenRequest, SamplingParams, prompts)

    assert [r.output_tokens for r in tout] == [r.output_tokens for r in jout]
    assert [(r.finish_reason.value, r.cached_tokens) for r in tout] == \
        [(r.finish_reason.value, r.cached_tokens) for r in jout]
    tc, jc = teng.core, jeng.core
    assert tc.host_hit_tokens == jc.host_hit_tokens > 0
    assert tc.radix.demoted_pages == jc.radix.demoted_pages > 0
    assert tc.radix.promoted_pages == jc.radix.promoted_pages > 0
    assert tc.loaded_pages == jc.loaded_pages > 0
    assert teng.hit_rate() == jeng.hit_rate()
    assert teng.backend.demoted_pages == tc.radix.demoted_pages
    assert teng.backend.loaded_pages == tc.loaded_pages
    assert tc.radix.host.total_pins() == 0
    assert not teng.loading and not teng.backend._staging


def test_host_tier_decisions_match_jax_backend(qwen_reduced,
                                               qwen_model_params, torch_qwen):
    """`tests/test_hosttier.py`'s host-tier parity trace: identical admit /
    evict / hostload decision streams and cached tokens."""
    _, jparams = qwen_model_params
    tcfg, tparams = torch_qwen
    kw = dict(page_size=8, n_pages=12, max_batch=2, max_seq_len=256,
              reserved_pages=1, host_pages=24, record_decisions=True)
    rng = np.random.default_rng(13)
    tok = lambda n: tuple(int(t) for t in
                          rng.integers(1, qwen_reduced.vocab, size=n))
    p0, p1 = tok(40), tok(56)
    trace = {0: [(0, p0, 8)], 30: [(1, p1, 8)], 60: [(2, p0, 8)]}

    def drive(core, R, SP):
        cached = {}
        for step in range(100):
            for rid, prompt, max_new in trace.get(step, ()):
                core.submit(_gen(R, SP, rid, prompt, max_new))
            plan = core.begin_step()
            for seq in plan.admitted:
                cached[seq.req.rid] = seq.req.cached_tokens
            core.finish_step()
        return cached

    jb = JaxPagedBackend(qwen_reduced, jparams, n_pages=12, page_size=8,
                         prefill_pad=16)
    jcore = JaxReplicaCore(JaxReplicaCoreConfig(**kw), jb)
    jb.bind(jcore)
    jcached = drive(jcore, JaxGenRequest, JaxSamplingParams)
    tb = TorchPagedBackend(tcfg, tparams, n_pages=12, page_size=8,
                           device="cpu", prefill_pad=16)
    tcore = ReplicaCore(ReplicaCoreConfig(**kw), tb)
    tb.bind(tcore)
    tcached = drive(tcore, GenRequest, SamplingParams)

    assert repr(tcore.decisions).encode() == repr(jcore.decisions).encode()
    assert tcached == jcached
    assert any(e[0] == "hostload" for e in tcore.decisions)
    assert tcore.host_hit_tokens == jcore.host_hit_tokens > 0
    assert tb.demoted_pages == jb.demoted_pages > 0
    assert tb.loaded_pages == jb.loaded_pages > 0
    assert tcore.completions == 3
    assert tcore.radix.host.total_pins() == 0


def _pressured_core(torch_qwen):
    """A backend whose pool holds one 30-token prompt: the second prompt
    demotes the first's pages, the replay of the first loads them back."""
    tcfg, tparams = torch_qwen
    tb = TorchPagedBackend(tcfg, tparams, n_pages=6, page_size=8,
                           device="cpu", prefill_pad=16)
    core = ReplicaCore(ReplicaCoreConfig(
        page_size=8, n_pages=6, max_batch=1, max_seq_len=64,
        reserved_pages=1, host_pages=16, record_decisions=True), tb)
    tb.bind(core)
    return tb, core


def _drain(core, max_steps=200):
    for _ in range(max_steps):
        core.begin_step()
        core.finish_step()
        if not core.running and not core.pending and not core.loading:
            return
    raise AssertionError("core did not drain")


def test_load_back_restores_demoted_bytes(torch_qwen):
    """The bytes a load-back scatters into the pool are the bytes the
    demotion flushed out, bit for bit, at the newly claimed page ids."""
    tb, core = _pressured_core(torch_qwen)
    p0, p1 = tuple(range(100, 130)), tuple(range(200, 230))
    core.submit(_gen(GenRequest, SamplingParams, 0, p0, 4))
    _drain(core)
    _, pages0 = core.radix.match(p0)
    snap = {i: (tb.k_pages[:, p].clone(), tb.v_pages[:, p].clone())
            for i, p in enumerate(pages0)}
    core.submit(_gen(GenRequest, SamplingParams, 1, p1, 4))
    _drain(core)
    assert tb.demoted_pages == core.radix.demoted_pages > 0
    core.submit(_gen(GenRequest, SamplingParams, 2, p0, 4))
    core.begin_step()
    [seq] = core.loading
    plan = [(i, dp) for i, (_nd, _hp, dp) in enumerate(seq.host_plan)]
    assert plan and not tb._demote_q
    core.finish_step()
    core.begin_step()                       # the load finishes here
    for i, dp in plan:
        k, v = snap[i]
        assert torch.equal(tb.k_pages[:, dp], k)
        assert torch.equal(tb.v_pages[:, dp], v)
    _drain(core)
    assert tb.loaded_pages == len(plan)
    assert core.radix.host.total_pins() == 0


def test_cancel_during_load_releases_host_pins(torch_qwen):
    """A cancel racing the load-back drops the staged copy and releases
    every host pin and device page (`tests/test_hosttier.py`'s cancel
    scenario, over the port's backend)."""
    tb, core = _pressured_core(torch_qwen)
    core.submit(_gen(GenRequest, SamplingParams, 0, range(100, 130), 4))
    _drain(core)
    core.submit(_gen(GenRequest, SamplingParams, 1, range(200, 230), 4))
    _drain(core)
    core.submit(_gen(GenRequest, SamplingParams, 2, range(100, 130), 4))
    core.begin_step()
    assert [s.req.rid for s in core.loading] == [2]
    assert core.radix.host.total_pins() > 0 and tb._staging
    assert core.cancel(2) is not None
    assert not core.loading and not tb._staging
    assert core.radix.host.total_pins() == 0
    assert ("cancel", 2) in core.decisions
    core.finish_step()
    assert core.alloc.free_pages + core.radix.cached_pages == 5
    assert tb.loaded_pages == 0
    core.submit(_gen(GenRequest, SamplingParams, 3, range(300, 310), 4))
    _drain(core)
    assert core.completions == 3


def _deadline_during_load(eng, R, SP, FR):
    """`_pressured_core`'s scenario through an `Engine`: the replay of the
    first prompt waits in `loading` for its host pages when its deadline
    passes. Returns (its result, the decisions, the abort_load calls, the
    host pins and device pages held after the sweep)."""
    aborts = []
    abort = eng.backend.abort_load
    eng.backend.abort_load = lambda seq: (aborts.append(seq.req.rid),
                                          abort(seq))
    eng.core.decisions = []                       # start recording
    eng.generate([_gen(R, SP, 0, range(100, 130), 4)])
    eng.generate([_gen(R, SP, 1, range(200, 230), 4)])
    req = _gen(R, SP, 2, range(100, 130), 4)
    req.deadline_s = 60.0
    eng.submit(req)
    eng.step()                                    # admitted into loading
    assert [s.req.rid for s in eng.loading] == [2]
    pins = eng.core.radix.host.total_pins()
    req.arrival_s -= 120.0                        # the deadline has passed
    eng.step()                                    # the sweep reaps it
    assert eng.results[2].finish_reason == FR.DEADLINE
    ccfg = eng.core.cfg
    held = (ccfg.n_pages - ccfg.reserved_pages - eng.core.alloc.free_pages
            - eng.core.radix.cached_pages)
    return (pins, eng.core.decisions, aborts,
            eng.core.radix.host.total_pins(), held, len(eng.loading))


def test_deadline_sweep_reaps_a_loading_sequence(qwen_reduced,
                                                 qwen_model_params,
                                                 torch_qwen):
    """A request whose deadline passes while its host pages load back is
    cancelled with DEADLINE: `abort_load` drops the staged copy, the host
    pins and device pages come back, and the JAX engine makes the same
    decisions in the same setup."""
    from repro.serving import FinishReason as JaxFinishReason
    from repro_torch.serving import FinishReason
    _, jparams = qwen_model_params
    tcfg, tparams = torch_qwen
    small = dict(page_size=8, n_pages=6, max_batch=1, max_seq_len=64,
                 prefill_pad=16, host_pages=16)
    teng = Engine(tcfg, tparams, EngineConfig(**small), device="cpu")
    got = _deadline_during_load(teng, GenRequest, SamplingParams,
                                FinishReason)
    jeng = JaxEngine(qwen_reduced, jparams, JaxEngineConfig(**small))
    want = _deadline_during_load(jeng, JaxGenRequest, JaxSamplingParams,
                                 JaxFinishReason)
    pins, decisions, aborts, pins_after, held, loading = got
    assert pins > 0 and aborts == [2]
    assert pins_after == 0 and held == 0 and loading == 0
    assert ("cancel", 2) in decisions and any(d[0] == "hostload"
                                              for d in decisions)
    assert not teng.backend._staging and teng.backend.loaded_pages == 0
    assert repr(decisions).encode() == repr(want[1]).encode()
    assert got == want


def test_page_ids_outside_the_pool_raise(torch_qwen):
    tb, _ = _pressured_core(torch_qwen)
    with pytest.raises(ValueError, match="outside"):
        tb.export_pages([0, 6])
    with pytest.raises(ValueError, match="outside"):
        tb.export_pages([-1])


def _reuse_trace(eng, R, SP, after_second=None):
    """A one-page host tier under a pool that holds one 4-page prompt: the
    second prompt evicts three of the first's pages in ONE round, each
    taking host page 0 from the one demoted just before it (the radix
    retires that host leaf to make room), so one flush holds three
    demotions onto one host page; the replay of the first prompt then
    loads the last of them back. Returns the results and the decisions."""
    rng = np.random.default_rng(21)
    first, second = (tuple(int(t) for t in rng.integers(
        1, eng.cfg.vocab, size=525)) for _ in range(2))
    eng.core.decisions = []                       # start recording
    out = eng.generate([_gen(R, SP, 0, first, 4)])
    out += eng.generate([_gen(R, SP, 1, second, 4)])
    if after_second is not None:
        after_second()
    out += eng.generate([_gen(R, SP, 2, first, 4)])
    return out, eng.core.decisions


def test_host_page_reused_within_one_flush(qwen_reduced, qwen_model_params,
                                           torch_qwen):
    """When one flush demotes several device pages onto the same host page,
    the mirror keeps the LAST demotion's bytes, as the JAX backend's
    in-order writes do; the replay's host hit then loads those bytes, and
    the tokens and the decision stream equal the JAX engine's."""
    _, jparams = qwen_model_params
    tcfg, tparams = torch_qwen
    small = dict(page_size=128, n_pages=7, max_batch=1, max_seq_len=1024,
                 prefill_pad=16, host_pages=1)
    teng = Engine(tcfg, tparams, EngineConfig(**small), device="cpu")
    tb = teng.backend
    demotes, snaps = [], {}
    demote = teng.core.radix.on_demote

    def snap_demote(dev_page, host_page):
        demotes.append((dev_page, host_page))
        snaps[host_page] = (tb.k_pages[:, dev_page].clone(),
                            tb.v_pages[:, dev_page].clone())
        demote(dev_page, host_page)

    def mirror_holds_last():
        assert len(demotes) >= 2 and len({h for _, h in demotes}) == 1
        assert not tb._demote_q                   # flushed at the prefill
        k, v = snaps[demotes[-1][1]]
        assert torch.equal(tb._h_k[demotes[-1][1]], k)
        assert torch.equal(tb._h_v[demotes[-1][1]], v)

    teng.core.radix.on_demote = snap_demote
    tout, tdec = _reuse_trace(teng, GenRequest, SamplingParams,
                              mirror_holds_last)
    jeng = JaxEngine(qwen_reduced, jparams, JaxEngineConfig(**small))
    jout, jdec = _reuse_trace(jeng, JaxGenRequest, JaxSamplingParams)

    assert tb.demoted_pages == teng.core.radix.demoted_pages == len(demotes)
    assert teng.core.host_hit_tokens == jeng.core.host_hit_tokens > 0
    assert [r.output_tokens for r in tout] == [r.output_tokens for r in jout]
    assert [r.cached_tokens for r in tout] == [r.cached_tokens for r in jout]
    assert repr(tdec).encode() == repr(jdec).encode()
    assert any(d[0] == "hostload" for d in tdec)
