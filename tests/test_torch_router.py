"""The port's `InProcessRouter` over the port's engines against the JAX
package's router over JAX engines: the cross-region pull scenario of
`tests/test_kvtransfer.py` (same PULL decisions, tokens and cached tokens;
the imported pages hold the exported bytes bit for bit, and the exported
KV equals the JAX engine's within the model runner's tolerance), and the
work-stealing and LB-failover scenarios of `tests/test_router_engine.py`
(same `router.events` and results); plus `Engine.export_prefix` /
`import_prefix` on their own."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import routing as jrouting
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import GenRequest as JaxGenRequest
from repro.serving import InProcessRouter as JaxRouter
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch import routing as trouting
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                 InProcessRouter, SamplingParams)

ECFG = dict(page_size=8, n_pages=64, max_batch=2, max_seq_len=128,
            prefill_pad=16)
KV_TOL = 1e-4          # the model runner's pool tolerance against JAX


@pytest.fixture(scope="module")
def torch_qwen(qwen_model_params):
    _, params = qwen_model_params
    cfg = get_config("qwen3-0.6b").reduced()
    return cfg, from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                "cpu", torch.float32)


class _Side:
    """One framework's router, engine and request types."""

    def __init__(self, routing, Router, mk_engine, R, SP):
        self.routing, self.Router, self.mk_engine = routing, Router, mk_engine
        self.R, self.SP = R, SP


@pytest.fixture(scope="module")
def sides(qwen_reduced, qwen_model_params, torch_qwen):
    _, jparams = qwen_model_params
    tcfg, tparams = torch_qwen
    jax_side = _Side(jrouting, JaxRouter,
                     lambda: JaxEngine(qwen_reduced, jparams,
                                       JaxEngineConfig(**ECFG)),
                     JaxGenRequest, JaxSamplingParams)
    torch_side = _Side(trouting, InProcessRouter,
                       lambda: Engine(tcfg, tparams, EngineConfig(**ECFG),
                                      device="cpu"),
                       GenRequest, SamplingParams)
    return jax_side, torch_side


def _pull_run(side, prompt):
    """`tests/test_kvtransfer.py`'s end-to-end pull: warm eu's cache, let
    us learn that eu holds the prompt, send the replay to us."""
    rt = side.routing
    router = side.Router(
        remote_policy=rt.PrefixTreePolicy(),
        cfg=rt.RoutingConfig(
            record_decisions=True, kv_transfer=True,
            kv_params=rt.KVTransferParams(kv_bytes_per_token=1e5,
                                          wan_rtt_s=0.1, prefill_tps=100.0,
                                          min_pull_tokens=8)))
    for region in ("us", "eu"):
        lb = router.add_region(region, rt.PrefixTreePolicy())
        lb.add_engine(f"{region}-r0", side.mk_engine())
    exported, imported = [], []
    eu = router.lbs["eu"].engines["eu-r0"]
    us = router.lbs["us"].engines["us-r0"]
    orig_export, orig_import = eu.export_prefix, us.import_prefix

    def export(tokens):
        out = orig_export(tokens)
        exported.append(out)
        return out

    def import_(tokens, ks, vs):
        imported.append((len(tokens), ks, vs))
        return orig_import(tokens, ks, vs)

    eu.export_prefix, us.import_prefix = export, import_
    reqs = [side.R(prompt_tokens=prompt, rid=rid,
                   sampling=side.SP(max_new_tokens=8)) for rid in (1, 2)]
    router.submit("eu", reqs[0])
    router.run_until_idle()
    router.lbs["us"].core.remote_policy.tree.insert(prompt, "eu")
    router.submit("us", reqs[1])
    router.run_until_idle()
    return router, exported, imported


def test_pull_scenario_matches_jax_router(sides, qwen_reduced):
    rng = np.random.default_rng(5)
    p = tuple(int(t) for t in rng.integers(1, qwen_reduced.vocab, size=48))
    (jr, jexp, _), (tr, texp, timp) = (_pull_run(s, p) for s in sides)

    jus, tus = jr.lbs["us"].core, tr.lbs["us"].core
    assert tus.decisions == jus.decisions
    assert tus.kv_decisions == jus.kv_decisions
    assert tus.kv_decisions[trouting.PULL] == 1
    assert tus.pulled_tokens == jus.pulled_tokens == len(p)
    assert ("pull", 2, "eu") in tus.decisions
    jres, tres = jr.results(), tr.results()
    for rid in (1, 2):
        assert tres[rid].output_tokens == jres[rid].output_tokens
        assert tres[rid].cached_tokens == jres[rid].cached_tokens
        assert tres[rid].finish_reason.value == jres[rid].finish_reason.value
    assert tres[2].cached_tokens > 0
    assert tres[2].output_tokens == tres[1].output_tokens
    assert tr.lbs["us"].engines["us-r0"].completions == 1
    assert tr.lbs["us"].forwarded_out == 0

    # what crossed the WAN: CPU stacks, the same blocks as JAX's
    [(tn, tks, tvs)] = texp
    [(jn, jks, jvs)] = jexp
    assert tn == jn == 48 and tks.device.type == "cpu"
    assert tuple(tks.shape) == np.asarray(jks).shape
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), atol=KV_TOL,
                               rtol=KV_TOL)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=KV_TOL,
                               rtol=KV_TOL)
    # what landed in us's pool: the exported bytes, bit for bit
    [(n_in, _, _)] = timp
    us = tr.lbs["us"].engines["us-r0"]
    n_us, uks, uvs = us.export_prefix(p[:n_in])
    assert n_us == n_in == tn
    assert torch.equal(uks, tks) and torch.equal(uvs, tvs)


def _stealing(side, vocab):
    rt = side.routing
    router = side.Router(cfg=rt.RoutingConfig(
        pushing=rt.SP_P, cross_region=False, work_stealing=True,
        steal_threshold=1, steal_batch=2, max_inflight_per_probe=1))
    for region in ("us", "eu"):
        router.add_region(region, rt.LeastLoad()).add_engine(
            f"{region}-r0", side.mk_engine())
    rng = np.random.default_rng(0)
    rids = []
    for _ in range(6):
        r = _mk_req(side, rng, vocab)
        rids.append(r.rid)
        router.submit("us", r)
    router.run_until_idle()
    assert router.lbs["us"].forwarded_out > 0
    assert router.lbs["eu"].engines["eu-r0"].completions > 0
    return router, rids


def _failover(side, vocab):
    rt = side.routing
    router = side.Router(cfg=rt.RoutingConfig(
        pushing=rt.SP_P, cross_region=False, max_inflight_per_probe=1))
    for region in ("us", "eu"):
        router.add_region(region, rt.LeastLoad()).add_engine(
            f"{region}-r0", side.mk_engine())
    rng = np.random.default_rng(1)
    rids = []

    def submit(n):
        for _ in range(n):
            r = _mk_req(side, rng, vocab)
            rids.append(r.rid)
            router.submit("us", r)

    submit(3)
    assert len(router.lbs["us"].queue) == 2
    router.fail_lb("us")
    router.run_until_idle()
    assert "us-r0" in router.lbs["eu"].engines
    router.recover_lb("us")
    router.step()
    assert "us-r0" in router.lbs["us"].engines
    submit(2)
    router.run_until_idle()
    return router, rids


def _mk_req(side, rng, vocab, n=16, max_new=4):
    return side.R(prompt_tokens=tuple(rng.integers(0, vocab, size=n).tolist()),
                  sampling=side.SP(max_new_tokens=max_new))


@pytest.mark.parametrize("scenario", [_stealing, _failover],
                         ids=["work_stealing", "lb_failover"])
def test_router_scenario_matches_jax_router(sides, qwen_reduced, scenario):
    (jr, jrids), (tr, trids) = (scenario(s, qwen_reduced.vocab)
                                for s in sides)
    assert tr.events == jr.events
    jres, tres = jr.results(), tr.results()
    assert len(tres) == len(jres) == len(trids)
    for jrid, trid in zip(jrids, trids):
        j, t = jres[jrid], tres[trid]
        assert t.output_tokens == j.output_tokens
        assert (t.finish_reason.value, t.cached_tokens) == \
            (j.finish_reason.value, j.cached_tokens)
    for region in ("us", "eu"):
        assert tr.lbs[region].forwarded_out == jr.lbs[region].forwarded_out
        assert [e.completions for e in tr.lbs[region].engines.values()] == \
            [e.completions for e in jr.lbs[region].engines.values()]


def test_export_import_prefix_round_trip(torch_qwen):
    """An engine's exported prefix imported into a cold engine is a cache
    hit there, with the same bytes; a partial local hit imports only the
    missing blocks; an uncached prefix exports nothing."""
    cfg, params = torch_qwen
    src = Engine(cfg, params, EngineConfig(**ECFG), device="cpu")
    dst = Engine(cfg, params, EngineConfig(**ECFG), device="cpu")
    rng = np.random.default_rng(7)
    p = tuple(int(t) for t in rng.integers(1, cfg.vocab, size=40))
    assert src.export_prefix(p) == (0, None, None)
    src.generate([GenRequest(prompt_tokens=p,
                             sampling=SamplingParams(max_new_tokens=2))])
    n, ks, vs = src.export_prefix(p)
    assert n == 40 and ks.shape == (5, cfg.n_layers, 8, cfg.n_kv_heads,
                                    cfg.hd)
    # dst already holds the first two blocks: only the other three land
    dst.import_prefix(p[:16], ks[:2], vs[:2])
    assert dst.import_prefix(p, ks, vs) == 40
    n2, ks2, vs2 = dst.export_prefix(p)
    assert n2 == 40 and torch.equal(ks2, ks) and torch.equal(vs2, vs)
    [res] = dst.generate([GenRequest(
        prompt_tokens=p, sampling=SamplingParams(max_new_tokens=2))])
    assert res.cached_tokens == 32      # full pages short of the last token
