"""The MoE FFN of the port against `repro.models.moe` and the JAX serving
path, on `granite-moe-1b-a400m` `.reduced()` (4 experts, top-2, d_expert
64) in fp32, with weights from the JAX init converted by
`from_jax_params`.

Exact: `capacity`, `_topk_iterative` (ties to the lowest index), and
`_dispatch_group`'s slot tokens and gates, with drops; the engine's token
streams, greedy and seeded, packed and unpacked, with and without
speculation; the `ReplicaCore` decision stream. Within 1e-5 (fp32
summation order; `apply_moe`'s outputs are O(1)): `apply_moe`'s y and aux.
Within 1e-4, as `tests/test_torch_model_runner.py` holds the dense steps:
a packed prefill's logits and pools where the first segment fills two
experts past capacity, so the second segment's assignments to them drop.
The other model-runner steps take MoE as one more model in
`tests/test_torch_{model_runner,spec}.py`."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model
from repro.models import moe as jmoe
from repro.replica import ReplicaCore as JaxReplicaCore
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import GenRequest as JaxGenRequest
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving import model_runner as jmr
from repro.serving.jax_backend import JaxPagedBackend
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import moe as tmoe
from repro_torch.replica import ReplicaCore, ReplicaCoreConfig
from repro_torch.serving import (Engine, EngineConfig, GenRequest,
                                 SamplingParams, TorchPagedBackend)
from repro_torch.serving import model_runner as tmr
from repro_torch.serving.sampling import prng_key

import test_replica_parity as rp
from test_torch_engine import _drive_torch

NAME = "granite-moe-1b-a400m"
JCFG = jax_config(NAME).reduced()
TCFG = get_config(NAME).reduced()
E, K = JCFG.moe.n_experts, JCFG.moe.top_k
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
ECFG = dict(page_size=8, n_pages=64, max_batch=4, max_seq_len=256,
            prefill_pad=16)
K_SPEC = 3
# the reference layer compiled once per shape rather than dispatched op by
# op
_jax_apply_moe = jax.jit(jmoe.apply_moe, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def weights():
    jp = build_model(JCFG, jnp.float32).init(jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TCFG, "cpu",
                               torch.float32)


@pytest.fixture
def drops(monkeypatch):
    """Counts the assignments `apply_moe` drops past capacity."""
    seen = {"dropped": 0}
    orig = tmoe._dispatch_group

    def counting(gate_vals, eids, n_exp, cap):
        out = orig(gate_vals, eids, n_exp, cap)
        seen["dropped"] += int((out[2] == n_exp * cap).sum())
        return out

    monkeypatch.setattr(tmoe, "_dispatch_group", counting)
    return seen


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize("T", [1, 3, 8, 13, 16, 31, 32, 100, 512, 2048])
def test_capacity_matches_jax(T):
    for name in (NAME, "granite-moe-3b-a800m"):
        for cfg_j, cfg_t in ((jax_config(name), get_config(name)),
                             (jax_config(name).reduced(),
                              get_config(name).reduced())):
            assert tmoe.capacity(T, cfg_t) == jmoe.capacity(T, cfg_j)


def test_topk_iterative_breaks_ties_to_the_lowest_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.0, 0.5],
                      [0.1, 0.2, 0.3, 0.4]], np.float32)
    probs = np.concatenate([probs, np.random.default_rng(1).dirichlet(
        np.ones(4), size=6).astype(np.float32)])
    jv, ji = jmoe._topk_iterative(jnp.asarray(probs), 3)
    tv, ti = tmoe._topk_iterative(torch.tensor(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert ti[:5].tolist() == [[0, 1, 2], [1, 2, 0], [0, 2, 1], [1, 3, 0],
                               [3, 2, 1]]


def _assignments(case: str, rng):
    """(gate_vals (G, T, k), eids (G, T, k), C) for three groups."""
    G, T = 3, 24
    if case == "no drops":
        eids = np.stack([rng.permutation(E)[:K] for _ in range(G * T)])
        C = 2 * T                                   # room for every token
    elif case == "drops":
        # expert 0 is every token's first choice: 24 > C = 16 assignments
        eids = np.stack([[0, 1 + rng.integers(E - 1)] for _ in range(G * T)])
        C = 16
    else:                                           # all on one pair
        eids = np.tile(np.array([2, 3]), (G * T, 1))
        C = 8
    gate = rng.random((G * T, K)).astype(np.float32)
    return (gate.reshape(G, T, K), eids.reshape(G, T, K).astype(np.int32),
            C)


@pytest.mark.parametrize("case", ["no drops", "drops", "one pair"])
def test_dispatch_group_matches_jax(case):
    """Slot tokens and gates equal the JAX package's bit for bit, group by
    group and batched; every kept slot is written once, and the slots past
    each expert's capacity are dropped."""
    gate, eids, C = _assignments(case, np.random.default_rng(3))
    tst, tsg, a_slot = tmoe._dispatch_group(
        torch.tensor(gate), torch.tensor(eids).long(), E, C)
    for g in range(gate.shape[0]):
        jst, jsg = jmoe._dispatch_group(jnp.asarray(gate[g]),
                                        jnp.asarray(eids[g]), E, C)
        assert tst[g].tolist() == np.asarray(jst).tolist()
        assert tsg[g].numpy().tobytes() == np.asarray(jsg).tobytes()
        one = tmoe._dispatch_group(torch.tensor(gate[g]),
                                   torch.tensor(eids[g]).long(), E, C)
        assert one[0].tolist() == tst[g].tolist()
        kept = a_slot[g][a_slot[g] < E * C]
        assert len(set(kept.tolist())) == len(kept)
        # each kept assignment's slot holds its token and gate
        a = torch.nonzero(a_slot[g] < E * C)[:, 0]
        assert (tst[g][kept] == a // K).all()
        assert (tsg[g][kept] == torch.tensor(gate[g]).reshape(-1)[a]).all()
        per_expert = np.bincount(eids[g].reshape(-1), minlength=E)
        assert len(kept) == int(np.minimum(per_expert, C).sum())
    n_drop = int((a_slot == E * C).sum())
    assert (n_drop > 0) == (case != "no drops")


@pytest.mark.parametrize("G,T,repeat", [(1, 1, 0), (4, 1, 0), (2, 13, 0),
                                        (1, 64, 0), (1, 64, 48), (3, 40, 30)])
def test_apply_moe_matches_jax(weights, drops, G, T, repeat):
    """y and aux against the JAX package's, with a run of `repeat`
    identical tokens leading each group so that two experts overflow."""
    jp, tp = weights
    lp_j = jax.tree.map(lambda a: a[1], jp["layers"]["moe"])
    lp_t = {k: v[1] for k, v in tp["layers"]["moe"].items()}
    rng = np.random.default_rng(G * 100 + T)
    x = rng.normal(size=(G, T, JCFG.d_model)).astype(np.float32)
    x[:, :repeat] = x[:, :1]
    jy, jaux = _jax_apply_moe(lp_j, jnp.asarray(x), cfg=JCFG)
    ty, taux = tmoe.apply_moe(lp_t, torch.tensor(x), TCFG)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)
    if repeat:
        assert drops["dropped"] > 0


# ------------------------------------------------------ the model runner

PS, NP = 8, 40


def test_prefill_pack_drops_a_later_segment(weights, drops):
    """One packed prefill of two segments in a 64-token bucket (C = 40):
    segment 0 opens with 44 copies of one token, whose identical hidden
    states all pick the same two experts, so segment 1's assignments to
    them are dropped; the padding routes and takes slots as well. Sampled
    tokens exactly, logits' tokens and pools (page 0 excluded) within
    1e-4."""
    jp, tp = weights
    rng = np.random.default_rng(6)
    lens = [50, 11]
    seg0 = np.concatenate([np.full(44, 7), rng.integers(1, JCFG.vocab, 6)])
    toks_all = np.concatenate([seg0, rng.integers(1, JCFG.vocab, lens[1])])
    S = 64
    tok = np.zeros(S, np.int32)
    seg = np.full(S, -1, np.int32)
    pos = np.zeros(S, np.int32)
    dpage = np.zeros(S, np.int32)
    dslot = np.zeros(S, np.int32)
    pages = [list(range(1, 8)), [8, 9]]
    off = 0
    for j, n in enumerate(lens):
        idx = np.arange(n)
        tok[off:off + n] = toks_all[off:off + n]
        seg[off:off + n] = j
        pos[off:off + n] = idx
        dpage[off:off + n] = np.asarray(pages[j])[idx // PS]
        dslot[off:off + n] = idx % PS
        off += n
    past = np.zeros(1, np.int32)
    segs = dict(past_start=np.zeros(2, np.int32),
                past_len=np.zeros(2, np.int32),
                last_idx=np.array([lens[0] - 1, off - 1], np.int32),
                temps=np.array([0.0, 0.9], np.float32),
                top_ks=np.array([0, 0], np.int32),
                seeds=np.array([0, 3], np.int32),
                sample_pos=np.array(lens, np.int32))
    jk, jv = jmr.init_kv_pool(JCFG, NP, PS, jnp.float32)
    jt, jk, jv = jmr.prefill_pack_step(
        jp, *(jnp.asarray(a) for a in (tok, seg, pos, dpage, dslot)), jk, jv,
        jnp.asarray(past), *(jnp.asarray(a) for a in segs.values()),
        jax.random.PRNGKey(0), cfg=JCFG, page_size=PS)
    i64 = lambda a: torch.tensor(a.astype(np.int64))            # noqa: E731
    tk, tv = tmr.init_kv_pool(TCFG, NP, PS, torch.float32, "cpu")
    tt, tk, tv = tmr.prefill_pack_step(
        tp, i64(tok), i64(seg), i64(pos), i64(dpage), i64(dslot), tk, tv,
        i64(past), *(i64(segs[k]) for k in ("past_start", "past_len",
                                              "last_idx")),
        torch.tensor(segs["temps"]), torch.tensor(segs["top_ks"]),
        torch.tensor(segs["seeds"]), torch.tensor(segs["sample_pos"]),
        prng_key(0), cfg=TCFG, page_size=PS)
    assert tt.tolist() == np.asarray(jt).tolist()
    for t, j in zip((tk, tv), (jk, jv)):
        np.testing.assert_allclose(t[:, 1:].numpy(), np.asarray(j)[:, 1:],
                                   **STEP_TOL)
    assert drops["dropped"] > 0
    # the drops reach segment 1: its tokens' FFN outputs differ from a
    # pack that holds segment 1 alone
    x = torch.zeros(1, S, TCFG.d_model)
    x[0, :off] = tp["embedding"][i64(tok[:off])]
    x[0, :44] = x[0, :1]
    lp = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    both = tmoe.apply_moe(lp, x, TCFG)[0][0, lens[0]:off]
    alone = tmoe.apply_moe(lp, torch.cat([x[:, lens[0]:off],
                                          torch.zeros(1, S - lens[1],
                                                      TCFG.d_model)], 1),
                           TCFG)[0][0, :lens[1]]
    assert not torch.allclose(both, alone)


# ---------------------------------------------------------------- engine

def _specs(vocab: int):
    """(prompt, sampling) pairs: request 0 opens with a run of 100 equal
    tokens, which fills two experts past any prefill bucket's capacity;
    greedy, seeded-temperature and top-k rows."""
    rng = np.random.default_rng(2)
    tok = lambda n: tuple(int(t) for t in rng.integers(1, vocab, n))  # noqa
    return [((7,) * 100 + tok(8), dict(max_new_tokens=6)),
            (tok(23), dict(max_new_tokens=5, temperature=0.7, top_k=3,
                           seed=1)),
            (tok(9), dict(max_new_tokens=7, temperature=1.1, seed=4)),
            (tok(31), dict(max_new_tokens=4)),
            (tok(17), dict(max_new_tokens=6, temperature=0.4, top_k=8))]


def _generate(eng, R, SP):
    res = eng.generate([R(prompt_tokens=p, sampling=SP(**kw))
                        for p, kw in _specs(JCFG.vocab)])
    return [(tuple(r.output_tokens), r.finish_reason.value, r.cached_tokens)
            for r in res]


@pytest.mark.parametrize("packed,spec", [(True, 0), (False, 0),
                                         (True, K_SPEC), (False, K_SPEC)])
def test_engine_streams_match_jax(weights, drops, packed, spec):
    """The port's MoE engine gives the JAX engine's tokens, finish reasons
    and cached counts; with speculation the target drafts for itself."""
    jp, tp = weights
    kw = dict(ECFG, packed_prefill=packed, spec_k=spec)
    draft_j = dict(draft_cfg=JCFG, draft_params=jp) if spec else {}
    draft_t = dict(draft_cfg=TCFG, draft_params=tp) if spec else {}
    jout = _generate(JaxEngine(JCFG, jp, JaxEngineConfig(**kw), seed=0,
                               **draft_j), JaxGenRequest, JaxSamplingParams)
    teng = Engine(TCFG, tp, EngineConfig(**kw), seed=0, device="cpu",
                  **draft_t)
    tout = _generate(teng, GenRequest, SamplingParams)
    assert tout == jout
    assert drops["dropped"] > 0
    if spec:
        assert teng.backend.spec_dispatches > 0


def test_replica_decisions_match_jax_backend(weights):
    """`tests/test_replica_parity.py`'s trace over the MoE model:
    byte-identical decision streams and cached counts."""
    jp, tp = weights
    trace = rp._trace(JCFG.vocab)
    CFG = rp.CFG
    jb = JaxPagedBackend(JCFG, jp, n_pages=CFG.n_pages,
                         page_size=CFG.page_size, prefill_pad=16)
    jcore = JaxReplicaCore(CFG, jb)
    jb.bind(jcore)
    jcached = rp._drive(jcore, trace)
    tb = TorchPagedBackend(TCFG, tp, n_pages=CFG.n_pages,
                           page_size=CFG.page_size, device="cpu",
                           prefill_pad=16)
    tcore = ReplicaCore(ReplicaCoreConfig(**dataclasses.asdict(CFG)), tb)
    tb.bind(tcore)
    tcached = _drive_torch(tcore, trace)
    assert repr(tcore.decisions).encode() == repr(jcore.decisions).encode()
    assert tcached == jcached
    assert tcore.completions == jcore.completions == 6
