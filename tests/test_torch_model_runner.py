"""Model-runner parity: one packed prefill and several fused decode steps
on the same pools, the port against `repro.serving.model_runner`, from the
same converted fp32 weights. Logits and KV pools agree within 1e-4, the
sampled tokens and the advanced batch state exactly."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model
from repro.serving import model_runner as jmr
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.serving import model_runner as tmr
from repro_torch.serving.sampling import prng_key

TOL = dict(atol=1e-4, rtol=1e-4)
PS, NP = 8, 24
# the reference's one-token forward, compiled once per bucket shape rather
# than dispatched op by op
_jax_token_fwd = jax.jit(jmr._token_fwd, static_argnames=("cfg",))


@pytest.fixture(scope="module", params=["qwen3-0.6b", "llama31-8b"])
def models(request):
    jcfg = jax_config(request.param).reduced()
    jp = build_model(jcfg, jnp.float32).init(jax.random.PRNGKey(0))
    tcfg = get_config(request.param).reduced()
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                         torch.float32)
    return jcfg, jp, tcfg, tp


def _pools_close(t_pools, j_pools):
    for t, j in zip(t_pools, j_pools):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_prefill_pack_then_decode(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(5)
    # two segments: seq 0 has a 2-page cached prefix (pages 3, 4) already in
    # the pool, seq 1 none; scratch page 0 pads everything
    jk, jv = jmr.init_kv_pool(jcfg, NP, PS, jnp.float32)
    jk = jk.at[:, 3:5].set(jnp.asarray(
        rng.normal(size=(jcfg.n_layers, 2, PS, jcfg.n_kv_heads, jcfg.hd)),
        jnp.float32))
    tk = torch.tensor(np.asarray(jk))
    tv = torch.tensor(np.asarray(jv))
    pages = [[3, 4, 5, 6, 7], [8, 9, 10]]
    starts, ends = [16, 0], [27, 13]
    toks = rng.integers(0, jcfg.vocab, size=sum(e - s for s, e in
                                                 zip(starts, ends)))
    S = 32
    tok = np.zeros(S, np.int32)
    seg = np.full(S, -1, np.int32)
    pos = np.zeros(S, np.int32)
    dpage = np.zeros(S, np.int32)
    dslot = np.zeros(S, np.int32)
    off = 0
    for j, (s, e) in enumerate(zip(starts, ends)):
        idx = np.arange(s, e)
        tok[off:off + e - s] = toks[off:off + e - s]
        seg[off:off + e - s] = j
        pos[off:off + e - s] = idx
        dpage[off:off + e - s] = np.asarray(pages[j])[idx // PS]
        dslot[off:off + e - s] = idx % PS
        off += e - s
    past = np.array([3, 4, 0, 0], np.int32)
    seg_np = dict(past_start=np.array([0, 2 * PS], np.int32),
                  past_len=np.array(starts, np.int32),
                  last_idx=np.array([ends[0] - starts[0] - 1, off - 1],
                                    np.int32),
                  temps=np.array([0.0, 0.8], np.float32),
                  top_ks=np.array([0, 5], np.int32),
                  seeds=np.array([0, 4], np.int32),
                  sample_pos=np.array(ends, np.int32))
    jt, jk, jv = jmr.prefill_pack_step(
        jp, *(jnp.asarray(a) for a in (tok, seg, pos, dpage, dslot)), jk, jv,
        jnp.asarray(past), *(jnp.asarray(a) for a in seg_np.values()),
        jax.random.PRNGKey(0), cfg=jcfg, page_size=PS)
    i64 = lambda a: torch.tensor(a.astype(np.int64))            # noqa: E731
    tt, tk, tv = tmr.prefill_pack_step(
        tp, i64(tok), i64(seg), i64(pos), i64(dpage), i64(dslot), tk, tv,
        i64(past), i64(seg_np["past_start"]), i64(seg_np["past_len"]),
        i64(seg_np["last_idx"]), torch.tensor(seg_np["temps"]),
        torch.tensor(seg_np["top_ks"]), torch.tensor(seg_np["seeds"]),
        torch.tensor(seg_np["sample_pos"]), prng_key(0), cfg=tcfg,
        page_size=PS)
    assert tt.tolist() == np.asarray(jt).tolist()
    _pools_close((tk, tv), (jk, jv))

    # fused decode: a 4-row bucket over capacity state (row 2 inactive)
    bcap, npg_cap = 4, 8
    bt = np.zeros((bcap, npg_cap), np.int32)
    bt[0, :5], bt[1, :3] = pages[0], pages[1]
    state = dict(bt=bt,
                 lens=np.array([ends[0], ends[1], 0, 0], np.int32),
                 toks=np.array([int(jt[0]), int(jt[1]), 0, 0], np.int32),
                 temps=np.array([0.0, 1.3, 0, 0], np.float32),
                 top_ks=np.array([0, 0, 0, 0], np.int32),
                 seeds=np.array([2, 7, 0, 0], np.int32))
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.tensor(v) for k, v in state.items()}
    for step in range(4):
        # logits of the step's forward on identical pools
        nb, npgb = 4, 8 if step % 2 else 4
        lens_t = tstate["lens"][:nb]
        bt_t = tstate["bt"][:nb, :npgb].contiguous()
        pid = bt_t.gather(1, (lens_t // PS).long()[:, None])[:, 0].long()
        tl, _, _ = tmr._token_fwd(
            tp, tstate["toks"][:nb], lens_t, lens_t + 1, bt_t, pid,
            (lens_t % PS).long(), tk.clone(), tv.clone(), cfg=tcfg)
        lens_j = jstate["lens"][:nb]
        bt_j = jstate["bt"][:nb, :npgb]
        jl, _, _ = _jax_token_fwd(
            jp, jstate["toks"][:nb], lens_j, lens_j + 1, bt_j,
            bt_j[jnp.arange(nb), lens_j // PS], lens_j % PS, jk, jv, cfg=jcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

        jt, jstate, jk, jv = jmr.decode_step(
            jp, jstate, jk, jv, jax.random.PRNGKey(0), cfg=jcfg,
            page_size=PS, nb=nb, npgb=npgb)
        tt, tstate, tk, tv = tmr.decode_step(
            tp, tstate, tk, tv, prng_key(0), cfg=tcfg, page_size=PS,
            nb=nb, npgb=npgb)
        assert tt[:2].tolist() == np.asarray(jt)[:2].tolist()
        for k in ("lens", "toks"):
            assert tstate[k][:2].tolist() == np.asarray(jstate[k])[:2].tolist()
        _pools_close((tk[:, 1:], tv[:, 1:]), (jk[:, 1:], jv[:, 1:]))


def test_prefill_step_logits(models):
    """The one-request path: logits of the last suffix token, with a cached
    prefix page, and the pool rows it writes."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(8)
    jk, jv = jmr.init_kv_pool(jcfg, NP, PS, jnp.float32)
    jk = jk.at[:, 2].set(jnp.asarray(
        rng.normal(size=(jcfg.n_layers, PS, jcfg.n_kv_heads, jcfg.hd)),
        jnp.float32))
    tk, tv = torch.tensor(np.asarray(jk)), torch.tensor(np.asarray(jv))
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = rng.integers(0, jcfg.vocab, size=11)
    new_pages = np.array([5, 6], np.int32)
    past = np.array([2], np.int32)
    jl, jk, jv = jmr.prefill_step(
        jp, jnp.asarray(toks), jnp.asarray(new_pages), jk, jv,
        jnp.asarray(past), jnp.int32(PS), jnp.int32(11), cfg=jcfg,
        page_size=PS)
    tl, tk, tv = tmr.prefill_step(
        tp, torch.tensor(toks.astype(np.int64)),
        torch.tensor(new_pages.astype(np.int64)), tk, tv,
        torch.tensor(past.astype(np.int64)), PS, 11, cfg=tcfg, page_size=PS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _pools_close((tk, tv), (jk, jv))
