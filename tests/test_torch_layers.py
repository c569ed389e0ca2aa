"""Layer parity: the port's norms, RoPE, MLPs, attention projections and
masked SDPA against the JAX package's functions on the same numpy inputs,
in fp32, at atol = rtol = 1e-5."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(11)


def _x(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_rms_norm():
    x, s = _x(2, 5, 64), _x(64)
    _close(tlayers.rms_norm(torch.tensor(x), torch.tensor(s), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    x = _x(2, 7, 4, 16)
    pos = RNG.integers(0, 3000, size=(2, 7)).astype(np.int32)
    _close(tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("gated", [True, False])
def test_apply_mlp(gated):
    cfg = dataclasses.replace(get_config("llama31-8b-reduced"),
                              gated_mlp=gated)
    p = {"w_up": _x(64, 128) / 8, "w_down": _x(128, 64) / 11}
    if gated:
        p["w_gate"] = _x(64, 128) / 8
    x = _x(3, 64)
    _close(tlayers.apply_mlp({k: torch.tensor(v) for k, v in p.items()},
                             torch.tensor(x), cfg),
           jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), cfg))


def test_embed_and_logits_tied_and_untied():
    for name in ("qwen3-0.6b", "llama31-8b"):
        cfg = get_config(name).reduced()
        p = {"embedding": _x(cfg.vocab, cfg.d_model)}
        if not cfg.tie_embeddings:
            p["lm_head"] = _x(cfg.d_model, cfg.vocab)
        toks = RNG.integers(0, cfg.vocab, size=(2, 3)).astype(np.int64)
        tp = {k: torch.tensor(v) for k, v in p.items()}
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        h = tlayers.embed_tokens(tp, torch.tensor(toks), cfg)
        _close(h, jlayers.embed_tokens(jp, jnp.asarray(toks), cfg))
        _close(tlayers.lm_logits(tp, h, cfg),
               jlayers.lm_logits(jp, jnp.asarray(h.numpy()), cfg))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "llama31-8b"])
def test_projections(name):
    """q/kv projections with RoPE, and qk-norm where the config has it."""
    cfg = get_config(name).reduced()
    jcfg = jax_config(name).reduced()
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": _x(d, H, hd) / 8, "wk": _x(d, K, hd) / 8, "wv": _x(d, K, hd) / 8}
    if cfg.qk_norm:
        p["q_scale"], p["k_scale"] = 1 + _x(hd) / 4, 1 + _x(hd) / 4
    x = _x(2, 5, d)
    pos = RNG.integers(0, 500, size=(2, 5)).astype(np.int32)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _close(tattn._project_q(tp, torch.tensor(x), cfg, torch.tensor(pos), True),
           jattn._project_q(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), True))
    tk, tv = tattn._project_kv(tp, torch.tensor(x), cfg, torch.tensor(pos), True)
    jk, jv = jattn._project_kv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), True)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("mask_kind", ["causal", "ragged", "batch"])
def test_sdpa(mask_kind):
    cfg = get_config("llama31-8b-reduced")
    B, S, T, H, K, hd = 2, 6, 9, 4, 2, 16
    q, k, v = _x(B, S, H, hd), _x(B, T, K, hd), _x(B, T, K, hd)
    if mask_kind == "causal":
        mask = (np.arange(T)[None, :] <= np.arange(S)[:, None] + 3)[None, None]
    elif mask_kind == "ragged":
        mask = RNG.random((1, 1, S, T)) < 0.6
        mask[..., 0] = True
    else:
        mask = RNG.random((B, 1, S, T)) < 0.5
        mask[..., -1] = True
    _close(tattn._sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                       torch.tensor(mask), cfg),
           jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask), cfg))
