"""GQA attention pieces the paged serving path uses (PyTorch port of
`repro.models.attention`): q/kv projections with optional qk-norm and
RoPE, and the plain masked SDPA that prefill runs.

Projections are stored head-major — wq: (d, H, hd), wo: (H, hd, d) — as in
the JAX package, so converted weights drop in unchanged. Softmax runs in
fp32. The mask value is the finite NEG_INF (not -inf): packed prefill
relies on no row ever being all-masked, and a finite fill keeps even such
a row NaN-free.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, normal_init, rms_norm

NEG_INF = -2.0e38


def init_attn(cfg: ModelConfig, dtype, device, generator, lead=()) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s_in = d ** -0.5
    s_out = (H * hd) ** -0.5 / (2 * max(cfg.n_layers, 1)) ** 0.5
    p = {
        "wq": normal_init((*lead, d, H, hd), s_in, dtype, device, generator),
        "wk": normal_init((*lead, d, K, hd), s_in, dtype, device, generator),
        "wv": normal_init((*lead, d, K, hd), s_in, dtype, device, generator),
        "wo": normal_init((*lead, H, hd, d), s_out, dtype, device, generator),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.ones((*lead, hd), dtype=dtype, device=device)
        p["k_scale"] = torch.ones((*lead, hd), dtype=dtype, device=device)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_q(p, x, cfg: ModelConfig, positions, rope: bool):
    q = _heads(x, p["wq"])
    if cfg.qk_norm and "q_scale" in p:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(p, x, cfg: ModelConfig, positions, rope: bool):
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qk_norm and "k_scale" in p:
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: (B,S,H,hd)  k/v: (B,T,K,hd)  mask: broadcastable (B,1,S,T) bool.
    Scores are taken in the input dtype, then scaled and softmaxed in fp32;
    the probabilities are cast back to v's dtype for the PV product."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)       # (B,K,G,S,hd)
    kt = k.permute(0, 2, 3, 1).unsqueeze(2)                      # (B,K,1,hd,T)
    logits = torch.matmul(qg, kt).float() * hd ** -0.5           # (B,K,G,S,T)
    m = mask[:, :, None] if mask.dim() == 4 else mask
    logits = torch.where(m, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)                      # (B,K,1,T,hd)
    out = torch.matmul(probs, vt)                                # (B,K,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
