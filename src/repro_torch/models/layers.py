"""Shared layers: norms, RoPE, MLPs, embeddings, init helpers (PyTorch port
of `repro.models.layers`, same math and the same fp32 islands)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def normal_init(shape, scale: float, dtype, device, generator) -> torch.Tensor:
    """fp32 normal draw from `generator`, scaled, then cast (the JAX init's
    order). The numbers differ from `jax.random`; only the scales match."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(hd/2,) inverse frequencies, in fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    base = torch.tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S). Pairs are
    (x[..., :hd/2], x[..., hd/2:]) (llama 'rotate_half' convention)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * inv              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP

def init_mlp(cfg: ModelConfig, dtype, device, generator, lead=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    scale_in = d ** -0.5
    scale_out = f ** -0.5 / (2 * max(cfg.n_layers, 1)) ** 0.5
    p = {"w_up": normal_init((*lead, d, f), scale_in, dtype, device, generator),
         "w_down": normal_init((*lead, f, d), scale_out, dtype, device,
                               generator)}
    if cfg.gated_mlp:
        p["w_gate"] = normal_init((*lead, d, f), scale_in, dtype, device,
                                  generator)
    return p


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.gated_mlp:
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
    return h @ p["w_down"]


# ---------------------------------------------------------------- embedding

def init_embed(cfg: ModelConfig, dtype, device, generator) -> dict:
    p = {"embedding": normal_init((cfg.vocab, cfg.d_model), 0.02, dtype,
                                  device, generator)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal_init((cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5, dtype, device,
                                   generator)
    return p


def embed_tokens(p: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return p["embedding"][tokens]


def lm_logits(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ p["embedding"].T
    return h @ p["lm_head"]
