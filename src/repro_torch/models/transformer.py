"""Decoder-only transformer parameters (PyTorch port of the parameter
layout of `repro.models.transformer`: dense, MoE and early-fusion VLM).

Layer params are stacked along a leading L axis, as in the JAX package, so
one converted pytree drops in unchanged; the serving steps walk the stack
with a Python loop where JAX runs `lax.scan`. Init scales follow
`transformer.py:21-42`, `layers.py:44-53,67-73`, `attention.py:48-62` and
`moe.py:32-43`; the draws come from an explicit `torch.Generator` and so
differ from `jax.random`'s.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import init_attn
from repro_torch.models.layers import init_embed, init_mlp
from repro_torch.models.moe import init_moe


def init_params(cfg: ModelConfig, dtype=torch.bfloat16, device="cuda",
                generator: torch.Generator | None = None) -> dict:
    """Random weights for a dense, MoE or early-fusion VLM transformer,
    made on `device` from `generator` (a generator of that device; seed 0
    when None). On the "meta" device it gives the layout alone, each leaf
    in its own dtype: an MoE router is fp32 whatever `dtype`."""
    if generator is None and torch.device(device).type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    L, d = cfg.n_layers, cfg.d_model
    p = init_embed(cfg, dtype, device, generator)
    p["layers"] = {
        "ln1": torch.ones((L, d), dtype=dtype, device=device),
        "attn": init_attn(cfg, dtype, device, generator, lead=(L,)),
        "ln2": torch.ones((L, d), dtype=dtype, device=device),
    }
    ffn = init_moe if cfg.is_moe else init_mlp
    p["layers"]["moe" if cfg.is_moe else "mlp"] = ffn(
        cfg, dtype, device, generator, lead=(L,))
    p["final_norm"] = torch.ones((d,), dtype=dtype, device=device)
    return p


def layer(stack: dict, li: int) -> dict:
    """Layer `li`'s params as views into the L-stacked tree."""
    return {k: layer(v, li) if isinstance(v, dict) else v[li]
            for k, v in stack.items()}


def leaves(tree: dict):
    """The tensors of a param tree, depth first."""
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else (v,))


def param_count(params: dict) -> int:
    return sum(t.numel() for t in leaves(params))
