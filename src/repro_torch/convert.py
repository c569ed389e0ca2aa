"""Weight bridge: the JAX package's param pytree, as numpy arrays, into the
port's tensors. The layouts are identical (L-stacked layers, head-major
attention weights), so this is a tree walk and a copy. Only tests hand it
JAX output; the port itself never sees JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_params


def from_jax_params(np_tree: dict, cfg: ModelConfig, device,
                    dtype) -> dict:
    """Convert `np_tree` (nested dicts of numpy arrays, e.g. the output of
    `jax.tree.map(np.asarray, params)`) and check it against the port's
    own layout for `cfg` in `dtype`: every key and shape must match, and
    each leaf takes the layout's dtype (`dtype`, but fp32 for an MoE
    router, as in the JAX package)."""
    want = init_params(cfg, dtype, "meta")

    def walk(src: dict, ref: dict, path: str) -> dict:
        if set(src) != set(ref):
            raise ValueError(f"{path or 'params'}: keys {sorted(src)} != "
                             f"expected {sorted(ref)}")
        out = {}
        for k, r in ref.items():
            if isinstance(r, dict):
                out[k] = walk(src[k], r, f"{path}/{k}")
                continue
            a = np.asarray(src[k], dtype=np.float32)
            if tuple(a.shape) != tuple(r.shape):
                raise ValueError(f"{path}/{k}: shape {a.shape} != expected "
                                 f"{tuple(r.shape)}")
            out[k] = torch.tensor(a, dtype=r.dtype, device=device)
        return out

    return walk(np_tree, want, "")
