"""Kernel dispatch by the tensors' device. Model code imports this module,
not the kernels.

A CPU tensor goes to the plain PyTorch version (`ref`); a CUDA tensor goes
to the hand-written CUDA kernel, whose wrapper launches it or raises. There
is no fallback from one to the other and no switch: the device of the data
decides.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_decode import paged_decode as _paged_cuda


def paged_decode(q: torch.Tensor, k_pages, v_pages, block_table,
                 seq_lens) -> torch.Tensor:
    """q: (B,H,hd); pools (P,page,K,hd); block_table (B,NPG) int32;
    seq_lens (B,) int32 >= 1. Returns (B,H,hd) in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, k_pages, v_pages, block_table,
                                    seq_lens)
    return _paged_cuda(q, k_pages, v_pages, block_table, seq_lens)
