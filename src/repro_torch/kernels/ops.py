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
from repro_torch.kernels.page_copy import page_gather as _gather_cuda
from repro_torch.kernels.page_copy import page_scatter as _scatter_cuda
from repro_torch.kernels.paged_decode import paged_decode as _paged_cuda
from repro_torch.kernels.paged_verify import paged_verify as _verify_cuda


def paged_decode(q: torch.Tensor, k_pages, v_pages, block_table,
                 seq_lens) -> torch.Tensor:
    """q: (B,H,hd); pools (P,page,K,hd); block_table (B,NPG) int32;
    seq_lens (B,) int32 >= 1. Returns (B,H,hd) in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, k_pages, v_pages, block_table,
                                    seq_lens)
    return _paged_cuda(q, k_pages, v_pages, block_table, seq_lens)


def paged_verify(q: torch.Tensor, k_pages, v_pages, block_table,
                 seq_lens) -> torch.Tensor:
    """q: (B,Q,H,hd); pools (P,page,K,hd); block_table (B,NPG) int32;
    seq_lens (B,) int32 TOTAL tokens including the Q candidates, >= Q.
    Returns (B,Q,H,hd) in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_verify_ref(q, k_pages, v_pages, block_table,
                                    seq_lens)
    return _verify_cuda(q, k_pages, v_pages, block_table, seq_lens)


def page_gather(k_pages: torch.Tensor, v_pages: torch.Tensor,
                ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pull pages `ids` out of the (L,P,page,K,hd) pools into dense
    (N,L,page,K,hd) stacks (the demotion and export staging layout)."""
    if k_pages.device.type == "cpu":
        return (ref.page_gather_ref(k_pages, ids),
                ref.page_gather_ref(v_pages, ids))
    return _gather_cuda(k_pages, v_pages, ids)


def page_scatter(k_pages: torch.Tensor, v_pages: torch.Tensor,
                 k_stack: torch.Tensor, v_stack: torch.Tensor,
                 ids: torch.Tensor) -> None:
    """Write staged stacks back into the pools at page slots `ids` (unique),
    in place."""
    if k_pages.device.type == "cpu":
        ref.page_scatter_ref(k_pages, k_stack, ids)
        ref.page_scatter_ref(v_pages, v_stack, ids)
        return
    _scatter_cuda(k_pages, v_pages, k_stack, v_stack, ids)
