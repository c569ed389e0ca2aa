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
from repro_torch.kernels.flash_attention import flash_attention as _flash_cuda
from repro_torch.kernels.page_copy import page_gather as _gather_cuda
from repro_torch.kernels.page_copy import page_scatter as _scatter_cuda
from repro_torch.kernels.paged_decode import paged_decode as _paged_cuda
from repro_torch.kernels.paged_verify import paged_verify as _verify_cuda
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,K,T,hd), H % K == 0. Returns (B,H,S,hd) in
    q's dtype; with `causal`, row s attends columns t <= s."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _flash_cuda(q, k, v, causal=causal)


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """The Mamba2 SSD scan, zero initial state. x: (B,H,S,P) f32; dt:
    (B,H,S) f32 post-softplus; a: (H,) f32 < 0; B_/C_: (B,G,S,N) f32;
    S % chunk == 0. Returns y: (B,H,S,P) f32."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a, B_, C_, chunk=chunk)
    return _ssd_cuda(x, dt, a, B_, C_, chunk=chunk)
