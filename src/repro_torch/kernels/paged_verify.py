"""Wrapper of the hand-written CUDA paged verify kernel
(`csrc/paged_verify.cu`), the port of the TPU kernel `paged_verify` in
`src/repro/kernels/paged_verify.py`: the multi-query target forward of
draft-k/verify-1 speculative decoding.

The wrapper checks what the kernel takes (`paged_decode.check_inputs`,
shared with the decode kernel), allocates the output with `torch.empty`,
launches on the current stream and raises if the launch failed.
`paged_verify.launches` counts launches. The plain version is
`ref.paged_verify_ref`; `ops.paged_verify` picks between them by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import (DTYPES, MAX_SMEM_BYTES,
                                              check_inputs)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_verify")
    fn = lib.paged_verify_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.paged_verify_smem_bytes
    smem.argtypes = [ctypes.c_int] * 6
    smem.restype = ctypes.c_size_t
    return lib


def paged_verify(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_table: torch.Tensor,
                 seq_lens: torch.Tensor) -> torch.Tensor:
    """q: (B,Q,H,hd); k_pages/v_pages: (P,page,K,hd); block_table: (B,NPG)
    int32 — entries beyond each sequence's live page count are never read
    and may be garbage; seq_lens: (B,) int32 TOTAL valid tokens including
    the Q candidates, >= Q. Returns (B,Q,H,hd) in q's dtype. All tensors
    on one CUDA device, contiguous."""
    check_inputs("paged_verify", q, k_pages, v_pages, block_table, seq_lens)
    if q.dim() != 4:
        raise ValueError(f"paged_verify kernel: q must be (B, Q, H, hd); got "
                         f"{tuple(q.shape)}")
    B, Q, H, hd = q.shape
    page, K = k_pages.shape[1], k_pages.shape[2]
    lib = _lib()
    smem = lib.paged_verify_smem_bytes(Q, H, K, hd, page,
                                       block_table.shape[1])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged_verify kernel: Q={Q}, page={page}, hd={hd}, "
                         f"G={H // K} need {smem} B of shared memory "
                         f"(> {MAX_SMEM_BYTES})")
    out = torch.empty_like(q)
    if B == 0 or Q == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_verify_launch(
        DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, Q, H, K, hd, page, block_table.shape[1],
        hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_verify kernel launch failed: CUDA error "
                           f"{err}")
    paged_verify.launches += 1
    return out


paged_verify.launches = 0
