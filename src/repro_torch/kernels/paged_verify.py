"""Wrapper of the hand-written CUDA paged verify kernel
(`csrc/paged_verify.cu`), the port of the TPU kernel `paged_verify` in
`src/repro/kernels/paged_verify.py`: the multi-query target forward of
draft-k/verify-1 speculative decoding.

The kernel splits each sequence's live pages over several blocks and
merges their partial softmaxes in a second pass. `split_plan` is the plan
shared with the decode kernel (`paged_decode.split_plan`: from the shapes
and the card's SM count alone, never from `seq_lens`, whose values live on
the device) at verify's limits; `split_ranges` is the page range each
split covers, the arithmetic the kernel repeats on the device. The wrapper
checks what the kernel takes (`paged_decode.check_inputs`, shared with the
decode kernel), allocates the output and the fp32 partials with
`torch.empty`, launches both kernels on the current stream and raises if
a launch failed.
`paged_verify.launches` counts wrapper calls. The plain version is
`ref.paged_verify_ref`; `ops.paged_verify` picks between them by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import (DTYPES, MAX_SMEM_BYTES,
                                              check_inputs, sm_count,
                                              split_ranges)
from repro_torch.kernels.paged_decode import split_plan as _shared_plan

ROUND_SLOTS = 64                   # KV slots per round of a block, at most
ROUND_BYTES = 16 * 1024            # bytes of one round's K (and V), at most
BLOCKS_PER_SM = 4                  # split blocks per launch, at most, per SM


# paged_verify's plan: the shared split plan at verify's limits
split_plan = functools.partial(_shared_plan, round_slots=ROUND_SLOTS,
                               round_bytes=ROUND_BYTES,
                               blocks_per_sm=BLOCKS_PER_SM)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_verify")
    fn = lib.paged_verify_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.paged_verify_smem_bytes
    smem.argtypes = [ctypes.c_int] * 8
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
    npg = block_table.shape[1]
    ppr, chunk, n_split = split_plan(B, K, npg, page, hd, q.element_size(),
                                     sm_count(q.device))
    lib = _lib()
    smem = lib.paged_verify_smem_bytes(Q, H, K, hd, page, ppr, chunk,
                                       q.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged_verify kernel: Q={Q}, page={page}, hd={hd}, "
                         f"G={H // K} need {smem} B of shared memory "
                         f"(> {MAX_SMEM_BYTES})")
    out = torch.empty_like(q)
    if B == 0 or Q == 0:
        return out
    R = H // K * Q
    part_acc = torch.empty((B, K, n_split, R, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, K, n_split, R, 2), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_verify_launch(
        DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, Q, H, K,
        hd, page, npg, ppr, chunk, n_split, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_verify kernel launch failed: CUDA error "
                           f"{err}")
    paged_verify.launches += 1
    return out


paged_verify.launches = 0
