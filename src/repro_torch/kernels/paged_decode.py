"""Wrapper of the hand-written CUDA paged decode kernel
(`csrc/paged_decode.cu`), the port of the TPU kernel `paged_decode` in
`src/repro/kernels/paged_decode.py`.

The wrapper checks what the kernel takes, allocates the output with
`torch.empty`, launches on the current stream and raises if the launch
failed. `paged_decode.launches` counts launches. The plain version is
`ref.paged_decode_ref`; `ops.paged_decode` picks between them by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_SMEM_BYTES = 232_448           # per block on sm_90 (227 KB)
TILE_BYTES = 16 * 2 * 256          # 16-byte vectors x kMaxVec x kThreads
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    fn = lib.paged_decode_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.paged_decode_smem_bytes
    smem.argtypes = [ctypes.c_int] * 5
    smem.restype = ctypes.c_size_t
    return lib


def check_inputs(name: str, q, k_pages, v_pages, block_table,
                 seq_lens) -> None:
    """The checks both paged attention kernels make before a launch: one
    CUDA device, bf16 or fp32, int32 tables and lens, contiguous, 16-byte
    aligned, shapes that fit (q's leading axis is B, its last two H and
    hd), and a head_dim and page tile the kernels' staging takes."""
    tensors = (q, k_pages, v_pages, block_table, seq_lens)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{name} kernel: all tensors must be on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes bf16 or fp32, not {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{name} kernel: q, k_pages and v_pages must share "
                        f"one dtype")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name} kernel: block_table and seq_lens must be "
                        f"int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel: inputs must be contiguous")
    B, (H, hd) = q.shape[0], q.shape[-2:]
    _, page, K, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"{name} kernel: pool shapes {k_pages.shape}, "
                         f"{v_pages.shape} do not fit q {q.shape}")
    if H % K:
        raise ValueError(f"{name} kernel: H={H} is not a multiple of K={K}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or seq_lens.shape != (B,):
        raise ValueError(f"{name} kernel: block_table must be (B, NPG) and "
                         f"seq_lens (B,)")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"{name} kernel takes head_dim in 8..256, a "
                         f"multiple of 8; got {hd}")
    if page * hd * q.element_size() > TILE_BYTES:
        raise ValueError(f"{name} kernel: a page tile of {page} x {hd} "
                         f"{q.dtype} exceeds its {TILE_BYTES} B register "
                         f"staging")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError(f"{name} kernel: q and the pools must be 16-byte "
                         f"aligned")


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_table: torch.Tensor,
                 seq_lens: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k_pages/v_pages: (P,page,K,hd); block_table: (B,NPG)
    int32 — entries beyond each sequence's live page count are never read
    and may be garbage; seq_lens: (B,) int32, >= 1. Returns (B,H,hd) in
    q's dtype. All tensors on one CUDA device, contiguous."""
    check_inputs("paged_decode", q, k_pages, v_pages, block_table, seq_lens)
    if q.dim() != 3:
        raise ValueError(f"paged_decode kernel: q must be (B, H, hd); got "
                         f"{tuple(q.shape)}")
    B, H, hd = q.shape
    page, K = k_pages.shape[1], k_pages.shape[2]
    lib = _lib()
    smem = lib.paged_decode_smem_bytes(H, K, hd, page,
                                       block_table.shape[1])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged_decode kernel: page={page}, hd={hd}, "
                         f"G={H // K} need {smem} B of shared memory "
                         f"(> {MAX_SMEM_BYTES})")
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_decode_launch(
        DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, H, K, hd, page, block_table.shape[1],
        hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
