"""Wrapper of the hand-written CUDA paged decode kernel
(`csrc/paged_decode.cu`), the port of the TPU kernel `paged_decode` in
`src/repro/kernels/paged_decode.py`, and the split-KV plan that it shares
with the paged verify kernel.

The kernel splits each sequence's live pages over several blocks and
merges their partial softmaxes in a second pass. `split_plan` sizes the
splits from the shapes and the card's SM count alone (never from
`seq_lens`, whose values live on the device), within the limits each
kernel passes (decode: rounds of ROUND_SLOTS slots and ROUND_BYTES of K,
at most BLOCKS_PER_SM blocks per SM); `split_ranges` is the page range
each split covers, the arithmetic the kernels repeat on the device. The
wrapper checks what the kernel takes (`check_inputs`, shared with the
verify kernel), allocates the output and one fp32 scratch for the partials
with `torch.empty`, launches both kernels on the current stream and raises
if a launch failed; the plan at given shapes is memoised, since the engine
calls the wrapper once per layer of every decode step. The combine is
`split_combine_kernel` of `csrc/common.cuh`, shared with the verify
kernel. `paged_decode.launches` counts wrapper calls. The plain version is
`ref.paged_decode_ref`; `ops.paged_decode` picks between them by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_SMEM_BYTES = 232_448           # per block on sm_90 (227 KB)
TILE_BYTES = 8 * 1024              # one page of one KV head, at most
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUND_SLOTS = 32                   # KV slots per round of a block, at most
ROUND_BYTES = 8 * 1024             # bytes of one round's K (and V), at most
BLOCKS_PER_SM = 8                  # split blocks per launch, at most, per SM


@functools.cache
def split_plan(B: int, K: int, npg: int, page: int, hd: int, itemsize: int,
               sms: int, round_slots: int = ROUND_SLOTS,
               round_bytes: int = ROUND_BYTES,
               blocks_per_sm: int = BLOCKS_PER_SM) -> tuple[int, int, int]:
    """(ppr, chunk, n_split) from shapes and the card's `sms` alone: a
    block copies `ppr` pages per round (at most `round_slots` slots and
    `round_bytes` of K, or one page), owns `chunk` pages (a multiple of
    ppr) and each (sequence, KV head) gets `n_split` blocks, chunk *
    n_split >= npg. chunk is the smallest that keeps B * K * n_split within
    `blocks_per_sm` * sms. The defaults are the decode kernel's limits.
    A pure function of its arguments, memoised: the wrappers call it on
    every launch."""
    ppr = max(1, min(round_slots // page,
                     round_bytes // (page * hd * itemsize)))
    max_splits = max(1, blocks_per_sm * sms // max(1, B * K))
    chunk = ppr * max(1, -(-npg // (ppr * max_splits)))
    return ppr, chunk, max(1, -(-npg // chunk))


def split_ranges(length: int, page: int, npg: int, chunk: int,
                 n_split: int) -> list[tuple[int, int]]:
    """The table entries [p0, p1) that each live split of a sequence of
    `length` tokens reads, in split order: entries j < min(ceil(length /
    page), npg) only. A split whose range starts at or past them does no
    work, and the combine visits exactly the splits listed here."""
    n_live = min(-(-length // page), npg)
    return [(s * chunk, min((s + 1) * chunk, n_live))
            for s in range(n_split) if s * chunk < n_live]


@functools.cache
def sm_count(device: torch.device) -> int:
    """The number of SMs of the CUDA `device` (a property, no sync)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    fn = lib.paged_decode_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.paged_decode_smem_bytes
    smem.argtypes = [ctypes.c_int] * 7
    smem.restype = ctypes.c_size_t
    return lib


@functools.cache
def _launch_plan(B: int, H: int, K: int, hd: int, page: int, npg: int,
                 itemsize: int, sms: int) -> tuple[int, int, int]:
    """The decode kernel's (ppr, chunk, n_split) at these shapes, after
    checking that a split block's shared memory fits; memoised, so a
    launch at known shapes pays neither again."""
    ppr, chunk, n_split = split_plan(B, K, npg, page, hd, itemsize, sms)
    smem = _lib().paged_decode_smem_bytes(H, K, hd, page, ppr, chunk,
                                          itemsize)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged_decode kernel: page={page}, hd={hd}, "
                         f"G={H // K} need {smem} B of shared memory "
                         f"(> {MAX_SMEM_BYTES})")
    return ppr, chunk, n_split


def check_inputs(name: str, q, k_pages, v_pages, block_table,
                 seq_lens) -> None:
    """The checks both paged attention kernels make before a launch: one
    CUDA device, bf16 or fp32, int32 tables and lens, contiguous, 16-byte
    aligned, shapes that fit (q's leading axis is B, its last two H and
    hd), a head_dim the kernels' 16-byte copies take, and a page tile (one
    page of one KV head) of at most TILE_BYTES."""
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
                         f"{q.dtype} exceeds {TILE_BYTES} B")
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
    npg = block_table.shape[1]
    ppr, chunk, n_split = _launch_plan(B, H, K, hd, page, npg,
                                       q.element_size(), sm_count(q.device))
    out = torch.empty_like(q)
    if B == 0:
        return out
    # one fp32 scratch: the partials' acc (B, K, n_split, G, hd), then
    # their (m, l) (B, K, n_split, G, 2), 16-byte aligned since hd % 8 == 0
    n_acc = B * H * n_split * hd
    scratch = torch.empty(n_acc + B * H * n_split * 2, dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().paged_decode_launch(
        DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * n_acc, out.data_ptr(),
        B, H, K, hd, page, npg, ppr, chunk, n_split, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
