"""Wrappers of the hand-written CUDA page copy kernels
(`csrc/page_copy.cu`), the ports of the TPU kernels `page_gather` and
`page_scatter` in `src/repro/kernels/page_copy.py`.

Each wrapper checks what the kernel takes, allocates its outputs with
`torch.empty`, launches ONE kernel that moves both pools on the current
stream, and raises if the launch failed. `page_gather.launches` and
`page_scatter.launches` count launches. The plain versions are
`ref.page_gather_ref` / `ref.page_scatter_ref`; `ops.page_gather` /
`ops.page_scatter` pick between them by the tensors' device.

The JAX backend pads each call to a power of two (the gather with page 0,
the scatter with the scratch page repeated) to bound jit recompiles. A CUDA
launch compiles nothing per shape, so the port launches on the N real ids
and pads nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("page_copy")
    for fn in (lib.page_gather_launch, lib.page_scatter_launch):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, k_pages, v_pages, k_stack, v_stack, ids) -> None:
    tensors = (k_pages, v_pages, ids) + tuple(
        t for t in (k_stack, v_stack) if t is not None)
    dev = k_pages.device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{name} kernel: all tensors must be on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if k_pages.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes bf16 or fp32 pools, not "
                        f"{k_pages.dtype}")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"{name} kernel: ids must be (N,) int32")
    if k_pages.dim() != 5 or v_pages.shape != k_pages.shape \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name} kernel: pools must be two (L, P, page, K, "
                         f"hd) tensors of one dtype; got {k_pages.shape}, "
                         f"{v_pages.shape}")
    L, _, page, K, hd = k_pages.shape
    want = (ids.shape[0], L, page, K, hd)
    for s in (k_stack, v_stack):
        if s is not None and (tuple(s.shape) != want
                              or s.dtype != k_pages.dtype):
            raise ValueError(f"{name} kernel: stacks must be {want} "
                             f"{k_pages.dtype}; got {tuple(s.shape)} "
                             f"{s.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel: inputs must be contiguous")
    if (page * K * hd * k_pages.element_size()) % 16 or any(
            t.data_ptr() % 16 for t in tensors if t is not ids):
        raise ValueError(f"{name} kernel copies 16-byte vectors: a page tile "
                         f"({page}x{K}x{hd} {k_pages.dtype}) must be a "
                         f"multiple of 16 bytes and every buffer 16-byte "
                         f"aligned")


def _launch(fn, k_pages, ids, *ptrs) -> None:
    L, P, page, K, hd = k_pages.shape
    err = fn(*ptrs, ids.data_ptr(), ids.shape[0], L, P,
             page * K * hd * k_pages.element_size(),
             torch.cuda.current_stream(k_pages.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"page copy kernel launch failed: CUDA error "
                           f"{err}")


def page_gather(k_pages: torch.Tensor, v_pages: torch.Tensor,
                ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """k_pages/v_pages: (L, P, page, K, hd); ids: (N,) int32 in [0, P) —
    an id outside that range is never dereferenced and its stack rows are
    left uninitialised, so callers check ids on the host. Returns (k_stack,
    v_stack), each (N, L, page, K, hd) in the pools' dtype."""
    _check("page_gather", k_pages, v_pages, None, None, ids)
    L, _, page, K, hd = k_pages.shape
    shape = (ids.shape[0], L, page, K, hd)
    k_stack = torch.empty(shape, dtype=k_pages.dtype, device=k_pages.device)
    v_stack = torch.empty_like(k_stack)
    if ids.shape[0] == 0:
        return k_stack, v_stack
    _launch(_lib().page_gather_launch, k_pages, ids, k_pages.data_ptr(),
            v_pages.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr())
    page_gather.launches += 1
    return k_stack, v_stack


def page_scatter(k_pages: torch.Tensor, v_pages: torch.Tensor,
                 k_stack: torch.Tensor, v_stack: torch.Tensor,
                 ids: torch.Tensor) -> None:
    """Inverse of `page_gather`: write the stacks (N, L, page, K, hd) into
    the pools at page slots `ids`, IN PLACE. Ids must be unique (blocks of
    a duplicate id race; which write lands is undefined) and in [0, P) (an
    id outside is skipped)."""
    _check("page_scatter", k_pages, v_pages, k_stack, v_stack, ids)
    if ids.shape[0] == 0:
        return
    _launch(_lib().page_scatter_launch, k_pages, ids, k_pages.data_ptr(),
            v_pages.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr())
    page_scatter.launches += 1


page_gather.launches = 0
page_scatter.launches = 0
