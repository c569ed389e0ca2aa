"""Wrapper of the hand-written CUDA flash attention kernel
(`csrc/flash_attention.cu`), the port of the TPU kernel `flash_attention`
in `src/repro/kernels/flash_attention.py`: dense causal or full GQA
attention, the prefill form.

`check_inputs` takes the JAX kernel's domain (H % K == 0; S and T
multiples of min(128, S) and min(128, T)) and the kernel's own (head_dim
16, 32, 64 or 128; bf16 or fp32; contiguous, 16-byte aligned, one CUDA
device), and raises `ValueError` outside it before anything is built. The
wrapper allocates the output with `torch.empty`, launches on the current
stream and raises if the launch failed. `flash_attention.launches` counts
launches. The plain version is `ref.flash_attention_ref`;
`ops.flash_attention` picks between them by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import DTYPES

HEAD_DIMS = (16, 32, 64, 128)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def check_inputs(q, k, v) -> None:
    """Raise ValueError unless the kernel takes (q, k, v): the shape and
    dtype checks come first, so a tensor the JAX kernel would refuse is
    named for its shape wherever it lies."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: q must be (B, H, S, hd) "
                         f"and k, v (B, K, T, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    Bk, K, T, hd_k = k.shape
    if Bk != B or hd_k != hd:
        raise ValueError(f"flash_attention kernel: k {tuple(k.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention kernel: H={H} is not a multiple "
                         f"of K={K}")
    for name, n in (("S", S), ("T", T)):
        if n == 0 or n % min(128, n):
            raise ValueError(f"flash_attention kernel: {name}={n} is not a "
                             f"multiple of min(128, {name})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}; got {hd}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes q, k and v in one "
                         f"dtype, bf16 or fp32; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    tensors = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention kernel: all tensors must be on "
                         f"one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention kernel: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention kernel: inputs must be 16-byte "
                         "aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,K,T,hd). Returns (B,H,S,hd) in q's dtype. With
    `causal`, row s attends columns t <= s (no offset when S != T)."""
    check_inputs(q, k, v)
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, H, K, S, T, hd, int(causal), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
