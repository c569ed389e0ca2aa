"""Wrapper of the hand-written CUDA Mamba2 SSD scan (`csrc/ssd_scan.cu`),
the port of the TPU kernel `ssd_scan` in `src/repro/kernels/ssd_scan.py`:
the chunked scan with a zero initial state, as four chunk-parallel passes
tied by global memory (C B^T once per group and chunk, each chunk's own
state, the state passing in chunk order, each chunk's output).

`check_inputs` takes the JAX kernel's domain (S % chunk == 0, H % G == 0,
fp32 throughout) and the port's (P <= 128; contiguous, one CUDA device),
and raises `ValueError` outside it before anything is built; the wrapper
raises it too when a chunk needs more shared memory than a block has. It
allocates y and the passes' fp32 scratch (C B^T per group and chunk, a
state per head and chunk padded to a multiple of 4 floats, the cumsum of
dt * a) with `torch.empty`, launches the passes on the current stream and
raises if a launch failed. `ssd_scan.launches` counts wrapper calls. The
plain version is `ref.ssd_scan_ref`; `ops.ssd_scan` picks between them by
the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import MAX_SMEM_BYTES

MAX_P = 128                        # the port's domain since its first kernel


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = lib.ssd_scan_smem_bytes
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_size_t
    return lib


def check_inputs(x, dt, a, B_, C_, chunk: int) -> None:
    """Raise ValueError unless the kernel takes these inputs: the shape and
    dtype checks come first, so an input the JAX kernel would refuse is
    named for its shape wherever it lies."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan kernel: x must be (B, H, S, P); got "
                         f"{tuple(x.shape)}")
    Bb, H, S, P = x.shape
    if B_.dim() != 4 or C_.shape != B_.shape or B_.shape[0] != Bb \
            or B_.shape[2] != S:
        raise ValueError(f"ssd_scan kernel: B_ and C_ must be (B, G, S, N) "
                         f"for x {tuple(x.shape)}; got {tuple(B_.shape)}, "
                         f"{tuple(C_.shape)}")
    G, N = B_.shape[1], B_.shape[3]
    if dt.shape != (Bb, H, S) or a.shape != (H,):
        raise ValueError(f"ssd_scan kernel: dt must be (B, H, S) and a (H,); "
                         f"got {tuple(dt.shape)}, {tuple(a.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan kernel: H={H} is not a multiple of G={G}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"ssd_scan kernel: S={S} is not a multiple of "
                         f"chunk={chunk}")
    tensors = (x, dt, a, B_, C_)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"ssd_scan kernel takes fp32 only; got "
                         f"{[str(t.dtype) for t in tensors]}")
    if not 0 < P <= MAX_P or N == 0:
        raise ValueError(f"ssd_scan kernel takes 0 < P <= {MAX_P} and N > 0; "
                         f"got P={P}, N={N}")
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"ssd_scan kernel: all tensors must be on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan kernel: inputs must be contiguous")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """x: (B,H,S,P) f32; dt: (B,H,S) f32 post-softplus; a: (H,) f32 < 0;
    B_/C_: (B,G,S,N) f32, each group broadcast over H//G heads; S % chunk
    == 0. Returns y: (B,H,S,P) f32, zero initial state."""
    check_inputs(x, dt, a, B_, C_, chunk)
    Bb, H, S, P = x.shape
    G, N = B_.shape[1], B_.shape[3]
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan kernel: chunk={chunk} needs {smem} B of "
                         f"shared memory (> {MAX_SMEM_BYTES})")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    nc = S // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((Bb, G, nc, chunk, chunk), **f32)
    st = torch.empty((Bb, H, nc, -(-N * P // 4) * 4), **f32)   # padded
    cum = torch.empty((Bb, H, S), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), y.data_ptr(), cb.data_ptr(), st.data_ptr(),
        cum.data_ptr(), Bb, H, G, S, P, N, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
