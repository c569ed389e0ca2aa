"""The port's plain `ssd_scan_ref` (the token-by-token scan) against the
JAX oracle (`repro.kernels.ref.ssd_scan_ref`) AND the chunked Pallas kernel
run in interpret mode, on the sweep of `tests/test_kernels.py` (G > 1, N =
24, chunks of 16, 32 and 48) and its chunk-invariance case, at its
tolerances (atol 5e-5, rtol 5e-4); the device dispatch of `ops.ssd_scan`;
and the CUDA wrapper's input checks, which refuse what the JAX kernel
refuses before anything is built."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as cuda_ssd

RNG = np.random.default_rng(42)
ATOL, RTOL = 5e-5, 5e-4


def _inputs(B, H, S, P, G, N, a_hi=4.0):
    """Drawn as `tests/test_kernels.py` draws them: dt ~ U(0.01, 0.2),
    a ~ -U(0.5, a_hi)."""
    f32 = np.float32
    return [RNG.normal(size=(B, H, S, P)).astype(f32),
            RNG.uniform(0.01, 0.2, size=(B, H, S)).astype(f32),
            -RNG.uniform(0.5, a_hi, size=(H,)).astype(f32),
            RNG.normal(size=(B, G, S, N)).astype(f32),
            RNG.normal(size=(B, G, S, N)).astype(f32)]


def _port(arrays, chunk):
    t_args = [torch.tensor(a) for a in arrays]
    got = tref.ssd_scan_ref(*t_args, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == t_args[0].shape
    # dispatch by device: CPU tensors take the plain version
    np.testing.assert_array_equal(
        ops.ssd_scan(*t_args, chunk=chunk).numpy(), got.numpy())
    return got.numpy()


@pytest.mark.parametrize("B,H,S,P,G,N,chunk", [
    (1, 2, 64, 16, 1, 16, 16),
    (2, 4, 128, 16, 2, 24, 32),
    (1, 8, 96, 8, 4, 16, 48),      # 2 chunks of 48
])
def test_ssd_scan_ref_sweep(B, H, S, P, G, N, chunk):
    arrays = _inputs(B, H, S, P, G, N)
    got = _port(arrays, chunk)
    j_args = [jnp.asarray(a) for a in arrays]
    want_oracle = np.asarray(jref.ssd_scan_ref(*j_args, chunk=chunk))
    want_pallas = np.asarray(pallas_ssd(*j_args, chunk=chunk,
                                        interpret=True))
    np.testing.assert_allclose(got, want_oracle, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("chunk", [16, 32, 48, 96])
def test_ssd_scan_ref_matches_every_chunk(chunk):
    """`tests/test_kernels.py`'s chunk-invariance shape: the plain scan
    equals the chunked Pallas kernel at every chunk length."""
    arrays = _inputs(1, 2, 96, 8, 1, 16, a_hi=2.0)
    got = _port(arrays, chunk)
    want = np.asarray(pallas_ssd(*[jnp.asarray(a) for a in arrays],
                                 chunk=chunk, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the {name} kernel was built")
    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("change,match", [
    (dict(S=100), "chunk"),                        # S % chunk != 0
    (dict(H=6, G=4), "multiple of G"),             # H % G != 0
    (dict(dtype=torch.bfloat16), "fp32"),
    (dict(dtype=torch.float64), "fp32"),
    (dict(P=256), "P <= 128"),
])
def test_wrapper_refuses_what_the_jax_kernel_refuses(no_build, change, match):
    shape = dict(B=1, H=4, S=64, P=16, G=2, N=8)
    dtype = change.pop("dtype", torch.float32)
    shape.update(change)
    args = [torch.tensor(a).to(dtype) for a in _inputs(**shape)]
    with pytest.raises(ValueError, match=match):
        cuda_ssd.ssd_scan(*args, chunk=32)


def test_wrapper_refuses_cpu_tensors(no_build):
    args = [torch.tensor(a) for a in _inputs(1, 4, 64, 16, 2, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ssd.ssd_scan(*args, chunk=32)
    assert cuda_ssd.ssd_scan.launches == 0
