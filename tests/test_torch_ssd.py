"""The port's plain `ssd_scan_ref` (the token-by-token scan) against the
JAX oracle (`repro.kernels.ref.ssd_scan_ref`) AND the chunked Pallas kernel
run in interpret mode, on the sweep of `tests/test_kernels.py` (G > 1, N =
24, chunks of 16, 32 and 48) and its chunk-invariance case, at its
tolerances (atol 5e-5, rtol 5e-4); the device dispatch of `ops.ssd_scan`;
and the CUDA wrapper's input checks, which refuse what the JAX kernel
refuses before anything is built. A torch emulation of the CUDA kernel's
four passes (C B^T per group and chunk, each chunk's own state, the state
passing, each chunk's output in row and P tiles) against the plain scan
and the Pallas kernel, also where the cumsum passes -88 inside a
chunk."""
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


# ------------------------------------------ the CUDA kernel's four passes

TILE = 64       # the kernel's row tile (of a chunk) and P tile


def _ssd_passes(x, dt, a, B_, C_, chunk):
    """The CUDA kernel's four passes, in fp32 torch: (1) C B^T once per
    (batch, group, chunk); (2) per (batch, head, chunk) the cumsum of
    dt * a and the chunk's own state s_c[n][p] = sum_j B_j[n] exp(cum_end
    - cum_j) dt_j x_j[p]; (3) the states entering each chunk, h_0 = 0,
    h_{c+1} = exp(cum_end of c) h_c + s_c, in chunk order; (4) each chunk's
    output in 64-row tiles I and 64-column P tiles: exp(cum_i) C_i h_c
    plus sum over J <= I of (C B^T o exp(cum_i - cum_j) dt_j, j <= i) x_J.
    exp is only ever taken of a value <= 0: the test fails on any other."""
    def exp(t):
        assert bool((t <= 0).all()), "exp of a positive value"
        return torch.exp(t)

    Bb, H, S, P = x.shape
    G, N = B_.shape[1], B_.shape[3]
    Q, nc, hpg = chunk, S // chunk, H // G
    xc = x.reshape(Bb, H, nc, Q, P)
    dtc = dt.reshape(Bb, H, nc, Q)
    Bc = B_.reshape(Bb, G, nc, Q, N)
    Cc = C_.reshape(Bb, G, nc, Q, N)
    cb = torch.einsum("bgcin,bgcjn->bgcij", Cc, Bc)            # pass 1
    cum = torch.cumsum(dtc * a[None, :, None, None], -1)       # pass 2
    w = exp(cum[..., -1:] - cum) * dtc
    st = torch.einsum("bhcjn,bhcj,bhcjp->bhcnp",
                      Bc.repeat_interleave(hpg, 1), w, xc)
    h = torch.zeros(Bb, H, N, P)                                # pass 3
    hs = []
    for c in range(nc):
        hs.append(h)
        h = exp(cum[:, :, c, -1])[..., None, None] * h + st[:, :, c]
    hs = torch.stack(hs, 2)
    Ch, cbh = Cc.repeat_interleave(hpg, 1), cb.repeat_interleave(hpg, 1)
    y = torch.empty(Bb, H, nc, Q, P)                            # pass 4
    for p0 in range(0, P, TILE):
        ps = slice(p0, min(p0 + TILE, P))
        for i0 in range(0, Q, TILE):
            rows = torch.arange(i0, min(i0 + TILE, Q))
            acc = exp(cum[..., rows])[..., None] * torch.einsum(
                "bhcin,bhcnp->bhcip", Ch[..., rows, :], hs[..., ps])
            for j0 in range(0, i0 + 1, TILE):
                cols = torch.arange(j0, min(j0 + TILE, Q))
                keep = cols[None, :] <= rows[:, None]
                diff = cum[..., rows, None] - cum[..., None, cols]
                m = cbh[..., rows[:, None], cols[None, :]] * exp(
                    torch.where(keep, diff, 0.0)) * dtc[..., None, cols]
                acc = acc + torch.einsum("bhcij,bhcjp->bhcip",
                                         torch.where(keep, m, 0.0),
                                         xc[..., cols, ps])
            y[..., rows, ps] = acc
    return y.reshape(Bb, H, S, P)


def _check_passes(arrays, chunk):
    got = _ssd_passes(*[torch.tensor(a) for a in arrays], chunk=chunk)
    want = tref.ssd_scan_ref(*[torch.tensor(a) for a in arrays],
                             chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    pallas = np.asarray(pallas_ssd(*[jnp.asarray(a) for a in arrays],
                                   chunk=chunk, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,H,S,P,G,N,chunk", [
    (1, 2, 64, 16, 1, 16, 16),
    (2, 4, 128, 16, 2, 24, 32),
    (1, 8, 96, 8, 4, 16, 48),       # 2 chunks of 48
    (1, 2, 192, 24, 1, 16, 96),     # one row tile, a partial one
    (1, 4, 256, 72, 2, 24, 128),    # P = 64 + 8: a partial P tile
    (1, 2, 512, 16, 1, 32, 256),    # four row tiles, G = 1
    (1, 4, 512, 80, 4, 16, 256),    # G = H, P = 64 + 16
])
def test_pass_emulation_matches_the_scans(B, H, S, P, G, N, chunk):
    """The passes against the plain token-by-token scan and the Pallas
    kernel in interpret mode at atol 5e-5, rtol 5e-4: chunks 16 to 256, G =
    1 and G > 1, chunks of one, two and four 64-row tiles (and a partial
    one), P below, at and past a multiple of the 64-column P tile."""
    _check_passes(_inputs(B, H, S, P, G, N), chunk)


@pytest.mark.parametrize("chunk", [64, 128])
def test_pass_emulation_when_the_cumsum_passes_minus_88(chunk):
    """a ~ -U(0.5, 60): inside a chunk the cumsum of dt * a falls past -88,
    where exp(cum_i) * exp(-cum_j) would overflow fp32. The passes take
    exp of differences <= 0 only and hold the tolerance."""
    arrays = _inputs(1, 4, 2 * chunk, 16, 2, 16, a_hi=60.0)
    cum = np.cumsum((arrays[1] * arrays[2][None, :, None]).reshape(
        1, 4, 2, chunk), -1)
    assert cum.min() < -88                 # the case under test occurs
    _check_passes(arrays, chunk)
