"""The port's plain `paged_decode_ref` against the JAX oracle
(`repro.kernels.ref.paged_decode_ref`) AND the Pallas kernel run in
interpret mode, on the shapes of `tests/test_kernels.py` including the
ragged and garbage-table cases, in fp32 (2e-5) and bf16 (2e-2); and the
device dispatch of `repro_torch.kernels.ops`: the plain version for CPU
tensors only, the CUDA wrapper otherwise, no fallback between them."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_decode as pallas_paged_decode
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_decode import paged_decode as cuda_paged_decode

RNG = np.random.default_rng(42)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(B, H, K, hd, page, Ptot, npg, lens=None, poison=False):
    q = RNG.normal(size=(B, H, hd)).astype(np.float32)
    kp = RNG.normal(size=(Ptot, page, K, hd)).astype(np.float32)
    vp = RNG.normal(size=(Ptot, page, K, hd)).astype(np.float32)
    bt = RNG.integers(0, Ptot, size=(B, npg)).astype(np.int32)
    if lens is None:
        lens = RNG.integers(1, npg * page + 1, size=(B,))
    lens = np.asarray(lens, np.int32)
    if poison:                     # arbitrary int32 past every ragged edge
        for i in range(B):
            live = (int(lens[i]) + page - 1) // page
            bt[i, live:] = RNG.integers(-(2 ** 31), 2 ** 31 - 1,
                                        size=npg - live)
    return q, kp, vp, bt, lens


def _check(args, dtype):
    q, kp, vp, bt, lens = args
    t_args = [torch.tensor(q).to(TDT[dtype]), torch.tensor(kp).to(TDT[dtype]),
              torch.tensor(vp).to(TDT[dtype]), torch.tensor(bt),
              torch.tensor(lens)]
    j_args = [jnp.asarray(q, JDT[dtype]), jnp.asarray(kp, JDT[dtype]),
              jnp.asarray(vp, JDT[dtype]), jnp.asarray(bt), jnp.asarray(lens)]
    got = tref.paged_decode_ref(*t_args)
    assert got.dtype == TDT[dtype] and got.shape == q.shape
    got = got.float().numpy()
    tol = TOL[dtype]
    want_oracle = np.asarray(jref.paged_decode_ref(*j_args), np.float32)
    want_pallas = np.asarray(pallas_paged_decode(*j_args, interpret=True),
                             np.float32)
    np.testing.assert_allclose(got, want_oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=tol)
    # dispatch by device: CPU tensors take the plain version
    np.testing.assert_array_equal(ops.paged_decode(*t_args).float().numpy(),
                                  got)


@pytest.mark.parametrize("B,H,K,hd,page,Ptot,npg", [
    (2, 4, 4, 32, 8, 16, 4),
    (3, 8, 2, 64, 16, 32, 8),    # GQA
    (1, 4, 1, 32, 8, 8, 2),      # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_ref_sweep(B, H, K, hd, page, Ptot, npg, dtype):
    _check(_inputs(B, H, K, hd, page, Ptot, npg), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_ref_length_edges(dtype):
    """len=1 (only the first slot) and len=full (every page used)."""
    _check(_inputs(2, 4, 2, 32, 8, 16, 4, lens=[1, 32]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_ref_ragged_garbage(dtype):
    """Lengths from one token to the full table, exact page multiples, and
    arbitrary int32 (out-of-range page ids) past every ragged edge."""
    page, npg = 8, 6
    lens = [1, page, page + 1, 2 * page + 3, npg * page - 1, npg * page]
    _check(_inputs(6, 8, 2, 32, page, 24, npg, lens=lens, poison=True), dtype)


def test_garbage_entries_never_change_the_result():
    q, kp, vp, bt, lens = _inputs(1, 4, 2, 32, 8, 16, 4, lens=[12])
    bt1 = bt.copy()
    bt1[0, 2:] = [0, 0]
    bt2 = bt.copy()
    bt2[0, 2:] = [999, -7]
    t = [torch.tensor(a) for a in (q, kp, vp)]
    o1 = tref.paged_decode_ref(*t, torch.tensor(bt1), torch.tensor(lens))
    o2 = tref.paged_decode_ref(*t, torch.tensor(bt2), torch.tensor(lens))
    assert torch.equal(o1, o2)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the plain version: given
    CPU tensors it raises (it takes the card or nothing)."""
    q, kp, vp, bt, lens = (torch.tensor(a) for a in
                           _inputs(1, 4, 2, 32, 8, 16, 4))
    before = cuda_paged_decode.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_paged_decode(q, kp, vp, bt, lens)
    assert cuda_paged_decode.launches == before
