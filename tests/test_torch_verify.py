"""The port's plain `paged_verify_ref` against the JAX oracle
(`repro.kernels.ref.paged_verify_ref`) AND the Pallas kernel run in
interpret mode, on the sweep of `tests/test_kernels.py` in fp32 (2e-5) and
bf16 (2e-2); Q=1 against the port's `paged_decode_ref`; causality within
the candidates; garbage table entries past the ragged edge; the device
dispatch of `ops.paged_verify` and the CUDA wrapper's refusal of CPU
tensors."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_verify import paged_verify as pallas_paged_verify
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_verify import paged_verify as cuda_paged_verify

RNG = np.random.default_rng(42)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(B, H, K, hd, page, Ptot, npg, Q, lens=None, poison=False):
    q = RNG.normal(size=(B, Q, H, hd)).astype(np.float32)
    kp = RNG.normal(size=(Ptot, page, K, hd)).astype(np.float32)
    vp = RNG.normal(size=(Ptot, page, K, hd)).astype(np.float32)
    bt = RNG.integers(0, Ptot, size=(B, npg)).astype(np.int32)
    if lens is None:               # ALL valid tokens, the Q candidates too
        lens = RNG.integers(Q, npg * page + 1, size=(B,))
    lens = np.asarray(lens, np.int32)
    if poison:                     # arbitrary int32 past every ragged edge
        for i in range(B):
            live = (int(lens[i]) + page - 1) // page
            bt[i, live:] = RNG.integers(-(2 ** 31), 2 ** 31 - 1,
                                        size=npg - live)
            bt[i, live:live + 1] = (-(2 ** 31) if i % 2 else 2 ** 31 - 1)
    return q, kp, vp, bt, lens


def _torch(args, dtype):
    q, kp, vp, bt, lens = args
    return [torch.tensor(q).to(TDT[dtype]), torch.tensor(kp).to(TDT[dtype]),
            torch.tensor(vp).to(TDT[dtype]), torch.tensor(bt),
            torch.tensor(lens)]


def _check(args, dtype):
    q, kp, vp, bt, lens = args
    t_args = _torch(args, dtype)
    j_args = [jnp.asarray(q, JDT[dtype]), jnp.asarray(kp, JDT[dtype]),
              jnp.asarray(vp, JDT[dtype]), jnp.asarray(bt), jnp.asarray(lens)]
    got = tref.paged_verify_ref(*t_args)
    assert got.dtype == TDT[dtype] and got.shape == q.shape
    got = got.float().numpy()
    tol = TOL[dtype]
    want_oracle = np.asarray(jref.paged_verify_ref(*j_args), np.float32)
    want_pallas = np.asarray(pallas_paged_verify(*j_args, interpret=True),
                             np.float32)
    np.testing.assert_allclose(got, want_oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=tol)
    # dispatch by device: CPU tensors take the plain version
    np.testing.assert_array_equal(ops.paged_verify(*t_args).float().numpy(),
                                  got)


@pytest.mark.parametrize("B,H,K,hd,page,Ptot,npg,Q", [
    (2, 4, 4, 32, 8, 16, 4, 2),
    (3, 8, 2, 64, 16, 32, 8, 4),   # GQA, k_spec=3
    (1, 4, 1, 32, 8, 8, 2, 3),     # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_verify_ref_sweep(B, H, K, hd, page, Ptot, npg, Q, dtype):
    _check(_inputs(B, H, K, hd, page, Ptot, npg, Q), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_verify_ref_ragged_garbage(dtype):
    """Lengths from Q (the candidates alone) to the full table, at and
    across page edges, with arbitrary int32 (the +-2**31 edges included)
    past every ragged edge."""
    page, npg, Q = 8, 6, 4
    lens = [Q, page, page + 1, 2 * page + 3, npg * page - 1, npg * page]
    _check(_inputs(6, 8, 2, 32, page, 24, npg, Q, lens=lens, poison=True),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_verify_q1_matches_paged_decode(dtype):
    """Q=1 is plain paged decode: same mask, same numbers, bit for bit in
    the plain versions (a transposed query fold would not be)."""
    q, kp, vp, bt, lens = _torch(
        _inputs(3, 8, 2, 32, 8, 16, 4, 1, lens=[1, 9, 32], poison=True),
        dtype)
    got = tref.paged_verify_ref(q, kp, vp, bt, lens)[:, 0]
    want = tref.paged_decode_ref(q[:, 0], kp, vp, bt, lens)
    assert torch.equal(got, want)


def test_paged_verify_causal_within_candidates():
    """Candidate j sees none of candidates j+1..Q-1: rewriting the later
    candidates' K/V, or dropping them from the query batch, cannot change
    query j's output."""
    B, H, K, hd, page, Ptot, npg, Q = 1, 4, 2, 32, 8, 16, 4, 4
    q, kp, vp, bt, lens = _torch(
        _inputs(B, H, K, hd, page, Ptot, npg, Q, lens=[19]), "float32")
    bt = torch.tensor([[3, 7, 11, 0]], dtype=torch.int32)
    full = tref.paged_verify_ref(q, kp, vp, bt, lens)
    for j in range(Q):
        # the first j+1 candidates only: total shrinks by Q-1-j
        part = tref.paged_verify_ref(q[:, :j + 1].contiguous(), kp, vp, bt,
                                     lens - (Q - 1 - j))
        torch.testing.assert_close(part[:, j], full[:, j], atol=1e-6,
                                   rtol=1e-6)
        # the later candidates' rows rewritten in the pool
        kp2, vp2 = kp.clone(), vp.clone()
        for pos in range(int(lens[0]) - Q + j + 1, int(lens[0])):
            kp2[bt[0, pos // page], pos % page] = 99.0
            vp2[bt[0, pos // page], pos % page] = -99.0
        out2 = tref.paged_verify_ref(q, kp2, vp2, bt, lens)
        assert torch.equal(out2[:, :j + 1], full[:, :j + 1])
        if j < Q - 1:
            assert not torch.equal(out2[:, j + 1:], full[:, j + 1:])


def test_garbage_entries_never_change_the_result():
    q, kp, vp, bt, lens = _torch(
        _inputs(1, 4, 2, 32, 8, 16, 4, 3, lens=[12]), "float32")
    bt1, bt2 = bt.clone(), bt.clone()
    bt1[0, 2:] = torch.tensor([0, 0], dtype=torch.int32)
    bt2[0, 2:] = torch.tensor([-(2 ** 31), 2 ** 31 - 1], dtype=torch.int32)
    assert torch.equal(tref.paged_verify_ref(q, kp, vp, bt1, lens),
                       tref.paged_verify_ref(q, kp, vp, bt2, lens))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the plain version: given
    CPU tensors it raises (it takes the card or nothing)."""
    args = _torch(_inputs(1, 4, 2, 32, 8, 16, 4, 2), "float32")
    before = cuda_paged_verify.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_paged_verify(*args)
    assert cuda_paged_verify.launches == before
