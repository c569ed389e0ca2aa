"""The port's plain `paged_verify_ref` against the JAX oracle
(`repro.kernels.ref.paged_verify_ref`) AND the Pallas kernel run in
interpret mode, on the sweep of `tests/test_kernels.py` in fp32 (2e-5) and
bf16 (2e-2); Q=1 against the port's `paged_decode_ref`; causality within
the candidates; garbage table entries past the ragged edge; the device
dispatch of `ops.paged_verify` and the CUDA wrapper's refusal of CPU
tensors. The CUDA kernel's split-KV plan (`split_plan`, `split_ranges`):
every live page is covered by exactly one split and no split reads a table
entry past the ragged edge; a torch emulation of its partial-then-combine
arithmetic against the oracle and the Pallas kernel, fully masked partials
and garbage tables included."""
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
from repro_torch.kernels.paged_verify import (BLOCKS_PER_SM, ROUND_BYTES,
                                              ROUND_SLOTS, split_plan,
                                              split_ranges)

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


# --------------------------------------------------- the kernel's split plan

@pytest.mark.parametrize("B,K,npg,page,hd,itemsize", [
    (4, 8, 32, 16, 128, 2),      # the captured verify step, bf16
    (4, 8, 32, 16, 128, 4),      # ... fp32
    (8, 8, 188, 16, 128, 2),     # lens up to 3001
    (1, 8, 1024, 16, 128, 2),    # one sequence over the full-width pool
    (64, 8, 128, 16, 128, 4),    # more (sequence, head) pairs than blocks
    (3, 2, 5, 8, 32, 4),
    (2, 4, 7, 3, 8, 2),          # a page that does not divide a round
    (1, 1, 3, 128, 32, 2),       # a page wider than a round
    (2, 1, 1, 16, 256, 4),
])
@pytest.mark.parametrize("sms", [132, 114])    # H100 SXM, H100 PCIe
def test_split_plan_covers_live_pages_once(B, K, npg, page, hd, itemsize,
                                           sms):
    """From the shapes alone: rounds within ROUND_SLOTS slots and
    ROUND_BYTES of K (or one page), splits a whole number of rounds that
    cover the table, and no more than BLOCKS_PER_SM blocks per SM unless
    B*K alone is more. Then, for every length up to past the table's end, the live
    splits cover the live pages [0, min(ceil(len/page), npg)) exactly once,
    in order, and none reaches an entry past the ragged edge."""
    ppr, chunk, n_split = split_plan(B, K, npg, page, hd, itemsize, sms)
    assert ppr >= 1 and chunk % ppr == 0 and chunk * n_split >= npg
    assert ppr * page <= max(ROUND_SLOTS, page)
    assert ppr * page * hd * itemsize <= max(ROUND_BYTES,
                                             page * hd * itemsize)
    assert B * K * n_split <= max(BLOCKS_PER_SM * sms, B * K)
    for length in range(1, npg * page + 2 * page):
        n_live = min(-(-length // page), npg)
        ranges = split_ranges(length, page, npg, chunk, n_split)
        covered = [j for p0, p1 in ranges for j in range(p0, p1)]
        assert covered == list(range(n_live))
        assert all(p1 > p0 and p1 <= -(-length // page) for p0, p1 in ranges)


def _split_emulation(q, kp, vp, bt, lens, chunk, n_split):
    """The split kernel's arithmetic, in fp32 on the inputs upcast: for each
    (sequence, KV head, live split) the partial (m, l, acc) of its G*Q rows
    (row g*Q + qi) over the split's positions, each row masked at its own
    causal limit with the finite -2e38, then the combine's merge in split
    order, M starting from split 0's m. A split holding no position that a
    row sees leaves that row m = -2e38, l = its slot count, acc = its sum
    of v, weighted by exp(-2e38 - M) = 0."""
    B, Q, H, hd = q.shape
    _, page, K, _ = kp.shape
    G, npg = H // K, bt.shape[1]
    R = G * Q
    qf = q.float().transpose(1, 2).reshape(B, K, R, hd)
    kf, vf = kp.float(), vp.float()
    qi = torch.arange(R) % Q
    out = torch.empty(B, K, R, hd)
    for b in range(B):
        n = int(lens[b])
        limit = n - Q + qi + 1                                     # (R,)
        parts = []
        for p0, p1 in split_ranges(n, page, npg, chunk, n_split):
            pos = torch.arange(p0 * page, min(p1 * page, n))
            pages = bt[b, pos // page].long()
            k = kf[pages, pos % page]                              # (n,K,hd)
            v = vf[pages, pos % page]
            s = torch.einsum("krh,nkh->krn", qf[b], k) * hd ** -0.5
            s = torch.where(pos[None, None, :] < limit[None, :, None], s,
                            tref.NEG_INF)
            m = s.amax(-1)                                          # (K,R)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("krn,nkh->krh", p, v)))
        M = parts[0][0]
        for m, _, _ in parts[1:]:
            M = torch.maximum(M, m)
        num, den = torch.zeros(K, R, hd), torch.zeros(K, R)
        for m, l, acc in parts:
            w = torch.exp(m - M)
            num += w[..., None] * acc
            den += w * l
        out[b] = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, K, G, Q, hd).permute(0, 3, 1, 2, 4).reshape(
        B, Q, H, hd).to(q.dtype)


@pytest.mark.parametrize("B,H,K,hd,page,Ptot,npg,Q", [
    (2, 4, 4, 32, 8, 16, 4, 2),
    (3, 8, 2, 64, 16, 32, 8, 4),   # GQA, k_spec=3
    (1, 4, 1, 32, 8, 8, 2, 3),     # MQA
])
@pytest.mark.parametrize("chunk", [1, 2, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_matches_oracle(B, H, K, hd, page, Ptot, npg, Q,
                                        chunk, dtype):
    """Partials of one page, of two, and of the plan's own size, merged by
    the combine, equal the plain version at the kernels' tolerance; the
    tables past every ragged edge hold arbitrary int32."""
    args = _torch(_inputs(B, H, K, hd, page, Ptot, npg, Q, poison=True),
                  dtype)
    if chunk is None:
        _, chunk, n_split = split_plan(B, K, npg, page, hd,
                                       args[0].element_size(), 132)
    else:
        n_split = -(-npg // chunk)
    got = _split_emulation(*args, chunk, n_split)
    want = tref.paged_verify_ref(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("lens,page,npg", [
    ([4, 4], 2, 3),          # len = Q: the candidates alone, over two pages
    ([5, 4], 1, 6),          # ... one slot per page
    ([13, 9], 4, 4),         # the last split holds candidates only
    ([4, 5, 6, 7], 4, 2),    # ... and len = Q .. Q + 3
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_fully_masked_partials(lens, page, npg, dtype):
    """One page per split, Q = 4: splits that hold only positions past some
    row's causal limit leave that row a fully masked partial (m = -2e38);
    the combine gives it weight 0, and the result is the plain version's,
    with garbage past every ragged edge."""
    Q = 4
    args = _torch(_inputs(len(lens), 8, 2, 32, page, 16, npg, Q, lens=lens,
                          poison=True), dtype)
    masked = 0
    for n in lens:
        for p0, _ in split_ranges(n, page, npg, 1, npg):
            masked += sum(p0 * page >= n - Q + qi + 1 for qi in range(Q))
    assert masked > 0                     # the case under test occurs
    got = _split_emulation(*args, 1, npg)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(),
                               tref.paged_verify_ref(*args).float(),
                               atol=tol, rtol=tol)


def test_split_emulation_matches_pallas_kernel():
    """The emulation against the JAX package's Pallas kernel in interpret
    mode: splits of one page, a fully masked last split (len 13 = three
    pages and one candidate) and garbage tables, fp32."""
    q, kp, vp, bt, lens = _inputs(3, 8, 2, 32, 4, 24, 5, 4,
                                  lens=[13, 4, 20], poison=True)
    j_args = [jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
              jnp.asarray(bt), jnp.asarray(lens)]
    want = np.asarray(pallas_paged_verify(*j_args, interpret=True),
                      np.float32)
    got = _split_emulation(*_torch((q, kp, vp, bt, lens), "float32"), 1, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"],
                               rtol=TOL["float32"])
