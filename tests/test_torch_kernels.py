"""The port's plain `paged_decode_ref` against the JAX oracle
(`repro.kernels.ref.paged_decode_ref`) AND the Pallas kernel run in
interpret mode, on the shapes of `tests/test_kernels.py` including the
ragged and garbage-table cases, in fp32 (2e-5) and bf16 (2e-2); and the
device dispatch of `repro_torch.kernels.ops`: the plain version for CPU
tensors only, the CUDA wrapper otherwise, no fallback between them. The
CUDA kernel's split-KV plan (`split_plan`, `split_ranges`): every live
page covered by exactly one split, from shapes alone; and a torch
emulation of its split-then-combine arithmetic at Q = 1 (rounds of the
online softmax, the merge of the live splits) against the plain version
and the Pallas kernel, at split edges, over a whole table and with
garbage tables."""
from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_decode as pallas_paged_decode
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import paged_decode as cuda_decode_module
from repro_torch.kernels.paged_decode import (BLOCKS_PER_SM, ROUND_BYTES,
                                              ROUND_SLOTS, TILE_BYTES,
                                              split_plan, split_ranges)
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


# --------------------------------------- the decode kernel's split-KV plan

@pytest.mark.parametrize("B,K,npg,page,hd,itemsize", [
    (4, 8, 32, 16, 128, 2),      # a captured decode step, bf16
    (4, 8, 32, 16, 128, 4),      # ... fp32
    (8, 8, 188, 16, 128, 2),     # lens up to 3001
    (8, 8, 128, 16, 128, 2),     # the engine's batch of 8, 2048 tokens
    (1, 8, 188, 16, 128, 2),     # one sequence
    (1, 8, 1024, 16, 128, 2),    # one sequence over the full-width pool
    (64, 8, 128, 16, 128, 4),    # more (sequence, head) pairs than blocks
    (3, 2, 5, 8, 32, 4),
    (2, 4, 7, 3, 8, 2),          # a page that does not divide a round
    (1, 1, 3, 128, 32, 2),       # a page wider than a round
    (2, 1, 1, 8, 256, 4),        # a page of 8 KB, the page-tile limit
])
@pytest.mark.parametrize("sms", [132, 114])    # H100 SXM, H100 PCIe
def test_decode_split_plan_covers_live_pages_once(B, K, npg, page, hd,
                                                  itemsize, sms):
    """From the shapes alone, at the decode kernel's limits: rounds within
    ROUND_SLOTS slots and ROUND_BYTES of K (or one page, at most
    TILE_BYTES), splits a whole number of rounds that cover the table, no
    more than BLOCKS_PER_SM blocks per SM unless B*K alone is more. Then,
    for every length up to past the table's end, the live splits cover
    the live pages [0, min(ceil(len/page), npg)) exactly once, in order,
    and none reaches an entry past the ragged edge."""
    ppr, chunk, n_split = split_plan(B, K, npg, page, hd, itemsize, sms)
    assert ppr >= 1 and chunk % ppr == 0 and chunk * n_split >= npg
    assert ppr * page <= max(ROUND_SLOTS, page)
    assert ppr * page * hd * itemsize <= max(ROUND_BYTES, TILE_BYTES)
    assert B * K * n_split <= max(BLOCKS_PER_SM * sms, B * K)
    for length in range(1, npg * page + 2 * page):
        n_live = min(-(-length // page), npg)
        ranges = split_ranges(length, page, npg, chunk, n_split)
        covered = [j for p0, p1 in ranges for j in range(p0, p1)]
        assert covered == list(range(n_live))
        assert all(p1 > p0 and p1 <= -(-length // page) for p0, p1 in ranges)


def test_decode_plan_reads_no_lens_on_the_host():
    """The wrapper sizes its plan from shapes and the SM count only: it
    never brings seq_lens to the host (no sync on the engine's step)."""
    src = inspect.getsource(cuda_decode_module.paged_decode)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy("):
        assert call not in src


def _decode_split_emulation(q, kp, vp, bt, lens, ppr, chunk, n_split):
    """The decode kernel's arithmetic, in fp32 on the inputs upcast: for
    each (sequence, KV head, live split) an online softmax over the
    split's rounds of `ppr` pages (running max from the finite -2e38, the
    round's rescale exp(m - m_new) of l and acc), then the combine's merge
    of the live splits: M the largest m, out = sum exp(m - M) acc / max(sum
    exp(m - M) l, 1e-30). Only live table entries are read."""
    B, H, hd = q.shape
    _, page, K, _ = kp.shape
    G, npg = H // K, bt.shape[1]
    qf = q.float().reshape(B, K, G, hd)
    kf, vf = kp.float(), vp.float()
    out = torch.empty(B, K, G, hd)
    for b in range(B):
        n = int(lens[b])
        parts = []
        for p0, p1 in split_ranges(n, page, npg, chunk, n_split):
            m = torch.full((K, G), tref.NEG_INF)
            l, acc = torch.zeros(K, G), torch.zeros(K, G, hd)
            for r0 in range(p0, p1, ppr):
                pos = torch.arange(r0 * page, min(min(r0 + ppr, p1) * page,
                                                  n))
                pages = bt[b, pos // page].long()
                k, v = kf[pages, pos % page], vf[pages, pos % page]
                s = torch.einsum("kgh,nkh->kgn", qf[b], k) * hd ** -0.5
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("kgn,nkh->kgh",
                                                            p, v)
                m = m_new
            parts.append((m, l, acc))
        M = parts[0][0]
        for m, _, _ in parts[1:]:
            M = torch.maximum(M, m)
        num, den = torch.zeros(K, G, hd), torch.zeros(K, G)
        for m, l, acc in parts:
            w = torch.exp(m - M)
            num += w[..., None] * acc
            den += w * l
        out[b] = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def _emulate_and_check(args, dtype, plan=None):
    """The emulation at `plan` (ppr, chunk, n_split; default the decode
    plan at 132 SMs) against the plain version and the Pallas kernel in
    interpret mode, at TOL."""
    q, kp, vp, bt, lens = args
    t_args = [torch.tensor(q).to(TDT[dtype]), torch.tensor(kp).to(TDT[dtype]),
              torch.tensor(vp).to(TDT[dtype]), torch.tensor(bt),
              torch.tensor(lens)]
    B, H, hd = q.shape
    _, page, K, _ = kp.shape
    if plan is None:
        plan = split_plan(B, K, bt.shape[1], page, hd,
                          t_args[0].element_size(), 132)
    got = _decode_split_emulation(*t_args, *plan)
    assert got.dtype == TDT[dtype] and got.shape == q.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(),
                               tref.paged_decode_ref(*t_args).float(),
                               atol=tol, rtol=tol)
    j_args = [jnp.asarray(q, JDT[dtype]), jnp.asarray(kp, JDT[dtype]),
              jnp.asarray(vp, JDT[dtype]), jnp.asarray(bt), jnp.asarray(lens)]
    want = np.asarray(pallas_paged_decode(*j_args, interpret=True),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,K,hd,page,Ptot,npg", [
    (2, 4, 4, 32, 8, 16, 4),
    (3, 8, 2, 64, 16, 32, 8),    # GQA
    (1, 4, 1, 32, 8, 8, 2),      # MQA
])
@pytest.mark.parametrize("plan", [(1, 1, None), (1, 2, None), (2, 2, None),
                                  None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_emulation_matches_oracle(B, H, K, hd, page, Ptot, npg,
                                               plan, dtype):
    """Splits of one page and of two, rounds of one page and of two, and
    the plan's own sizes, merged by the combine, equal the plain version
    and the Pallas kernel at the kernels' tolerance; garbage past every
    ragged edge."""
    if plan is not None:
        plan = (plan[0], plan[1], -(-npg // plan[1]))
    _emulate_and_check(_inputs(B, H, K, hd, page, Ptot, npg, poison=True),
                       dtype, plan)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_emulation_at_split_edges(dtype):
    """Lens at a split boundary -1, 0, +1 (splits of 2 pages of 8 slots:
    boundaries every 16 tokens), len 1, and one sequence over the whole
    table, with arbitrary int32 past every ragged edge."""
    page, npg, chunk = 8, 6, 2
    E = chunk * page
    lens = [1, E - 1, E, E + 1, 2 * E - 1, 2 * E, 2 * E + 1, npg * page]
    args = _inputs(len(lens), 8, 2, 32, page, 48, npg, lens=lens,
                   poison=True)
    _emulate_and_check(args, dtype, (1, chunk, -(-npg // chunk)))
    _emulate_and_check(args, dtype, (2, chunk, -(-npg // chunk)))


def test_decode_split_emulation_one_sequence_over_the_table():
    """One sequence whose live pages are the whole table, each page a
    split of its own and at the plan's size, fp32."""
    page, npg = 4, 12
    args = _inputs(1, 4, 2, 16, page, npg, npg, lens=[npg * page])
    args[3][0] = np.random.default_rng(7).permutation(npg)
    _emulate_and_check(args, "float32", (1, 1, npg))
    _emulate_and_check(args, "float32")
