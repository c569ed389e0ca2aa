"""The port's plain page copies (`repro_torch.kernels.ref.page_gather_ref` /
`page_scatter_ref`) against the JAX oracle (`repro.kernels.ref`) and the
Pallas kernels run in interpret mode, bit for bit, in fp32 and bf16 (bf16
compared through int16 views); the device dispatch of
`repro_torch.kernels.ops` (the plain version for CPU tensors, in place);
and the CUDA wrappers' refusal of CPU tensors."""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.page_copy import page_gather as pallas_gather
from repro.kernels.page_copy import page_scatter as pallas_scatter
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.page_copy import page_gather as cuda_gather
from repro_torch.kernels.page_copy import page_scatter as cuda_scatter

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SHAPES = [(2, 6, 4, 2, 8), (3, 9, 8, 2, 16)]      # (L, P, page, K, hd)


def _pool(rng, shape, dtype):
    """The same values in both frameworks: fp32 from numpy, rounded to
    bf16 by each side's round-to-nearest-even (identical)."""
    a = rng.normal(size=shape).astype(np.float32)
    return torch.tensor(a).to(TDT[dtype]), jnp.asarray(a, JDT[dtype])


def _bits(x) -> np.ndarray:
    """Raw bits of a torch or JAX array: int16 for bf16, int32 for fp32."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x.view(torch.int32)).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype == ml_dtypes.bfloat16 else np.int32)


def _ids(rng, P, n):
    ids = rng.permutation(P)[:n].astype(np.int32)
    return torch.tensor(ids), jnp.asarray(ids)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_page_gather_ref_bit_exact(shape, dtype):
    rng = np.random.default_rng(31)
    tk, jk = _pool(rng, shape, dtype)
    tv, jv = _pool(rng, shape, dtype)
    tid, jid = _ids(rng, shape[1], shape[1] // 2 + 1)
    got_k = tref.page_gather_ref(tk, tid)
    assert got_k.shape == (tid.shape[0],) + shape[:1] + shape[2:]
    want_k = jref.page_gather_ref(jk, jid)
    pk, pv = pallas_gather(jk, jv, jid, interpret=True)
    np.testing.assert_array_equal(_bits(got_k), _bits(want_k))
    np.testing.assert_array_equal(_bits(got_k), _bits(pk))
    ok, ov = ops.page_gather(tk, tv, tid)
    np.testing.assert_array_equal(_bits(ok), _bits(pk))
    np.testing.assert_array_equal(_bits(ov), _bits(pv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_page_scatter_ref_bit_exact(shape, dtype):
    rng = np.random.default_rng(32)
    tk, jk = _pool(rng, shape, dtype)
    tv, jv = _pool(rng, shape, dtype)
    n = shape[1] // 2
    tks, jks = _pool(rng, (n,) + shape[:1] + shape[2:], dtype)
    tvs, jvs = _pool(rng, (n,) + shape[:1] + shape[2:], dtype)
    tid, jid = _ids(rng, shape[1], n)
    want_k = jref.page_scatter_ref(jk, jks, jid)
    pk, pv = pallas_scatter(jk, jv, jks, jvs, jid, interpret=True)
    before = tk.clone()
    got = tref.page_scatter_ref(tk, tks, tid)
    assert got is tk                                # in place
    np.testing.assert_array_equal(_bits(tk), _bits(want_k))
    np.testing.assert_array_equal(_bits(tk), _bits(pk))
    untouched = np.setdiff1d(np.arange(shape[1]), tid.numpy())
    assert torch.equal(tk[:, untouched], before[:, untouched])
    k2, v2 = tk.clone(), tv.clone()
    ptr = k2.data_ptr()
    assert ops.page_scatter(k2, v2, tks, tvs, tid) is None
    assert k2.data_ptr() == ptr
    np.testing.assert_array_equal(_bits(k2), _bits(pk))
    np.testing.assert_array_equal(_bits(tref.page_scatter_ref(tv, tvs, tid)),
                                  _bits(pv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_then_scatter_restores_pool(dtype):
    """Demote-then-promote loses no bytes: scattering a gathered stack back
    to the same slots is the identity."""
    rng = np.random.default_rng(33)
    tk, _ = _pool(rng, SHAPES[1], dtype)
    tv, _ = _pool(rng, SHAPES[1], dtype)
    tid, _ = _ids(rng, SHAPES[1][1], 5)
    k0, v0 = tk.clone(), tv.clone()
    ks, vs = ops.page_gather(tk, tv, tid)
    tk[:, tid.long()] = 0
    tv[:, tid.long()] = 0
    ops.page_scatter(tk, tv, ks, vs, tid)
    np.testing.assert_array_equal(_bits(tk), _bits(k0))
    np.testing.assert_array_equal(_bits(tv), _bits(v0))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers never fall back to the plain versions: given
    CPU tensors they raise (they take the card or nothing)."""
    k = torch.zeros(SHAPES[0])
    ids = torch.tensor([0, 1], dtype=torch.int32)
    before = (cuda_gather.launches, cuda_scatter.launches)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gather(k, k.clone(), ids)
    stack = torch.zeros((2,) + SHAPES[0][:1] + SHAPES[0][2:])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scatter(k, k.clone(), stack, stack.clone(), ids)
    assert (cuda_gather.launches, cuda_scatter.launches) == before
