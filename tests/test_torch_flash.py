"""The port's plain `flash_attention_ref` against the JAX oracle
(`repro.kernels.ref.flash_attention_ref`) AND the Pallas kernel run in
interpret mode, on the sweep of `tests/test_kernels.py` (MHA, GQA, MQA, a
sequence of three 128-blocks; causal and full; fp32 at 2e-5, bf16 at 2e-2)
and on S != T (full, and causal with the absolute mask); the device
dispatch of `ops.flash_attention`; and the CUDA wrapper's input checks,
which refuse what the JAX kernel refuses before anything is built."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(42)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(B, H, K, S, T, hd):
    return [RNG.normal(size=shape).astype(np.float32)
            for shape in ((B, H, S, hd), (B, K, T, hd), (B, K, T, hd))]


def _check(arrays, dtype, causal):
    t_args = [torch.tensor(a).to(TDT[dtype]) for a in arrays]
    j_args = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    got = tref.flash_attention_ref(*t_args, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == t_args[0].shape
    got = got.float().numpy()
    tol = TOL[dtype]
    want_oracle = np.asarray(
        jref.flash_attention_ref(*j_args, causal=causal), np.float32)
    want_pallas = np.asarray(
        pallas_flash(*j_args, causal=causal, interpret=True), np.float32)
    np.testing.assert_allclose(got, want_oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=tol)
    # dispatch by device: CPU tensors take the plain version
    np.testing.assert_array_equal(
        ops.flash_attention(*t_args, causal=causal).float().numpy(), got)


@pytest.mark.parametrize("B,H,K,S,hd", [
    (1, 4, 4, 128, 32),          # MHA
    (2, 8, 2, 256, 32),          # GQA 4:1
    (1, 4, 1, 128, 64),          # MQA
    (1, 2, 2, 384, 16),          # non-pow2 seq (3 blocks of 128)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_sweep(B, H, K, S, hd, dtype, causal):
    _check(_inputs(B, H, K, S, S, hd), dtype, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_ref_cross_lengths(causal):
    """S != T (a prefill extending a cached prefix): full, as
    `tests/test_kernels.py` runs it, and causal, where row s still sees
    columns t <= s (the absolute mask, no offset)."""
    _check(_inputs(1, 4, 4, 128, 256, 32), "float32", causal)


def test_causal_mask_is_absolute():
    """With S < T the causal rows see columns 0..s only: the columns past S
    do not move any output."""
    q, k, v = (torch.tensor(a) for a in _inputs(1, 2, 1, 8, 24, 16))
    full = tref.flash_attention_ref(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 8:] = 100.0
    v2[:, :, 8:] = -100.0
    torch.testing.assert_close(tref.flash_attention_ref(q, k2, v2), full,
                               rtol=0, atol=0)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the {name} kernel was built")
    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("shapes,match", [
    (((1, 6, 128, 32), (1, 4, 128, 32)), "multiple of K"),
    (((1, 4, 200, 32), (1, 4, 256, 32)), "S=200"),
    (((1, 4, 128, 32), (1, 4, 130, 32)), "T=130"),
    (((1, 4, 128, 48), (1, 4, 128, 48)), "head_dim"),
])
def test_wrapper_refuses_what_the_jax_kernel_refuses(no_build, shapes,
                                                     match):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        cuda_flash.flash_attention(q, k, k.clone())


def test_wrapper_refuses_cpu_tensors(no_build):
    q, k, v = (torch.tensor(a) for a in _inputs(1, 4, 2, 128, 128, 32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="dtype"):
        cuda_flash.flash_attention(q.half(), k.half(), v.half())
    assert cuda_flash.flash_attention.launches == 0
