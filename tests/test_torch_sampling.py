"""Sampling is bit-exact with the JAX package: the port's threefry key
folding and uniform bits equal `jax.random`'s bit for bit on a
(seed, position) grid, and `sample_rows_impl` draws the same tokens from
the same logits for greedy, temperature and top-k rows."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as jsamp
from repro_torch.serving import sampling as tsamp

SEEDS = np.array([0, 1, 2, 7, 12345, 2 ** 31 - 1], np.int32)
POS = np.array([0, 1, 15, 16, 257, 4097], np.int32)


def _grid():
    s, p = np.meshgrid(SEEDS, POS, indexing="ij")
    return s.ravel(), p.ravel()


def _key_data(k):
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(
        k.dtype, jax.dtypes.prng_key) else k).astype(np.int64)


@pytest.mark.parametrize("engine_seed", [0, 3, 2 ** 32 + 5, -1])
def test_prng_key_and_fold_key_bit_exact(engine_seed):
    base = jax.random.PRNGKey(engine_seed)
    tbase = tsamp.prng_key(engine_seed)
    assert tbase.tolist() == _key_data(base).tolist()
    seeds, pos = _grid()
    want = jax.vmap(lambda s, p: jsamp.fold_key(base, s, p))(
        jnp.asarray(seeds), jnp.asarray(pos))
    got = tsamp.fold_key(tbase, torch.tensor(seeds), torch.tensor(pos))
    assert got.tolist() == _key_data(want).tolist()


def test_random_bits_and_uniform_bit_exact():
    seeds, pos = _grid()
    keys = jax.vmap(lambda s, p: jsamp.fold_key(jax.random.PRNGKey(0), s, p))(
        jnp.asarray(seeds), jnp.asarray(pos))
    tkeys = torch.tensor(_key_data(keys))
    n = 503
    bits = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(keys)
    assert tsamp.random_bits(tkeys, n).tolist() == \
        np.asarray(bits).astype(np.int64).tolist()
    tiny = float(np.finfo(np.float32).tiny)
    u = jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=tiny))(keys)
    np.testing.assert_array_equal(
        tsamp.uniform(tkeys, n, tiny).numpy().view(np.int32),
        np.asarray(u).view(np.int32))
    # gumbel goes through log twice: equal to a few ulps
    g = jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(keys)
    np.testing.assert_allclose(tsamp.gumbel(tkeys, n).numpy(), np.asarray(g),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("V", [503, 4096])
def test_sample_rows_tokens_identical(V):
    rng = np.random.default_rng(V)
    B = 12
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    temps = np.array([0, 0.7, 1.1, 0.4, 5.0, 1.0, 0, 2.0, 0.9, 0.3, 1.5, 0.01],
                     np.float32)
    top_ks = np.array([0, 3, 0, 8, 0, 1, 5, 0, 50, 2, 0, 0], np.int32)
    seeds = rng.integers(0, 1000, size=B).astype(np.int32)
    pos = rng.integers(1, 3000, size=B).astype(np.int32)
    for key_seed in (0, 9):
        want = jsamp.sample_rows_impl(
            jnp.asarray(logits), jax.random.PRNGKey(key_seed),
            jnp.asarray(seeds), jnp.asarray(pos), jnp.asarray(temps),
            jnp.asarray(top_ks))
        got = tsamp.sample_rows_impl(
            torch.tensor(logits), tsamp.prng_key(key_seed),
            torch.tensor(seeds), torch.tensor(pos), torch.tensor(temps),
            torch.tensor(top_ks))
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(want).tolist()
    # greedy rows are the argmax; top_k=1 rows too, whatever the temperature
    assert got[0] == int(np.argmax(logits[0]))
    assert got[5] == int(np.argmax(logits[5]))
