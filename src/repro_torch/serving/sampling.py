"""Seed+position sampling, bit-exact with the JAX package's
`repro.serving.sampling` (PyTorch port).

The contract: row i's randomness depends ONLY on (base_key, the request's
sampling seed, the absolute position of the sampled token) — never on the
row's batch index or the padded batch size — so bucketing cannot change a
sampled token, and every sampling site (packed-prefill boundary, fused
decode) draws the same token for the same (seed, position).

To give the JAX engine's tokens, the draw reproduces `jax.random` under its
defaults here (impl threefry2x32, `jax_threefry_partitionable=True`):
  * a key is two uint32 words; `PRNGKey(s)` = (0, s mod 2**32) (JAX's
    default 32-bit mode keeps only the low word of the seed);
  * `fold_in(key, d)` = threefry2x32(key, (0, d));
  * `random_bits(key, 32, (V,))` = y0 ^ y1 of threefry2x32(key, (0, i))
    for the flat index i;
  * `uniform(minval=tiny)` puts the top 23 bits in the mantissa of a float
    in [1, 2), subtracts 1, adds tiny and clamps at tiny;
  * `categorical` = argmax(logits - log(-log(uniform))) (Gumbel max, the
    "low" mode).
This is plain integer and float arithmetic on int64 tensors holding uint32
values, not a kernel.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32
    values; keys and counters broadcast. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as a (2,) int64 tensor of uint32 words."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`jax.random.fold_in` elementwise: key (..., 2), data (...) integer
    (wrapped to uint32 like `jnp.asarray(data, 'uint32')`) -> (..., 2)."""
    d = data.long() & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def fold_key(base_key: torch.Tensor, seed, pos) -> torch.Tensor:
    """The per-draw key: fold the request's sampling seed, then the absolute
    position of the token being sampled, into the engine's base key.
    seed/pos: (B,) integer tensors -> (B, 2)."""
    return fold_in(fold_in(base_key, seed), pos)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element for shape (n,) under each key:
    keys (B, 2) -> (B, n) int64 in [0, 2**32)."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), float32, minval, 1.0)` per key row."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    scale = torch.tensor(1.0, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, floats * scale + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,), float32)` ("low" mode) per key row."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY)))


def sample_rows_impl(logits, base_key, seeds, pos, temps, top_ks):
    """Per-row sampling, batch-shape-invariant and run-stable.

    logits: (B, V); seeds/pos: (B,) int32 identity of each draw (the
    request's sampling seed and the sampled token's position); temps: (B,)
    float32 (<= 0 => greedy); top_ks: (B,) int32 (0 => disabled).
    Both branches run for every row and `where` picks, so the call never
    waits on the device to choose one.
    """
    lg = logits.float()
    V = lg.shape[-1]
    greedy = lg.argmax(dim=-1).to(torch.int32)
    srt = lg.sort(dim=-1, descending=True).values
    kth = srt.gather(-1, (top_ks.long().clamp(1, V) - 1)[:, None])  # (B, 1)
    masked = torch.where((top_ks[:, None] > 0) & (lg < kth), -torch.inf, lg)
    scaled = masked / temps.float().clamp_min(1e-6)[:, None]
    keys = fold_key(base_key, seeds, pos)
    sampled = (gumbel(keys, V) + scaled).argmax(dim=-1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)
