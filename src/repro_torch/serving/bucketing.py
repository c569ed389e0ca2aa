# Copy of src/repro/serving/bucketing.py (no import of the JAX package).
"""Static-shape buckets for the serving hot path.

XLA compiles one program per distinct input shape; a continuous-batching
engine whose decode batch `B` and block-table width `NPG` track the live
workload therefore recompiles constantly (compile time >> step time on
small models). Rounding both up to power-of-two buckets — capped by the
engine's capacity — bounds the jit cache at O(log B_cap * log NPG_cap)
programs while wasting at most 2x padded compute.

Token axes (prefill) bucket on a power-of-two ladder ABOVE the engine's
`prefill_pad` floor: pad, 2*pad, 4*pad, ... so long-prompt admissions stay
log-bounded too instead of compiling one program per pad multiple.
"""
from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def bucket(n: int, cap: int) -> int:
    """Round n up to the bucket ladder {1, 2, 4, ..., cap}: the smallest
    power of two >= n, clamped to cap (cap itself need not be a power of
    two — it is always the top bucket). Requires 1 <= n <= cap."""
    if not 1 <= n <= cap:
        raise ValueError(f"bucket: need 1 <= n({n}) <= cap({cap})")
    return min(next_pow2(n), cap)


def bucket_tokens(n: int, pad: int) -> int:
    """Token-axis bucket: pad * next_pow2(ceil(n / pad)) — the pow2 ladder
    with `pad` as its floor/granularity."""
    return pad * next_pow2(max(1, -(-n // pad)))


def token_pad(n: int, pad: int, bucket_shapes: bool = True) -> int:
    """Packed prefill token-axis pad: the pow2 ladder over `pad` when
    bucketing is on, the exact pad-multiple otherwise. (Shared by the
    backend's prefill packing — previously duplicated there.)"""
    if bucket_shapes:
        return bucket_tokens(n, pad)
    return -(-n // pad) * pad


def pow2_pad(n: int, bucket_shapes: bool = True) -> int:
    """Plain pow2 ladder for small packed axes (page-id lists, segment
    counts); exact when bucketing is off."""
    return bucket_tokens(n, 1) if bucket_shapes else n


def n_buckets(cap: int) -> int:
    """How many buckets the ladder {1, 2, 4, ..., cap} holds — the bound
    serving_bench asserts on per-axis compile counts."""
    n = 1
    while (1 << (n - 1)) < cap:
        n += 1
    return n
