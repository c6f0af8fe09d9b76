"""Spark-compatible blocked bloom filter (bloom_filter_agg / might_contain).

Reference: velox/common/base/BloomFilter.h (blocked bloom: 64-bit blocks,
4 bits set per value from the low 24 bits of the hash, block index from
bits 24+), velox/functions/sparksql/aggregates/BloomFilterAggAggregate.cpp
(capacity = min(numBits, maxNumBits) / 16; hash = folly::hasher<int64_t> =
twang_mix64), velox/functions/sparksql/MightContain.h.

Wire format (BloomFilter::serialize): int8 version(=1) + int32 word count +
uint64 words, all little-endian.

Device split: the filter BUILDS on device as a grouped bitwise-OR aggregation
(exec/sketch.py rewrite — no scatter needed), assembles into this wire
format host-side, and PROBES on device with one gather + mask test per row.
"""

from __future__ import annotations

import struct

import numpy as np

KVERSION = 1
DEFAULT_EXPECTED_NUM_ITEMS = 1_000_000
DEFAULT_NUM_BITS = 8_388_608
MAX_NUM_BITS = 4_096 * 1024


def num_words(num_bits: int) -> int:
    """Word count for a target bit budget (BloomFilter::reset: capacity is
    value count at ~16 bits/value; words = max(4, nextPow2(capacity) / 4))."""
    capacity = max(int(min(num_bits, MAX_NUM_BITS)) // 16, 1)
    p = 1
    while p < capacity:
        p *= 2
    return max(4, p // 4)


def twang_mix64_np(x: np.ndarray) -> np.ndarray:
    """folly::hasher<int64_t> (twang_mix64), vectorized."""
    k = np.asarray(x).astype(np.uint64)
    with np.errstate(over="ignore"):
        k = (~k) + (k << np.uint64(21))
        k = k ^ (k >> np.uint64(24))
        k = k * np.uint64(265)
        k = k ^ (k >> np.uint64(14))
        k = k * np.uint64(21)
        k = k ^ (k >> np.uint64(28))
        k = k + (k << np.uint64(31))
    return k


def twang_mix64_jnp(x):
    import jax.numpy as jnp

    k = x.astype(jnp.uint64)
    k = (~k) + (k << 21)
    k = k ^ (k >> 24)
    k = k * jnp.uint64(265)
    k = k ^ (k >> 14)
    k = k * jnp.uint64(21)
    k = k ^ (k >> 28)
    k = k + (k << 31)
    return k


def bloom_mask_jnp(h):
    """4 bits from the low 24 hash bits, one 64-bit block (BloomFilter.h
    bloomMask)."""
    import jax.numpy as jnp

    one = jnp.uint64(1)
    m = (
        (one << (h & 63))
        | (one << ((h >> 6) & 63))
        | (one << ((h >> 12) & 63))
        | (one << ((h >> 18) & 63))
    )
    return m


def serialize(words: np.ndarray) -> bytes:
    words = np.asarray(words, dtype="<u8")
    return struct.pack("<bi", KVERSION, len(words)) + words.tobytes()


def deserialize(data: bytes) -> np.ndarray:
    version, n = struct.unpack_from("<bi", data, 0)
    if version != KVERSION:
        raise ValueError(f"bad bloom filter version {version}")
    return np.frombuffer(data, dtype="<u8", count=n, offset=5)


def build_host(values: np.ndarray, num_bits: int = DEFAULT_NUM_BITS) -> bytes:
    """Host-side build (oracle / small inputs)."""
    n = num_words(num_bits)
    h = twang_mix64_np(values)
    one = np.uint64(1)
    mask = (
        (one << (h & np.uint64(63)))
        | (one << ((h >> np.uint64(6)) & np.uint64(63)))
        | (one << ((h >> np.uint64(12)) & np.uint64(63)))
        | (one << ((h >> np.uint64(18)) & np.uint64(63)))
    )
    idx = ((h >> np.uint64(24)) & np.uint64(n - 1)).astype(np.int64)
    words = np.zeros(n, dtype=np.uint64)
    np.bitwise_or.at(words, idx, mask)
    return serialize(words)


def might_contain_host(data: bytes, values: np.ndarray) -> np.ndarray:
    words = deserialize(data)
    n = len(words)
    h = twang_mix64_np(values)
    one = np.uint64(1)
    mask = (
        (one << (h & np.uint64(63)))
        | (one << ((h >> np.uint64(6)) & np.uint64(63)))
        | (one << ((h >> np.uint64(12)) & np.uint64(63)))
        | (one << ((h >> np.uint64(18)) & np.uint64(63)))
    )
    idx = ((h >> np.uint64(24)) & np.uint64(n - 1)).astype(np.int64)
    return (words[idx] & mask) == mask


_DEVICE_FNS_DONE = [False]


def register_bloom_device_fns() -> None:
    """Register the device-side build projections used by the
    bloom_filter_agg plan rewrite (exec/sketch.py): per-row block index and
    block bitmask — the filter then builds as a grouped bitwise-OR."""
    if _DEVICE_FNS_DONE[0]:
        return
    _DEVICE_FNS_DONE[0] = True
    from ..dtypes import BIGINT
    from ..expr.registry import DEFAULT_REGISTRY, NUMERIC

    def _word(ctx, out_t, arg_ts, x, n):
        import jax.numpy as jnp

        h = twang_mix64_jnp(x.astype(jnp.int64))
        return ((h >> 24) & (n.astype(jnp.uint64) - 1)).astype(jnp.int64)

    def _mask(ctx, out_t, arg_ts, x):
        import jax.numpy as jnp

        m = bloom_mask_jnp(twang_mix64_jnp(x.astype(jnp.int64)))
        return m.astype(jnp.int64)  # two's-complement wrap, bit-preserving

    DEFAULT_REGISTRY.register("__bloom_word64", [NUMERIC, NUMERIC], BIGINT, _word)
    DEFAULT_REGISTRY.register("__bloom_mask64", [NUMERIC], BIGINT, _mask)


_PROBE_CACHE = {}


def register_bloom_probe(data: bytes) -> str:
    """Register (once per distinct filter) a device probe function
    ``__bloom_probe_<id>(x) -> boolean`` closing over the filter words —
    the same bind-time specialization pattern as the timezone functions
    (functions/presto/tzfuncs.register_zone_fn).  An EMPTY (but non-null)
    filter probes as constant false (MightContain.h: isSet() ?: false); a
    NULL filter never reaches here — expr/binding.py folds it to a NULL
    constant (MightContainTest.nullBloomFilter)."""
    from ..dtypes import BIGINT, BOOLEAN
    from ..expr.registry import DEFAULT_REGISTRY, NUMERIC

    key = data
    hit = _PROBE_CACHE.get(key)
    if hit is not None:
        return hit
    name = f"__bloom_probe_{len(_PROBE_CACHE)}"
    if data is None or len(data) == 0:
        words_np = None
    else:
        words_np = np.asarray(deserialize(data))

    def impl(ctx, out_t, arg_ts, x):
        import jax.numpy as jnp

        if words_np is None:
            return jnp.zeros(x.shape, dtype=jnp.bool_)
        words = jnp.asarray(words_np)
        h = twang_mix64_jnp(x.astype(jnp.int64))
        mask = bloom_mask_jnp(h)
        idx = ((h >> 24) & jnp.uint64(len(words_np) - 1)).astype(jnp.int32)
        w = jnp.take(words, idx, mode="clip")
        return (w & mask) == mask

    DEFAULT_REGISTRY.register(name, [NUMERIC], BOOLEAN, impl)
    _PROBE_CACHE[key] = name
    return name
