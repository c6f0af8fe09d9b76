"""Bloom filter over 64-bit keys — host build, device-queryable.

Reference: velox/common/base/BloomFilter.h (blocked bloom used for IN-list
style pushdown and Spark's bloom_filter_agg).  The device form keeps the bit
array as a uint32 word vector: membership tests are two gathers + bit tests
per hash, which XLA fuses into the surrounding scan program — no scatter on
the query path (inserts happen host-side at build time, like the reference's
build-once-probe-many usage).
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray, salt: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        return _mix_inner(x, salt)


def _mix_inner(x: np.ndarray, salt: int) -> np.ndarray:
    x = x.astype(np.uint64) + np.uint64((salt * int(_C1)) & 0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(30)
    x *= _C2
    x ^= x >> np.uint64(27)
    x *= _C3
    x ^= x >> np.uint64(31)
    return x


class BloomFilter:
    """num_hashes-way bloom over a power-of-two bit array."""

    def __init__(self, capacity: int, bits_per_key: int = 8, num_hashes: int = 3):
        bits = 64
        want = max(capacity, 1) * bits_per_key
        while bits < want:
            bits *= 2
        self.num_bits = bits
        self.num_hashes = num_hashes
        self.words = np.zeros(bits // 32, dtype=np.uint32)

    def add(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys).astype(np.uint64)
        mask = np.uint64(self.num_bits - 1)
        for h in range(self.num_hashes):
            bit = _mix(keys, h + 1) & mask
            np.bitwise_or.at(
                self.words, (bit >> np.uint64(5)).astype(np.int64),
                (np.uint32(1) << (bit & np.uint64(31)).astype(np.uint32)),
            )

    def might_contain_host(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys).astype(np.uint64)
        mask = np.uint64(self.num_bits - 1)
        out = np.ones(len(keys), dtype=bool)
        for h in range(self.num_hashes):
            bit = _mix(keys, h + 1) & mask
            word = self.words[(bit >> np.uint64(5)).astype(np.int64)]
            out &= (word >> (bit & np.uint64(31)).astype(np.uint32)) & 1 != 0
        return out

    def might_contain_device(self, keys):
        """Device-side membership test: gathers + bit tests only."""
        import jax.numpy as jnp

        words = jnp.asarray(self.words)
        mask = jnp.uint64(self.num_bits - 1)
        k = keys.astype(jnp.uint64)
        out = jnp.ones(k.shape, dtype=jnp.bool_)
        for h in range(self.num_hashes):
            x = k + jnp.uint64(h + 1) * jnp.uint64(0x9E3779B97F4A7C15)
            x = x ^ (x >> 30)
            x = x * jnp.uint64(0xBF58476D1CE4E5B9)
            x = x ^ (x >> 27)
            x = x * jnp.uint64(0x94D049BB133111EB)
            x = x ^ (x >> 31)
            bit = x & mask
            word = jnp.take(
                words, (bit >> 5).astype(jnp.int32), mode="clip"
            )
            out = out & (
                ((word >> (bit & 31).astype(jnp.uint32)) & 1) != 0
            )
        return out
