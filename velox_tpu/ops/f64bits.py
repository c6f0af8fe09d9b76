"""float64 <-> int64 word codec: the IEEE-754 bit view of a DOUBLE column.

Every backend the engine runs on (CPU, CUDA) has real IEEE float64, so the
word is the plain 64-bit bitcast and the codec is the same lax code on
every platform:

  f64_to_word     the IEEE bit pattern, bit for bit (NaN payloads and the
                  sign of zero included); word_to_f64 is its exact inverse.
  f64_to_ordered  the sign-flipped bit pattern: an int64 whose order is the
                  float order, with every NaN canonicalised to one code
                  above +inf (Presto convention) and -0.0 / +0.0 mapped to
                  one code (they compare equal).

The words are engine-internal (sort keys, payloads riding a shared sort,
hash inputs) and never serialized.

Subnormals: after the bitcast the codec works on integers only, so
subnormal inputs keep their bits and their order on every backend.  A float
compare would not: XLA's CPU backend treats float64 subnormals as zero in
comparisons and arithmetic (measured: 5e-324 == 0.0 is true there).  What
the H100 does with them is printed by `chip_smoke.py` phase 3.

Reference analog: the reference reads float bits directly in C++
(velox/common/base/SimdUtil.h, velox/common/base/BitUtil.h).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_ABS64 = np.int64(0x7FFFFFFFFFFFFFFF)
_INF_BITS = np.int64(0x7FF0000000000000)
_NAN_BITS = np.int64(0x7FF8000000000000)


def f64_to_word(x: jax.Array) -> jax.Array:
    """Invertible int64 word for a float64 column: its IEEE bit pattern."""
    return jax.lax.bitcast_convert_type(x.astype(jnp.float64), jnp.int64)


def word_to_f64(w: jax.Array) -> jax.Array:
    """Inverse of f64_to_word."""
    return jax.lax.bitcast_convert_type(w.astype(jnp.int64), jnp.float64)


def f64_to_ordered(x: jax.Array) -> jax.Array:
    """int64 key whose ordering matches the float ordering; NaN sorts above
    +inf (Presto convention); -0.0 and +0.0 map to the same code."""
    b = f64_to_word(x)
    mag = b & _ABS64
    # every NaN -> the canonical positive NaN; -0.0 -> +0.0.  Integer
    # compare-selects on the bits: a float `x + 0.0` may be folded away by a
    # simplifier, and a float compare may see a subnormal as zero
    b = jnp.where(mag > _INF_BITS, _NAN_BITS, b)
    b = jnp.where(mag == 0, jnp.int64(0), b)
    return b ^ ((b >> 63) & _ABS64)


def ordered_to_f64(k: jax.Array, dtype=jnp.float64) -> jax.Array:
    """Inverse of f64_to_ordered up to canonicalisation (NaN -> one NaN,
    -0.0 -> +0.0): the sign flip is its own inverse."""
    return word_to_f64(k ^ ((k >> 63) & _ABS64)).astype(dtype)


def np_f64_to_ordered(x: np.ndarray) -> np.ndarray:
    """numpy twin of f64_to_ordered, for host-side merges."""
    b = np.ascontiguousarray(x, dtype=np.float64).view(np.int64)
    mag = b & _ABS64
    b = np.where(mag > _INF_BITS, _NAN_BITS, b)
    b = np.where(mag == 0, np.int64(0), b)
    return b ^ ((b >> 63) & _ABS64)


def f32_to_bits64(x: jax.Array) -> jax.Array:
    """int64 carrying a float32's bit pattern, sign-extended; invert with
    bits64_to_f32."""
    return jax.lax.bitcast_convert_type(
        x.astype(jnp.float32), jnp.int32
    ).astype(jnp.int64)


def bits64_to_f32(w: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(w.astype(jnp.int32), jnp.float32)


def u64_to_i64(x: jax.Array) -> jax.Array:
    """Bit-preserving uint64 -> int64 (two's-complement wrap)."""
    return x.astype(jnp.int64)


def i64_to_u64(x: jax.Array) -> jax.Array:
    return x.astype(jnp.uint64)
