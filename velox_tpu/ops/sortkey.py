"""Normalized sort-key packing: many sort operands -> one int64 operand.

Reference: velox/exec/VectorHasher.h:118 (range-mode value ids) and
velox/exec/HashTable.h:74 (kNormalizedKey) — the reference packs multi-column
keys into one 64-bit normalized key so its hash table can compare single
words.  Here the same trick feeds ``jax.lax.sort``: a sort's cost (run time
and compile time) grows with the operand count, so packing (liveness, key
columns, payload row-id) into ONE int64 turns a 5-operand sort into a
1-operand sort.

The pack is purely order-preserving arithmetic: each field occupies a fixed
bit span sized from *host-known inclusive bounds* (``fit`` below).  Bounds come
from table column stats (io/table.py Table.column_bounds) resolved through the
plan (exec/runner.py resolve_column_bounds) or from join build sides
(exec/joins.py _NormalizedKey).  When the total width exceeds 63 bits the
caller falls back to the multi-operand sort — exactly the reference's
kNormalizedKey -> kHash degradation (HashTable.cpp decideHashMode).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


def _bits_for(lo: int, hi: int) -> int:
    """Bit width of the inclusive range [lo, hi] (>= 1)."""
    return max(1, int(hi - lo).bit_length())


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """A static layout packing ordered integer fields into one int64.

    Fields are listed most-significant first; ``spare`` codes above each
    field's range are available for sentinels (a field with range R gets
    ``2**bits - R - 1`` spare codes that sort after every real value).
    """

    los: Tuple[int, ...]
    bits: Tuple[int, ...]
    shifts: Tuple[int, ...]
    total_bits: int
    # per-field NULL code (hi - lo + 1, one past the real range) for fields
    # declared nullable at fit time; None = field cannot hold NULL.  SQL
    # grouping treats NULL keys as ONE group (reference: VectorHasher reserves
    # value-id 0 for null, velox/exec/VectorHasher.h) — here null sorts last.
    null_codes: Tuple[Optional[int], ...] = ()

    @staticmethod
    def fit(
        bounds: Sequence[Tuple[int, int]],
        extra_bits: int = 0,
        sentinel_fields: Sequence[int] = (),
        null_fields: Sequence[int] = (),
    ) -> Optional["PackPlan"]:
        """Layout for fields with inclusive ``bounds``, high-to-low order.

        ``extra_bits`` reserves low bits (e.g. a payload row-id); fields in
        ``sentinel_fields`` get one extra code above their range for an
        out-of-band marker; fields in ``null_fields`` get a dedicated NULL
        code (hi - lo + 1).  A field in both gets two extra codes, so the
        sentinel (all-ones, used for dead rows) stays strictly above the NULL
        code.  Returns None if > 63 bits total.
        """
        los, bits, null_codes = [], [], []
        for i, (lo, hi) in enumerate(bounds):
            lo, hi = int(lo), max(int(lo), int(hi))
            extra = (1 if i in sentinel_fields else 0) + (
                1 if i in null_fields else 0
            )
            span = hi - lo + extra
            los.append(lo)
            bits.append(max(1, int(span).bit_length()))
            null_codes.append(hi - lo + 1 if i in null_fields else None)
        total = sum(bits) + extra_bits
        if total > 63:
            return None
        shifts = []
        acc = extra_bits
        for b in reversed(bits):
            shifts.append(acc)
            acc += b
        shifts.reverse()
        return PackPlan(
            tuple(los), tuple(bits), tuple(shifts), total, tuple(null_codes)
        )

    def sentinel_code(self, i: int) -> int:
        """The out-of-band code for field i (one past its largest value)."""
        return (1 << self.bits[i]) - 1

    def pack(
        self,
        values: Sequence[jax.Array],
        validities: Optional[Sequence[Optional[jax.Array]]] = None,
    ) -> jax.Array:
        """Pack field columns (device arrays) into one int64 array.

        ``validities`` (when given) maps NULL rows of nullable fields to the
        field's dedicated NULL code — values already AT the null code (e.g. a
        carry whose group key was extracted from a null group) pack
        identically, so re-packing is stable across merge rounds."""
        out = None
        for i, (v, lo, sh) in enumerate(zip(values, self.los, self.shifts)):
            code = v.astype(jnp.int64) - lo
            valid = validities[i] if validities is not None else None
            if valid is not None:
                nc = self.null_codes[i]
                assert nc is not None, (
                    f"field {i} holds NULLs but was not fitted as nullable"
                )
                code = jnp.where(valid, code, jnp.int64(nc))
            term = code << sh
            out = term if out is None else out + term
        assert out is not None
        return out

    def pack_with_sentinel(
        self,
        values: Sequence[jax.Array],
        dead: jax.Array,
        validities: Optional[Sequence[Optional[jax.Array]]] = None,
    ) -> jax.Array:
        """Pack, but rows where ``dead`` holds get every field's sentinel code
        (the packed value sorts after all live rows)."""
        packed = self.pack(values, validities)
        sentinel = 0
        for b, sh in zip(self.bits, self.shifts):
            sentinel |= ((1 << b) - 1) << sh
        return jnp.where(dead, jnp.int64(sentinel), packed)

    def unpack(self, packed: jax.Array, i: int) -> jax.Array:
        """Extract field i (as int64, bounds offset restored)."""
        mask = (1 << self.bits[i]) - 1
        return ((packed >> self.shifts[i]) & mask) + self.los[i]

    def null_value(self, i: int) -> Optional[int]:
        """The unpacked value a NULL in field i lands on (hi + 1); None for
        non-nullable fields.  ``unpack`` of a null group returns this."""
        nc = self.null_codes[i] if i < len(self.null_codes) else None
        return None if nc is None else self.los[i] + nc

    def key_part(self, packed: jax.Array) -> jax.Array:
        """The packed value with the low ``extra_bits`` payload cleared —
        equal key tuples compare equal on this."""
        low = self.shifts[-1] if self.shifts else 0
        return packed >> low


def packed_sort_with_index(
    plan: PackPlan,
    values: Sequence[jax.Array],
    dead: Optional[jax.Array],
    n: int,
    validities: Optional[Sequence[Optional[jax.Array]]] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Sort rows by (liveness, fields...) carrying the row index in the low
    bits.  Returns (packed_sorted, key_codes_sorted, perm) where ``perm`` is
    the gather permutation (original row index per sorted slot) and
    ``key_codes_sorted`` is the packed key with the index bits stripped.

    ``plan`` must have been fitted with ``extra_bits >= ceil(log2(n))`` and
    every field in ``sentinel_fields`` so dead rows sort last.
    """
    idx = jnp.arange(n, dtype=jnp.int64)
    if dead is None:
        packed = plan.pack(values, validities)
    else:
        packed = plan.pack_with_sentinel(values, dead, validities)
    merged = packed | idx
    s = jax.lax.sort([merged], num_keys=1)[0]
    low = plan.shifts[-1] if plan.shifts else 0
    idx_mask = (1 << low) - 1
    perm = (s & idx_mask).astype(jnp.int32)
    return s, s >> low, perm


def index_bits(n: int) -> int:
    """Bits needed to carry a row index in [0, n)."""
    return max(1, int(n - 1).bit_length()) if n > 1 else 1
