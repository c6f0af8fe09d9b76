"""Group-id computation strategies: the VectorHasher / HashTable-mode analog.

Reference: velox/exec/VectorHasher.h:118,206 (per-key value ids; range/dictionary
modes for normalized keys) and velox/exec/HashTable.h:74 (adaptive kArray /
kNormalizedKey / kHash modes, decideHashMode at HashTable.cpp:1376).

Device re-design — the mode decision moves from runtime-adaptive to *plan-compile
time*, driven by static metadata (dictionary sizes, type ranges), because the
traced program must be shape-stable:

* ArrayGrouping (kArray): every key has a small static value-id range
  (dictionary-encoded strings, booleans); the composite id is a mixed-radix code
  and aggregation is a direct segment reduction into ``num_groups`` slots.
* SortGrouping (replaces kHash): no static range — sort rows by key within the
  tile and reduce contiguous runs.  Sorting beats hash probing on a machine with
  no efficient random scatter; the reference itself prefers normalized-key sorts
  in similar regimes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import DataType, RowType, TypeKind
from ..ops.f64bits import f64_to_ordered, ordered_to_f64
from ..vector.column import Batch, Column
from ..vector.string_table import StringTable

# Array mode emits one fused masked reduction per group (ops/segmented.py), so
# the composite range must stay small; larger key spaces go to sort mode, where
# sorting is cheap on the device.
MAX_ARRAY_GROUPS = 256


@dataclasses.dataclass
class KeyInfo:
    name: str
    dtype: DataType
    strings: Optional[StringTable]
    radix: Optional[int]  # static value-id range, None if unbounded
    # inclusive (lo, hi) value bounds in the device representation, when the
    # planner can resolve them (runner.resolve_column_bounds) — feeds the
    # normalized-key packed sort (ops/sortkey.py); None = multi-operand sort
    bounds: Optional[Tuple[int, int]] = None
    # May this key column hold NULLs (runner.resolve_column_nullable)?  SQL
    # groups all NULL keys together (reference: velox/exec/VectorHasher.h
    # reserves value-id 0 for null); nullable keys get a dedicated null code
    # in the packed sort, or ride the synthetic __nullbits__ key below.
    nullable: bool = False
    # Synthetic null-flag key (unbounded-key fallback): no real column — its
    # value is a bitmask of is-null flags over the named source keys.
    null_sources: Optional[Tuple[str, ...]] = None


def key_info(
    name: str,
    dtype: DataType,
    strings: Optional[StringTable],
    bounds: Optional[Tuple[int, int]] = None,
    nullable: bool = False,
) -> KeyInfo:
    if dtype.kind == TypeKind.BOOLEAN:
        return KeyInfo(name, dtype, None, 2, (0, 1), nullable)
    if dtype.is_string and strings is not None:
        return KeyInfo(
            name, dtype, strings, len(strings),
            (0, max(len(strings) - 1, 0)), nullable,
        )
    if (
        bounds is not None
        and not dtype.is_string
        and not dtype.is_complex
        and np.issubdtype(np.dtype(dtype.device_dtype), np.integer)
    ):
        # bounded integer-backed key (ints, dates, short decimals): value id
        # = value - lo, exactly the reference VectorHasher's range mode
        # (velox/exec/VectorHasher.h:118) — makes small-range int keys
        # eligible for kArray-style direct grouping
        span = int(bounds[1]) - int(bounds[0]) + 1
        if 0 < span <= MAX_ARRAY_GROUPS:
            return KeyInfo(name, dtype, strings, span, bounds, nullable)
    return KeyInfo(name, dtype, strings, None, bounds, nullable)


class ArrayGrouping:
    """Direct-indexed grouping over a static composite key range.

    Nullable keys get one extra value id (== radix) so NULL keys form a single
    dedicated group (reference: velox/exec/VectorHasher.h reserves id 0 for
    null; here null takes the id past the range)."""

    def __init__(self, keys: Sequence[KeyInfo]):
        assert all(k.radix is not None for k in keys)
        self.keys = list(keys)
        self.radixes = [k.radix + (1 if k.nullable else 0) for k in keys]
        self.num_groups = 1
        self.strides: List[int] = []
        for r in reversed(self.radixes):
            self.strides.append(self.num_groups)
            self.num_groups *= r
        self.strides.reverse()

    def group_ids(self, batch: Batch) -> jax.Array:
        gid = jnp.zeros((batch.capacity,), dtype=jnp.int32)
        for k, stride in zip(self.keys, self.strides):
            values, validity = batch.column(k.name).decode(batch.capacity)
            base = int(k.bounds[0]) if k.bounds else 0
            if base:
                values = values - jnp.asarray(base, values.dtype)
            v = values.astype(jnp.int32)
            if k.nullable and validity is not None:
                v = jnp.where(validity, v, jnp.int32(k.radix))
            gid = gid + v * stride
        return gid

    def key_arrays(self) -> List[np.ndarray]:
        """Host-side per-key value-id column for each of the num_groups slots
        (null groups hold id == radix; see key_validities)."""
        out = []
        ids = np.arange(self.num_groups)
        for k, r, stride in zip(self.keys, self.radixes, self.strides):
            v = ((ids // stride) % r).astype(np.int64)
            if k.nullable:
                v = np.minimum(v, k.radix - 1)  # null slot: placeholder value
            base = int(k.bounds[0]) if k.bounds else 0
            if base:
                v = v + base  # range-mode id -> value (VectorHasher.h:118)
            out.append(v if base else v.astype(np.int32))
        return out

    def key_validities(self) -> List[Optional[np.ndarray]]:
        """Per-key host validity per group slot (False = the NULL group)."""
        out: List[Optional[np.ndarray]] = []
        ids = np.arange(self.num_groups)
        for k, r, stride in zip(self.keys, self.radixes, self.strides):
            if k.nullable:
                out.append(((ids // stride) % r) != k.radix)
            else:
                out.append(None)
        return out


class SortGrouping:
    """Per-tile sort + run-boundary grouping; group count is data-dependent but
    bounded by the tile capacity (static).

    ``presorted=True`` skips the sort: the input is already ordered by (at
    least) the first key — e.g. downstream of a sort-merge join — so equal key
    tuples are grouped by adjacent comparison alone.  Runs may then split a
    logical group (secondary keys interleave within a primary-key run); the
    carry merge collapses such duplicates, so the executor must always run the
    merge step in this mode (reference: exec/StreamingAggregation.h, which
    likewise relies on sorted inputs)."""

    def __init__(self, keys: Sequence[KeyInfo], presorted: bool = False):
        self.keys = list(keys)
        self.presorted = presorted

    def pack_plan(self, capacity: int):
        """PackPlan for (keys..., row-id) if every key has resolvable bounds
        and the total fits 63 bits; None -> multi-operand sort fallback
        (the kNormalizedKey -> kHash degradation, HashTable.cpp:1376).
        Nullable keys reserve a dedicated null code so NULL keys form one
        group (Presto GROUP BY semantics)."""
        from ..ops.sortkey import PackPlan, index_bits

        bounds = []
        for k in self.keys:
            if k.bounds is None:
                return None
            bounds.append(k.bounds)
        return PackPlan.fit(
            bounds,
            extra_bits=index_bits(capacity),
            sentinel_fields=(0,),
            null_fields=tuple(
                i for i, k in enumerate(self.keys) if k.nullable
            ),
        )

    def _decode_keys(self, batch: Batch):
        """Per-key (values, validity) with synthetic null-bit keys computed
        and nullable key values canonicalized to 0 on NULL rows (so the
        multi-operand fallback sorts deterministic values; the packed path
        additionally maps NULL to the field's null code via ``validities``)."""
        cap = batch.capacity
        raw = {}
        for k in self.keys:
            if k.null_sources is None:
                raw[k.name] = batch.column(k.name).decode(cap)
        key_vals: List[jax.Array] = []
        key_valid: List[Optional[jax.Array]] = []
        for k in self.keys:
            if k.null_sources is not None:
                bits = jnp.zeros((cap,), dtype=jnp.int64)
                for j, src in enumerate(k.null_sources):
                    v, val = raw.get(src) or batch.column(src).decode(cap)
                    if val is not None:
                        bits = bits | (
                            (~val).astype(jnp.int64) << j
                        )
                key_vals.append(bits)
                key_valid.append(None)
                continue
            v, val = raw[k.name]
            if k.dtype.is_floating:
                # group on the order-preserving integer code: every NaN is
                # one group and -0.0 joins +0.0 (restore_keys maps back)
                v = f64_to_ordered(v)
            if k.nullable and val is not None:
                v = jnp.where(val, v, jnp.zeros_like(v))
                key_valid.append(val)
            else:
                key_valid.append(None)
            key_vals.append(v)
        return key_vals, key_valid

    def sort_and_group(
        self, batch: Batch, payload: Sequence[jax.Array], mask: jax.Array
    ):
        """Returns (sorted key arrays, sorted payload arrays, sorted mask, runs).

        Rows are sorted with liveness as the primary key so dead rows sink to
        the end and cannot split runs of equal keys.  ``runs`` (ops/segmented
        SortedRuns) carries the run structure for scatter-free reductions.
        """
        from ..ops.segmented import SortedRuns

        cap = batch.capacity
        key_vals, key_valid = self._decode_keys(batch)
        if self.presorted:
            # already key-ordered (dead rows keep their key values, so runs
            # spanning dead rows stay intact); no sort at all
            sorted_keys, sorted_payload, sorted_mask = key_vals, list(payload), mask
            from ..ops.segmented import run_boundaries

            diff = jnp.zeros((cap,), dtype=jnp.bool_)
            for kv in sorted_keys:
                diff = diff | (kv != jnp.roll(kv, 1))
            boundary = run_boundaries(diff, sorted_mask)
            runs = SortedRuns(boundary, sorted_mask)
            return self.restore_keys(sorted_keys), sorted_payload, sorted_mask, runs
        # Payloads (and the mask) ride the sort as extra non-key OPERANDS
        # rather than being gathered through a permutation afterwards — the
        # cheaper form on the engine's first target, the opposite of CPU
        # intuition, where the reference gathers payloads once after probing
        # (velox/exec/HashProbe.cpp); not measured on a GPU.
        carried = list(payload) + [mask]
        plan = self.pack_plan(cap)
        if plan is not None:
            # One-operand packed key (ops/sortkey.py): liveness sentinel +
            # every key + the row-id ride in a single int64.
            idx64 = jnp.arange(cap, dtype=jnp.int64)
            packed = plan.pack_with_sentinel(key_vals, ~mask, key_valid)
            merged = packed | idx64
            out = jax.lax.sort([merged] + carried, num_keys=1)
            s = out[0]
            low = plan.shifts[-1] if plan.shifts else 0
            codes = s >> low
            sorted_keys = [
                plan.unpack(s, i).astype(kv.dtype)
                for i, kv in enumerate(key_vals)
            ]
            sorted_payload = list(out[1 : 1 + len(payload)])
            sorted_mask = out[-1]
            from ..ops.segmented import run_boundaries

            diff = codes != jnp.roll(codes, 1)
            boundary = run_boundaries(diff, sorted_mask)
            runs = SortedRuns(boundary, sorted_mask)
            return sorted_keys, sorted_payload, sorted_mask, runs
        # Multi-operand fallback: (liveness, keys) as sort keys, payloads as
        # non-key operands (same cost rationale as above).
        sorted_ops = jax.lax.sort(
            [~mask] + key_vals + carried, num_keys=1 + len(key_vals)
        )
        sorted_keys = sorted_ops[1 : 1 + len(key_vals)]
        sorted_payload = list(sorted_ops[1 + len(key_vals) : -1])
        sorted_mask = sorted_ops[-1]
        from ..ops.segmented import run_boundaries

        diff = jnp.zeros((cap,), dtype=jnp.bool_)
        for kv in sorted_keys:
            prev = jnp.roll(kv, 1)
            diff = diff | (kv != prev)
        boundary = run_boundaries(diff, sorted_mask)
        runs = SortedRuns(boundary, sorted_mask)
        return self.restore_keys(sorted_keys), sorted_payload, sorted_mask, runs

    def restore_keys(self, key_vals):
        """Float keys back from the integer codes _decode_keys made."""
        return [
            ordered_to_f64(kv, k.dtype.device_dtype)
            if k.null_sources is None and k.dtype.is_floating
            else kv
            for k, kv in zip(self.keys, key_vals)
        ]

    # ---- split-dispatch halves (ops/shared_sort.py) ----------------------
    # Same math as sort_and_group's packed path, but the sort itself runs as
    # the canonical shared program between two cheap glue programs, so
    # query-specific programs contain no sort (config.split_sort_programs).

    def supports_split(self, cap: int) -> bool:
        from ..ops.shared_sort import _BUCKETS

        return not self.presorted and self.pack_plan(cap) is not None

    def sort_inputs(self, batch: Batch, payload, mask):
        """Pre-sort glue: (merged key word, carried operand list)."""
        cap = batch.capacity
        key_vals, key_valid = self._decode_keys(batch)
        plan = self.pack_plan(cap)
        assert plan is not None, "call supports_split first"
        # downstream programs may run over a live-count PREFIX of the
        # sorted word (runner._make_split_tile_partial): they must unpack
        # with THIS capacity's plan, not one derived from their own shape
        self._pack_capacity = cap
        idx64 = jnp.arange(cap, dtype=jnp.int64)
        packed = plan.pack_with_sentinel(key_vals, ~mask, key_valid)
        self._split_key_dtypes = [kv.dtype for kv in key_vals]
        return packed | idx64, list(payload) + [mask]

    def sorted_boundary(self, s_merged, s_mask_raw):
        """Run boundaries + the run-end compaction word from the sorted key
        word — the word's canonical shared sort replaces SortedRuns'
        in-program argsort (ops/segmented.py)."""
        from ..ops.compact import compaction_word
        from ..ops.segmented import run_boundaries, run_is_end

        cap = getattr(self, "_pack_capacity", s_merged.shape[0])
        plan = self.pack_plan(cap)
        low = plan.shifts[-1] if plan.shifts else 0
        codes = s_merged >> low
        mask = s_mask_raw.astype(jnp.bool_)
        diff = codes != jnp.roll(codes, 1)
        boundary = run_boundaries(diff, mask)
        return boundary, compaction_word(run_is_end(boundary, mask))

    def group_from_sorted(
        self,
        s_merged,
        s_carried,
        n_payload: int,
        boundary=None,
        end_positions=None,
    ):
        """Post-sort glue: unpack keys + run structure from the sorted word.
        Returns the same tuple as sort_and_group."""
        from ..ops.segmented import SortedRuns, run_boundaries

        cap = getattr(self, "_pack_capacity", s_merged.shape[0])
        plan = self.pack_plan(cap)
        s = s_merged
        low = plan.shifts[-1] if plan.shifts else 0
        codes = s >> low
        sorted_keys = [
            plan.unpack(s, i).astype(dt)
            for i, dt in enumerate(self._split_key_dtypes)
        ]
        sorted_payload = list(s_carried[:n_payload])
        sorted_mask = s_carried[-1].astype(jnp.bool_)
        if boundary is None:
            diff = codes != jnp.roll(codes, 1)
            boundary = run_boundaries(diff, sorted_mask)
        runs = SortedRuns(boundary, sorted_mask, end_positions=end_positions)
        return sorted_keys, sorted_payload, sorted_mask, runs

    def keys_from_word(self, word):
        """Per-slot key arrays unpacked straight from (already per-run
        compacted) sort words — the gather-free replacement for
        ``group_keys`` on the split path: the key word rides the run-end
        canonical sort, so one sort operand replaces two full-capacity
        gathers per key."""
        plan = self.pack_plan(
            getattr(self, "_pack_capacity", word.shape[0])
        )
        return [
            plan.unpack(word, i).astype(dt)
            for i, dt in enumerate(self._split_key_dtypes)
        ]

    @staticmethod
    def group_keys(sorted_keys, runs):
        """Representative key value per run slot (keys are equal within a run)."""
        return [runs.first(kv) for kv in sorted_keys]
