"""Aggregate function API: accumulator layouts + update/merge/extract phases.

Reference: velox/exec/Aggregate.h:43,125-165 (accumulator state + addRawInput /
addIntermediateResults / extractValues contract), the registry at
Aggregate.h:421, and the function package under
velox/functions/prestosql/aggregates/ (RegisterAggregateFunctions.cpp:51-80).

Device re-design: accumulators are *columnar* — a tuple of [num_groups] jnp arrays
(struct-of-arrays), not row-wise RowContainer state.  Grouped updates are segment
reductions over trace-time-static ``num_groups``; ungrouped aggregation is the
G=1 case.  Each accumulator array declares its combine op (sum/min/max), from
which raw-input updates, partial merges, and merge-from-intermediate-columns all
derive — the three Velox paths (addRawInput / addIntermediateResults / merge)
collapse into one mechanism.

min_by/max_by keep (ordering, payload) accumulator *pairs* combined
lexicographically (``pairs`` field) — the columnar analog of the reference's
MinMaxByAggregates.cpp comparator state.  Ties break toward the smaller payload,
making results deterministic (the reference returns an arbitrary tied row).
Documented deviation: rows where ANY argument is null are skipped (the
reference keeps null payloads and can return NULL for min_by).

Exactness: decimal/integer sums accumulate in int64 (fixed-point), so tiling and
merge order cannot change results; floating inputs accumulate in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import BIGINT, BOOLEAN, DOUBLE, DataType, TypeKind, decimal

from ..ops.segmented import (
    SortedRuns,
    direct_group_reduce,
    direct_group_reduce_pair,
    identity_for as _identity,
    masked_reduce,
    masked_reduce_pair,
)

_COMBINE = {
    "sum": jnp.add,
    "min": jnp.minimum,
    "max": jnp.maximum,
    "band": jnp.bitwise_and,
    "bor": jnp.bitwise_or,
}


def _grouped_reduce(arr, mask, group_ids, num_groups, op):
    """Scatter-free grouped reduction (see ops/segmented.py for the rationale)."""
    if num_groups == 1:
        return masked_reduce(arr, mask, op).reshape(1)
    return direct_group_reduce(arr, mask, group_ids, num_groups, op)


def _pair_take(op: str, ay, ax, by, bx):
    """Lexicographic (ordering, payload) select: does (by, bx) win over (ay, ax)?"""
    if op == "min":
        return (by < ay) | ((by == ay) & (bx < ax))
    return (by > ay) | ((by == ay) & (bx < ax))


@dataclasses.dataclass
class BoundAggregate:
    """One aggregate call bound to its input columns and result type.

    ``raw_inputs(values, mask)`` maps the argument columns (a tuple, empty for
    count(*)) to one array per accumulator; combined with per-accumulator
    segment ops this yields all three update paths uniformly.  ``pairs`` marks
    (ordering_idx, payload_idx, op) accumulator pairs that combine
    lexicographically instead of element-wise.
    """

    name: str
    result_type: DataType
    acc_dtypes: Tuple
    acc_ops: Tuple[str, ...]
    raw_inputs: Callable  # (values_tuple, mask) -> tuple of arrays, one per acc
    extract_fn: Callable  # accs (host numpy) -> (values, validity|None)
    input_index: Optional[int]  # legacy single-arg index; None=count(*)
    # Optional renormalization applied after every combine (e.g. carry the
    # low-limb overflow of wide sums into the high limb).
    post_combine: Optional[Callable] = None
    # Lexicographic accumulator pairs: (ordering acc idx, payload acc idx, op).
    pairs: Tuple[Tuple[int, int, str], ...] = ()
    # Per-argument roles for string handling: 'value' (output as-is, keep the
    # dictionary), 'order' (needs rank order), 'order+value' (both), 'plain'.
    arg_roles: Tuple[str, ...] = ()

    def _paired_payloads(self):
        return {j for _, j, _ in self.pairs}

    def _pair_of(self, i):
        for y, x, op in self.pairs:
            if y == i:
                return (y, x, op)
        return None

    def acc_init(self, num_groups: int) -> Tuple[jax.Array, ...]:
        out = []
        for i, (dt, op) in enumerate(zip(self.acc_dtypes, self.acc_ops)):
            out.append(jnp.full((num_groups,), _identity(op, dt), dtype=dt))
        return tuple(out)

    def _masked(self, arrays, mask):
        out = []
        for arr, dt, op in zip(arrays, self.acc_dtypes, self.acc_ops):
            ident = _identity(op, dt)
            out.append(jnp.where(mask, arr.astype(dt), jnp.asarray(ident, dtype=dt)))
        return out

    def _combine_states(self, accs, news):
        """Combine two aligned accumulator tuples respecting pairs."""
        out = list(accs)
        paired = self._paired_payloads()
        for i, op in enumerate(self.acc_ops):
            pair = self._pair_of(i)
            if pair is not None:
                y, x, pop = pair
                take = _pair_take(pop, accs[y], accs[x], news[y], news[x])
                out[y] = jnp.where(take, news[y], accs[y])
                out[x] = jnp.where(take, news[x], accs[x])
            elif i in paired:
                continue  # handled with its ordering partner
            else:
                out[i] = _COMBINE[op](accs[i], news[i])
        result = tuple(out)
        return self.post_combine(result) if self.post_combine else result

    def _grouped_tile_state(self, arrays, mask, group_ids, num_groups):
        """Reduce one tile's rows into a [num_groups] accumulator tuple."""
        out = [None] * len(arrays)
        paired = self._paired_payloads()
        for i, op in enumerate(self.acc_ops):
            pair = self._pair_of(i)
            if pair is not None:
                y, x, pop = pair
                if num_groups == 1:
                    ry, rx = masked_reduce_pair(arrays[y], arrays[x], mask, pop)
                    out[y], out[x] = ry.reshape(1), rx.reshape(1)
                else:
                    out[y], out[x] = direct_group_reduce_pair(
                        arrays[y], arrays[x], mask, group_ids, num_groups, pop
                    )
            elif i in paired:
                continue
            else:
                out[i] = _grouped_reduce(arrays[i], mask, group_ids, num_groups, op)
        return tuple(out)

    def update(self, accs, values, mask, group_ids, num_groups):
        """Add raw input rows (reference: Aggregate::addRawInput)."""
        arrays = self._masked(self.raw_inputs(values, mask), mask)
        news = self._grouped_tile_state(arrays, mask, group_ids, num_groups)
        return self._combine_states(accs, news)

    def run_reduce(self, values, mask, runs: SortedRuns):
        """Per-run reductions for sort-mode grouping: tuple of [capacity] arrays
        where slot r is run r's partial accumulator."""
        arrays = self._masked(self.raw_inputs(values, mask), mask)
        out = [None] * len(arrays)
        paired = self._paired_payloads()
        for i, op in enumerate(self.acc_ops):
            pair = self._pair_of(i)
            if pair is not None:
                y, x, pop = pair
                out[y], out[x] = runs.reduce_pair(
                    arrays[y].astype(self.acc_dtypes[y]),
                    arrays[x].astype(self.acc_dtypes[x]),
                    mask, pop,
                )
            elif i in paired:
                continue
            else:
                out[i] = runs.reduce(arrays[i].astype(self.acc_dtypes[i]), mask, op)
        return tuple(out)

    def merge_runs(self, acc_arrays, valid, runs: SortedRuns):
        """Merge already-partial accumulator rows grouped into runs (device
        sorted-carry merge path)."""
        out = [None] * len(acc_arrays)
        paired = self._paired_payloads()
        for i, op in enumerate(self.acc_ops):
            pair = self._pair_of(i)
            if pair is not None:
                y, x, pop = pair
                out[y], out[x] = runs.reduce_pair(
                    acc_arrays[y], acc_arrays[x], valid, pop
                )
            elif i in paired:
                continue
            else:
                out[i] = runs.reduce(acc_arrays[i], valid, op)
        result = tuple(out)
        return self.post_combine(result) if self.post_combine else result

    def merge(self, a, b):
        """Combine two aligned partial states (reference: spill/bridge merges)."""
        return self._combine_states(a, b)

    def host_merge_sorted(self, acc_arrays, starts):
        """Merge group-sorted host partial rows (np arrays) into per-group
        accumulators; ``starts`` marks each group's first row."""
        n = len(acc_arrays[0])
        out = [None] * len(acc_arrays)
        paired = self._paired_payloads()
        lengths = np.diff(np.append(starts, n))
        gids = np.repeat(np.arange(len(starts)), lengths)
        for i, op in enumerate(self.acc_ops):
            pair = self._pair_of(i)
            if pair is not None:
                y, x, pop = pair
                ya, xa = acc_arrays[y], acc_arrays[x]
                yk = -ya if pop == "max" else ya
                perm = np.lexsort((xa, yk, gids))
                out[y] = ya[perm][starts]
                out[x] = xa[perm][starts]
            elif i in paired:
                continue
            elif len(starts) == 0:
                out[i] = acc_arrays[i][:0]
            elif op == "sum":
                arr = acc_arrays[i]
                if self.post_combine is not None:
                    # wide-limb sums: merge in python-int space so the lo
                    # limb cannot wrap across many tiles
                    arr = arr.astype(object)
                out[i] = np.add.reduceat(arr, starts)
            elif op == "min":
                out[i] = np.minimum.reduceat(acc_arrays[i], starts)
            elif op == "band":
                out[i] = np.bitwise_and.reduceat(acc_arrays[i], starts)
            elif op == "bor":
                out[i] = np.bitwise_or.reduceat(acc_arrays[i], starts)
            else:
                out[i] = np.maximum.reduceat(acc_arrays[i], starts)
        return tuple(out)

    def extract(self, accs):
        return self.extract_fn(accs)

    @property
    def intermediate_types(self) -> Tuple[DataType, ...]:
        """Logical types of intermediate columns (for partial-agg output batches)."""
        out = []
        for dt in self.acc_dtypes:
            out.append(DOUBLE if jnp.issubdtype(dt, jnp.floating) else BIGINT)
        return tuple(out)

    @property
    def num_args(self) -> int:
        return len(self.arg_roles)


def _sum_result_type(t: DataType) -> DataType:
    if t.kind == TypeKind.DECIMAL:
        # long-decimal sums stay long (reference: DecimalAggregate.h sums in
        # int128); lowered onto 32-bit piece sums by exec/hugeint.py
        return decimal(38 if t.is_long_decimal else 18, t.scale)
    if t.is_floating:
        return DOUBLE
    return BIGINT


def _acc_dtype(t: DataType):
    return jnp.float64 if t.is_floating else jnp.int64


def _to_float(values: jax.Array, t: DataType) -> jax.Array:
    v = values.astype(jnp.float64)
    if t.kind == TypeKind.DECIMAL and t.scale:
        v = v / (10.0 ** t.scale)
    return v


# ---- exact wide (96-bit) integer sums --------------------------------------
#
# A scale-6 decimal sum over 1.5e9 rows exceeds int64; the reference uses
# software int128 (velox/type/DecimalUtil.h).  Here the accumulator is split
# into 32-bit limbs: lo accumulates v & 0xffffffff, hi accumulates v >> 32
# (arithmetic shift — exact for negatives too since v == (v>>32)*2^32 + lo).
# After every combine the lo overflow is carried into hi, keeping lo < 2^32 +
# tile_rows * 2^32 — far from wrapping.  Extraction reconstructs with python
# ints (exact arbitrary precision) on the host.


def _wide_raw_inputs(values, mask):
    v = values[0].astype(jnp.int64)
    return (
        v >> 32,
        v & jnp.int64(0xFFFFFFFF),
        jnp.ones_like(v, dtype=jnp.int64),
    )


def _wide_normalize(accs):
    hi, lo, count = accs
    return (hi + (lo >> 32), lo & jnp.int64(0xFFFFFFFF), count)


def _wide_exact(hi, lo):
    return np.asarray(hi).astype(object) * (1 << 32) + np.asarray(lo).astype(object)


def _wide_sum_extract(accs):
    exact = _wide_exact(accs[0], accs[1])
    count = np.asarray(accs[2])
    int64_max = (1 << 63) - 1
    if len(exact) and max((abs(int(x)) for x in exact), default=0) > int64_max:
        values = exact.astype(np.float64)  # beyond 64 bits: lossless order, lossy tail
    else:
        values = exact.astype(np.int64)
    return values, count > 0


# ---- hash mixing for checksum ------------------------------------------------


def _splitmix64(v: jax.Array) -> jax.Array:
    """splitmix64 finalizer over int64 lanes (wrapping arithmetic)."""
    x = v.astype(jnp.uint64)
    x = (x + jnp.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * jnp.uint64(0x94D049BB133111EB)
    x = x ^ (x >> 31)
    return x.astype(jnp.int64)


def narrow_int_sum(result_type: DataType, input_index=None) -> BoundAggregate:
    """Single-accumulator exact integer sum, valid when the planner proves
    |sum| < 2^62 from column bounds x capacity (runner.AggExecutor).  Same
    accumulator shape as the float sum: (value, nonnull count)."""
    return BoundAggregate(
        "sum", result_type, (jnp.int64, jnp.int64), ("sum", "sum"),
        lambda values, mask: (
            values[0].astype(jnp.int64),
            jnp.ones_like(values[0], dtype=jnp.int64),
        ),
        lambda accs: (accs[0], accs[1] > 0),
        input_index, arg_roles=("plain",),
    )


def narrow_int_avg(scale: int, input_index=None) -> BoundAggregate:
    """avg over a bounds-proven integer column: (sum, count) instead of the
    wide (hi, lo, count) limbs — same gating as narrow_int_sum."""

    def extract(accs):
        total, count = np.asarray(accs[0]), np.asarray(accs[1])
        safe = np.maximum(count, 1)
        value = (total / safe).astype(np.float64) / (10.0**scale)
        return value, count > 0

    return BoundAggregate(
        "avg", DOUBLE, (jnp.int64, jnp.int64), ("sum", "sum"),
        lambda values, mask: (
            values[0].astype(jnp.int64),
            jnp.ones_like(values[0], dtype=jnp.int64),
        ),
        extract, input_index, arg_roles=("plain",),
    )


def bind_aggregate(
    name: str,
    input_types: Union[None, DataType, Sequence[DataType]],
    input_index=None,
) -> BoundAggregate:
    """Bind an aggregate by name (reference: exec::Aggregate::create)."""
    name = name.lower()
    # Spark-package aliases (reference: velox/functions/sparksql/aggregates):
    # first/last reduce to arbitrary (deterministic here), collect_* to the
    # Presto collect aggregates.
    name = {
        "first": "arbitrary",
        "last": "arbitrary",
        "collect_list": "array_agg",
        "collect_set": "set_agg",
    }.get(name, name)
    if input_types is None:
        types: Tuple[DataType, ...] = ()
    elif isinstance(input_types, DataType):
        types = (input_types,)
    else:
        types = tuple(input_types)

    from .collect_agg import COLLECT_AGG_NAMES, bind_collect

    if name in COLLECT_AGG_NAMES:
        return bind_collect(name, types)

    if name == "count":
        return BoundAggregate(
            "count", BIGINT, (jnp.int64,), ("sum",),
            lambda values, mask: (jnp.ones_like(mask, dtype=jnp.int64),),
            lambda accs: (accs[0], None),
            input_index,
            arg_roles=("plain",) * len(types),
        )

    if name == "approx_distinct":
        # Always lowered to the bounded-state HLL plan rewrite before
        # execution (exec/sketch.py; reference: common/hyperloglog/DenseHll.h).
        # This binding only supplies the result type to the plan node; its
        # update path must never run.
        def _unlowered(values, mask):
            raise NotImplementedError(
                "approx_distinct must be lowered by "
                "exec.sketch.rewrite_sketch_aggregates (LocalExecutor and "
                "DistributedExecutor apply it automatically)"
            )

        return BoundAggregate(
            "approx_distinct", BIGINT, (jnp.int64,), ("max",),
            _unlowered,
            lambda accs: (accs[0], None),
            input_index,
            arg_roles=("plain",) * len(types),
        )

    if name == "bloom_filter_agg":
        # Lowered to the grouped bitwise-OR plan rewrite (exec/sketch.py
        # _rewrite_bloom; reference: sparksql BloomFilterAggAggregate.cpp).
        # This binding only supplies the VARBINARY result type.
        from ..dtypes import VARBINARY as _VB

        def _unlowered_bloom(values, mask):
            raise NotImplementedError(
                "bloom_filter_agg must be lowered by "
                "exec.sketch.rewrite_sketch_aggregates (size arguments must "
                "be literals)"
            )

        return BoundAggregate(
            "bloom_filter_agg", _VB, (jnp.int64,), ("bor",),
            _unlowered_bloom,
            lambda accs: (accs[0], None),
            input_index,
            arg_roles=("plain",) * len(types),
        )

    assert types, f"{name} requires an argument"
    t0 = types[0]
    at = _acc_dtype(t0)

    if name == "count_if":
        return BoundAggregate(
            "count_if", BIGINT, (jnp.int64,), ("sum",),
            lambda values, mask: (values[0].astype(jnp.int64),),
            lambda accs: (accs[0], None),
            input_index, arg_roles=("plain",),
        )

    if name in ("bool_and", "every", "bool_or"):
        op = "min" if name in ("bool_and", "every") else "max"
        return BoundAggregate(
            name, BOOLEAN, (jnp.int64, jnp.int64), (op, "sum"),
            lambda values, mask: (
                values[0].astype(jnp.int64),
                jnp.ones_like(mask, dtype=jnp.int64),
            ),
            lambda accs: (accs[0].astype(np.bool_), accs[1] > 0),
            input_index, arg_roles=("plain",),
        )

    if name == "sum":
        if at == jnp.float64:
            return BoundAggregate(
                "sum", _sum_result_type(t0), (at, jnp.int64), ("sum", "sum"),
                lambda values, mask: (
                    values[0], jnp.ones_like(values[0], dtype=jnp.int64),
                ),
                lambda accs: (accs[0], accs[1] > 0),  # sum of zero rows is NULL
                input_index, arg_roles=("plain",),
            )
        return BoundAggregate(
            "sum", _sum_result_type(t0),
            (jnp.int64, jnp.int64, jnp.int64), ("sum", "sum", "sum"),
            _wide_raw_inputs,
            _wide_sum_extract,
            input_index,
            post_combine=_wide_normalize,
            arg_roles=("plain",),
        )

    if name in ("min", "max"):
        return BoundAggregate(
            name, t0, (at, jnp.int64), (name, "sum"),
            lambda values, mask: (
                values[0], jnp.ones_like(values[0], dtype=jnp.int64),
            ),
            lambda accs: (accs[0], accs[1] > 0),
            input_index, arg_roles=("order+value",),
        )

    if name == "arbitrary":
        # deterministic "any value": the smallest (reference returns the first
        # seen, which is thread-schedule-dependent; smallest is reproducible)
        return BoundAggregate(
            "arbitrary", t0, (at, jnp.int64), ("min", "sum"),
            lambda values, mask: (
                values[0], jnp.ones_like(values[0], dtype=jnp.int64),
            ),
            lambda accs: (accs[0], accs[1] > 0),
            input_index, arg_roles=("value",),
        )

    if name in ("min_by", "max_by"):
        assert len(types) == 2, f"{name} takes (value, ordering)"
        op = "min" if name == "min_by" else "max"
        vt = _acc_dtype(t0)
        ot = _acc_dtype(types[1])

        def raw(values, mask):
            return (
                values[1],  # ordering first (the pair's primary)
                values[0],
                jnp.ones_like(mask, dtype=jnp.int64),
            )

        return BoundAggregate(
            name, t0, (ot, vt, jnp.int64), (op, op, "sum"),
            raw,
            lambda accs: (accs[1], accs[2] > 0),
            input_index,
            pairs=((0, 1, op),),
            arg_roles=("value", "order"),
        )

    if name == "avg":
        scale = t0.scale if t0.kind == TypeKind.DECIMAL else 0

        if at == jnp.float64:
            def extract(accs):
                total, count = accs
                value = total.astype(np.float64) / np.maximum(count, 1)
                return value, count > 0

            return BoundAggregate(
                "avg", DOUBLE, (at, jnp.int64), ("sum", "sum"),
                lambda values, mask: (
                    values[0], jnp.ones_like(values[0], dtype=jnp.int64),
                ),
                extract, input_index, arg_roles=("plain",),
            )

        def extract_int(accs):
            exact = _wide_exact(accs[0], accs[1])
            count = np.asarray(accs[2])
            safe = np.maximum(count, 1)
            value = (exact / safe).astype(np.float64) / (10.0**scale)
            return value, count > 0

        return BoundAggregate(
            "avg", DOUBLE, (jnp.int64, jnp.int64, jnp.int64), ("sum", "sum", "sum"),
            _wide_raw_inputs,
            extract_int, input_index,
            post_combine=_wide_normalize,
            arg_roles=("plain",),
        )

    if name in (
        "variance", "var_samp", "var_pop",
        "stddev", "stddev_samp", "stddev_pop",
    ):
        pop = name.endswith("_pop")
        sqrt = name.startswith("stddev")

        def raw(values, mask, _t=t0):
            v = _to_float(values[0], _t)
            return (jnp.ones_like(v, dtype=jnp.int64), v, v * v)

        def extract(accs, _pop=pop, _sqrt=sqrt):
            n, s, ss = (np.asarray(a) for a in accs)
            nf = np.maximum(n, 1).astype(np.float64)
            m2 = np.maximum(ss - (s * s) / nf, 0.0)
            denom = nf if _pop else np.maximum(nf - 1.0, 1.0)
            out = m2 / denom
            if _sqrt:
                out = np.sqrt(out)
            valid = (n >= 1) if _pop else (n >= 2)
            return out, valid

        return BoundAggregate(
            name, DOUBLE, (jnp.int64, jnp.float64, jnp.float64),
            ("sum", "sum", "sum"),
            raw, extract, input_index, arg_roles=("plain",),
        )

    if name == "geometric_mean":
        def raw(values, mask, _t=t0):
            v = _to_float(values[0], _t)
            return (jnp.log(v), jnp.ones_like(v, dtype=jnp.int64))

        def extract(accs):
            s, n = (np.asarray(a) for a in accs)
            return np.exp(s / np.maximum(n, 1)), n > 0

        return BoundAggregate(
            "geometric_mean", DOUBLE, (jnp.float64, jnp.int64), ("sum", "sum"),
            raw, extract, input_index, arg_roles=("plain",),
        )

    if name in ("bitwise_and_agg", "bitwise_or_agg"):
        # reference: prestosql/aggregates/BitwiseAggregates.cpp
        op = "band" if name == "bitwise_and_agg" else "bor"
        return BoundAggregate(
            name, t0, (jnp.int64, jnp.int64), (op, "sum"),
            lambda values, mask: (
                values[0].astype(jnp.int64),
                jnp.ones_like(mask, dtype=jnp.int64),
            ),
            lambda accs: (accs[0], accs[1] > 0),
            input_index, arg_roles=("plain",),
        )

    if name == "checksum":
        # order-independent content hash: wrapping int64 sum of per-row
        # splitmix64 hashes (reference: ChecksumAggregate.h uses xxhash64 the
        # same way; null rows are excluded here rather than hashed)
        def raw(values, mask):
            return (_splitmix64(values[0].astype(jnp.int64)),)

        return BoundAggregate(
            "checksum", BIGINT, (jnp.int64,), ("sum",),
            raw,
            lambda accs: (accs[0], None),
            input_index, arg_roles=("plain",),
        )

    if name in ("skewness", "kurtosis"):
        # central moments from raw power sums (reference: velox/functions/
        # prestosql/aggregates/CentralMomentsAggregates.cpp; Spark's kurtosis
        # differs from Presto's by the excess-kurtosis constant — Presto
        # semantics here)
        def raw(values, mask, _t=t0):
            v = _to_float(values[0], _t)
            return (
                jnp.ones_like(v, dtype=jnp.int64),
                v,
                v * v,
                v * v * v,
                v * v * v * v,
            )

        def extract(accs, _name=name):
            n, s1, s2, s3, s4 = (np.asarray(a) for a in accs)
            nf = np.maximum(n, 1).astype(np.float64)
            mean = s1 / nf
            m2 = s2 - nf * mean**2
            m3 = s3 - 3 * mean * s2 + 2 * nf * mean**3
            m4 = s4 - 4 * mean * s3 + 6 * mean**2 * s2 - 3 * nf * mean**4
            if _name == "skewness":
                denom = np.where(m2 > 0, np.sqrt(np.maximum(m2, 1e-300)) ** 3, 1.0)
                out = np.sqrt(nf) * m3 / denom
                valid = (n >= 2) & (m2 > 0)
            else:
                denom = np.where(m2 > 0, m2 * m2, 1.0)
                out = nf * m4 / denom - 3.0
                valid = (n >= 2) & (m2 > 0)
            return out, valid

        return BoundAggregate(
            name, DOUBLE,
            (jnp.int64,) + (jnp.float64,) * 4,
            ("sum",) * 5,
            raw, extract, input_index, arg_roles=("plain",),
        )

    if name in ("covar_pop", "covar_samp", "corr"):
        assert len(types) == 2, f"{name} takes two arguments"
        tx, ty = types[0], types[1]

        def raw(values, mask, _tx=tx, _ty=ty):
            x = _to_float(values[0], _tx)
            y = _to_float(values[1], _ty)
            return (
                jnp.ones_like(x, dtype=jnp.int64),
                x, y, x * y, x * x, y * y,
            )

        def extract(accs, _name=name):
            n, sx, sy, sxy, sxx, syy = (np.asarray(a) for a in accs)
            nf = np.maximum(n, 1).astype(np.float64)
            cxy = sxy - sx * sy / nf
            if _name == "corr":
                vx = np.maximum(sxx - sx * sx / nf, 0.0)
                vy = np.maximum(syy - sy * sy / nf, 0.0)
                denom = np.sqrt(vx * vy)
                out = np.where(denom > 0, cxy / np.where(denom > 0, denom, 1.0), np.nan)
                return out, (n >= 2) & (denom > 0)
            if _name == "covar_pop":
                return cxy / nf, n >= 1
            return cxy / np.maximum(nf - 1.0, 1.0), n >= 2

        return BoundAggregate(
            name, DOUBLE,
            (jnp.int64,) + (jnp.float64,) * 5,
            ("sum",) * 6,
            raw, extract, input_index, arg_roles=("plain", "plain"),
        )

    raise KeyError(f"no aggregate function named {name!r}")


AGGREGATE_NAMES = (
    "count", "count_if", "sum", "min", "max", "avg", "arbitrary",
    "bool_and", "bool_or", "every", "min_by", "max_by",
    "variance", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop",
    "geometric_mean", "checksum", "covar_pop", "covar_samp", "corr",
    "skewness", "kurtosis", "bitwise_and_agg", "bitwise_or_agg",
    "approx_distinct", "bloom_filter_agg",
)
