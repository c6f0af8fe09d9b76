"""Segmented reductions without scatters — the device grouping primitives.

The engine's first target made XLA scatter-adds (jax.ops.segment_sum) and
vectorized binary search (jnp.searchsorted) one to two orders of magnitude
slower than sorts, scans and dense gathers, so every grouping primitive here
is built from sort + scan + gather only.  That premise is not measured on a
GPU, where scatter-add is native; it is an open item of ROADMAP.md.

* ``direct_group_reduce`` — small static group count: per-group masked
  reductions, which XLA fuses into a single pass.
* ``SortedRuns`` — rows sorted by key: run boundaries, a compaction permutation
  of run-end positions (itself an argsort), and run reductions as
  prefix-scan-diff / segmented-scan + end-gather.

Reference counterpart: velox/exec/HashTable.h kArray mode and the
normalized-key sort regime; the reference's scatter-style hash aggregation
is what this design replaces.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_COMBINE = {
    "sum": jnp.add,
    "min": jnp.minimum,
    "max": jnp.maximum,
    "band": jnp.bitwise_and,
    "bor": jnp.bitwise_or,
    "first": lambda a, b: a,  # keep the earlier value within the segment
}


def identity_for(op: str, dtype):
    if op == "sum":
        return 0
    if op == "band":
        return -1  # all ones in two's complement
    if op == "bor":
        return 0
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.inf if op == "min" else -jnp.inf
    info = jnp.iinfo(dtype)
    return info.max if op == "min" else info.min


def masked_reduce(values: jax.Array, mask: jax.Array, op: str) -> jax.Array:
    ident = identity_for(op, values.dtype)
    v = jnp.where(mask, values, jnp.asarray(ident, dtype=values.dtype))
    if op == "sum":
        return jnp.sum(v)
    if op == "min":
        return jnp.min(v)
    if op in ("band", "bor"):
        return jax.lax.reduce(
            v, jnp.asarray(ident, v.dtype), _COMBINE[op], [0]
        )
    return jnp.max(v)


def direct_group_reduce(
    values: jax.Array, mask: jax.Array, gids: jax.Array, num_groups: int, op: str
) -> jax.Array:
    """[num_groups] reduction with a static, small num_groups (kArray mode).

    Emits num_groups masked reductions; XLA multi-output fusion turns them into
    one pass over the data.  Keep num_groups <= ~256.
    """
    ident = jnp.asarray(identity_for(op, values.dtype), dtype=values.dtype)
    outs = []
    for g in range(num_groups):
        sel = mask & (gids == g)
        v = jnp.where(sel, values, ident)
        if op == "sum":
            outs.append(jnp.sum(v))
        elif op == "min":
            outs.append(jnp.min(v))
        elif op in ("band", "bor"):
            outs.append(jax.lax.reduce(v, ident, _COMBINE[op], [0]))
        else:
            outs.append(jnp.max(v))
    return jnp.stack(outs)


def direct_group_reduce_batch(
    items, mask: jax.Array, gids: jax.Array, num_groups: int
):
    """ALL of a node's accumulator reductions in ONE variadic lax.reduce.

    ``items``: sequence of (values [capacity], op) — values already carry
    their identity at dead rows.  Returns a list of [num_groups] arrays.

    One variadic reduce over fused (cap, G) contribution producers scales
    with the column count instead of the (accumulator x group) product —
    each input column streams from device memory once.  Used only behind
    VELOX_TPU_BATCH_REDUCE=1 (exec/runner.py update_carry)."""
    garange = jnp.arange(num_groups, dtype=gids.dtype)
    onehot = mask[:, None] & (gids[:, None] == garange[None, :])
    operands, inits = [], []
    for values, op in items:
        ident = jnp.asarray(identity_for(op, values.dtype), values.dtype)
        operands.append(jnp.where(onehot, values[:, None], ident))
        inits.append(ident)

    def comb(accs, xs):
        return tuple(
            _COMBINE[op](a, x)
            for (_, op), a, x in zip(items, accs, xs)
        )

    outs = jax.lax.reduce(
        tuple(operands), tuple(inits), comb, dimensions=(0,)
    )
    return list(outs)


def _pair_wins(op: str, ay, ax, by, bx):
    """Lexicographic (ordering, payload): does (b) replace (a)?  Ties go to the
    smaller payload so results are deterministic."""
    if op == "min":
        return (by < ay) | ((by == ay) & (bx < ax))
    return (by > ay) | ((by == ay) & (bx < ax))


def masked_reduce_pair(y: jax.Array, x: jax.Array, mask: jax.Array, op: str):
    """Ungrouped argmin/argmax: (ordering, payload) of the lexicographic extreme."""
    iy = jnp.asarray(identity_for(op, y.dtype), dtype=y.dtype)
    ix = jnp.asarray(identity_for("min", x.dtype), dtype=x.dtype)
    ym = jnp.where(mask, y, iy)
    best_y = jnp.min(ym) if op == "min" else jnp.max(ym)
    at_best = mask & (y == best_y)
    best_x = jnp.min(jnp.where(at_best, x, ix))
    return best_y, best_x


def direct_group_reduce_pair(
    y: jax.Array, x: jax.Array, mask: jax.Array, gids: jax.Array,
    num_groups: int, op: str,
):
    """[num_groups] argmin/argmax over (ordering y, payload x) pairs."""
    iy = jnp.asarray(identity_for(op, y.dtype), dtype=y.dtype)
    ix = jnp.asarray(identity_for("min", x.dtype), dtype=x.dtype)
    ys, xs = [], []
    for g in range(num_groups):
        sel = mask & (gids == g)
        ym = jnp.where(sel, y, iy)
        by = jnp.min(ym) if op == "min" else jnp.max(ym)
        bx = jnp.min(jnp.where(sel & (y == by), x, ix))
        ys.append(by)
        xs.append(bx)
    return jnp.stack(ys), jnp.stack(xs)


def segmented_scan_pair(
    y: jax.Array, x: jax.Array, boundary: jax.Array, op: str
):
    """Inclusive lexicographic-extreme scan of (y, x) pairs, reset at segments."""

    def fn(a, b):
        ay, ax, ab = a
        by, bx, bb = b
        win = _pair_wins(op, ay, ax, by, bx)
        take = bb | win
        return (
            jnp.where(take, by, ay),
            jnp.where(take, bx, ax),
            ab | bb,
        )

    oy, ox, _ = jax.lax.associative_scan(fn, (y, x, boundary))
    return oy, ox


def segmented_scan(values: jax.Array, boundary: jax.Array, op: str) -> jax.Array:
    """Inclusive scan of ``op`` that resets at rows where boundary=True."""
    comb = _COMBINE[op]

    def fn(a, b):
        av, ab = a
        bv, bb = b
        return (jnp.where(bb, bv, comb(av, bv)), ab | bb)

    out, _ = jax.lax.associative_scan(fn, (values, boundary))
    return out


def sparse_table(values: jax.Array, op: str):
    """Power-of-two range-min/max table: level j holds op over [i, i+2^j).

    O(n log n) work once, then any [lo, hi] range reduces with two gathers
    (the classic RMQ sparse table) — the scatter-free answer to sliding-window min/max
    frames, where prefix-scan differences do not apply.
    """
    comb = _COMBINE[op]
    cap = values.shape[0]
    levels = [values]
    step = 1
    while step < cap:
        prev = levels[-1]
        shifted = jnp.concatenate([prev[step:], prev[-step:]])
        levels.append(comb(prev, shifted))
        step *= 2
    return jnp.stack(levels)  # [J, cap]


def sparse_table_query(
    table: jax.Array, lo: jax.Array, hi: jax.Array, op: str, ident
):
    """op over values[lo..hi] per row; empty ranges (hi < lo) give ``ident``."""
    J, cap = table.shape
    w = jnp.maximum(hi - lo + 1, 1).astype(jnp.uint32)
    j = (31 - jax.lax.clz(w)).astype(jnp.int32)
    j = jnp.clip(j, 0, J - 1)
    flat = table.reshape(-1)
    a = jnp.take(flat, j * cap + jnp.clip(lo, 0, cap - 1), mode="clip")
    b_pos = jnp.clip(hi - (1 << j.astype(jnp.int64)).astype(jnp.int32) + 1, 0, cap - 1)
    b = jnp.take(flat, j * cap + b_pos, mode="clip")
    out = _COMBINE[op](a, b)
    return jnp.where(hi < lo, jnp.asarray(ident, out.dtype), out)


def rank_in_segments(
    seg_ids: jax.Array,
    keys: jax.Array,
    probe_seg: jax.Array,
    probe_keys: jax.Array,
    inclusive: bool,
) -> jax.Array:
    """Per probe: count of data rows in its segment with key < probe
    (``inclusive=True``: key <= probe).  Scatter-free 2-sort merge; data rows
    must already be sorted by (seg, key) — which they are inside a window
    partition sort."""
    cap = keys.shape[0]
    n = probe_keys.shape[0]
    all_seg = jnp.concatenate([seg_ids.astype(jnp.int64), probe_seg.astype(jnp.int64)])
    all_key = jnp.concatenate([keys, probe_keys.astype(keys.dtype)])
    # probes sort after equal keys when inclusive, before when exclusive
    flag = jnp.concatenate(
        [
            jnp.full((cap,), 0 if inclusive else 1, jnp.int32),
            jnp.full((n,), 1 if inclusive else 0, jnp.int32),
        ]
    )
    src = jnp.concatenate(
        [jnp.arange(cap, dtype=jnp.int32), jnp.arange(n, dtype=jnp.int32)]
    )
    is_probe = jnp.concatenate(
        [jnp.zeros((cap,), jnp.int32), jnp.ones((n,), jnp.int32)]
    )
    _, _, _, src_s, isp_s = jax.lax.sort(
        [all_seg, all_key, flag, src, is_probe], num_keys=3
    )
    cum_data = jnp.cumsum(1 - isp_s)  # data rows at or before this slot
    # route back to probe order: probes (1-isp = 0) occupy the first n slots
    _, _, by_probe = jax.lax.sort([1 - isp_s, src_s, cum_data], num_keys=2)
    return by_probe[:n].astype(jnp.int32)


def run_boundaries(diff: jax.Array, mask: jax.Array) -> jax.Array:
    """Run starts over key-sorted rows with dead rows possibly INTERLEAVED
    (merged-order join output, exec/joins.py _probe_fused): the first LIVE row
    at/after each key change starts a run — a dead row carrying the key change
    must not swallow the boundary.

    ``diff``: raw key-change marker per row (ignoring liveness); ``mask``:
    live rows."""
    n = diff.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    region = jnp.cumsum((diff | (idx == 0)).astype(jnp.int32))
    prev_live_region = jnp.concatenate(
        [
            jnp.zeros((1,), jnp.int32),
            jax.lax.cummax(jnp.where(mask, region, 0))[:-1],
        ]
    )
    return mask & (prev_live_region != region)


def run_is_end(
    boundary: jax.Array, mask: jax.Array, run_index: Optional[jax.Array] = None
) -> jax.Array:
    """A run's END is its LAST LIVE row.  Dead rows may sit INSIDE or
    BETWEEN runs (the fused join probe emits merged build+probe order with
    build slots masked dead, exec/joins.py _probe_fused), so "the next row
    is dead or a new run" does NOT mark an end — instead a live row ends its
    run iff no LATER live row shares its run id (one reversed scan)."""
    cap = boundary.shape[0]
    if run_index is None:
        run_index = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    big = jnp.int32(cap + 1)
    nxt_live_rid = jnp.concatenate(
        [
            jnp.where(mask, run_index, big)[1:],
            jnp.full((1,), big, jnp.int32),
        ]
    )
    suffix_min = jax.lax.cummin(nxt_live_rid, reverse=True)
    return mask & (suffix_min != run_index)


class SortedRuns:
    """Run structure of a key-sorted tile; built once, reused per column.

    ``end_positions`` is a [capacity] int32 array whose first ``num_runs``
    entries are the row indices of each run's last element, in run order —
    produced by a stable argsort of the run-end mask (compaction-by-sort).
    """

    def __init__(
        self,
        boundary: jax.Array,
        mask: jax.Array,
        end_positions: Optional[jax.Array] = None,
    ):
        cap = boundary.shape[0]
        self.capacity = cap
        self.boundary = boundary  # True at first row of each run (valid rows only)
        self.mask = mask
        self.run_index = jnp.cumsum(boundary.astype(jnp.int32)) - 1  # gid per row
        self.is_end = run_is_end(boundary, mask, self.run_index)
        if end_positions is None:
            # compaction-by-sort.  NOTE this argsort makes the CONTAINING
            # program sort-bearing (ops/shared_sort.py) — the split-dispatch
            # grouping path injects ``end_positions`` from the canonical
            # shared sort instead.
            end_positions = jnp.argsort(~self.is_end, stable=True).astype(
                jnp.int32
            )
        self.end_positions = end_positions
        self.num_runs = jnp.sum(self.is_end.astype(jnp.int32))

    def reduce(self, values: jax.Array, value_mask: jax.Array, op: str) -> jax.Array:
        """[capacity] array: slot r = reduction of run r (slots >= num_runs are
        garbage; mask with run_mask())."""
        ident = jnp.asarray(identity_for(op, values.dtype), dtype=values.dtype)
        v = jnp.where(value_mask & self.mask, values, ident)
        if op == "sum":
            totals = jnp.cumsum(v)
            at_ends = jnp.take(totals, self.end_positions, mode="clip")
            prev = jnp.concatenate([jnp.zeros((1,), totals.dtype), at_ends[:-1]])
            return at_ends - prev
        # min/max/band/bor: segment ops (scatter) instead of an
        # associative_scan — the engine's first target spent tens of minutes
        # compiling an 8M-row associative_scan (log-depth slice/concat
        # recursion) while scatters compiled in seconds.
        # Dead rows carry identity values, so clipping their ids is harmless.
        seg_fn = {
            "min": jax.ops.segment_min,
            "max": jax.ops.segment_max,
        }.get(op)
        if seg_fn is not None:
            gid = jnp.clip(self.run_index, 0, self.capacity - 1)
            return seg_fn(v, gid, num_segments=self.capacity)
        # band/bor (rare): the associative_scan stays — accepted slow first
        # compile for those aggregates
        scanned = segmented_scan(v, self.boundary, op)
        return jnp.take(scanned, self.end_positions, mode="clip")

    def reduce_pair(
        self, y: jax.Array, x: jax.Array, value_mask: jax.Array, op: str
    ):
        """Per-run lexicographic extreme of (ordering y, payload x) pairs."""
        iy = jnp.asarray(identity_for(op, y.dtype), dtype=y.dtype)
        ix = jnp.asarray(identity_for("min", x.dtype), dtype=x.dtype)
        alive = value_mask & self.mask
        ys = jnp.where(alive, y, iy)
        xs = jnp.where(alive, x, ix)
        sy, sx = segmented_scan_pair(ys, xs, self.boundary, op)
        return (
            jnp.take(sy, self.end_positions, mode="clip"),
            jnp.take(sx, self.end_positions, mode="clip"),
        )

    def start_positions(self) -> jax.Array:
        """[capacity] int32: slot r = row index of run r's first element
        (a boundary row — always live by construction)."""
        return jnp.argsort(~self.boundary, stable=True).astype(jnp.int32)

    def first(self, values: jax.Array) -> jax.Array:
        """Value at each run's first row (e.g. the key itself): slot r = run r.

        One cummax over boundary positions + two gathers — NOT a segmented
        associative_scan, whose log-depth slice/concat recursion compiled
        for tens of minutes on the engine's first target, while cumulative
        ops compile in seconds.  Dead rows interleaved with a run inherit the
        last boundary's index, so merged-order join output is handled."""
        cap = self.capacity
        iota = jnp.arange(cap, dtype=jnp.int32)
        start_idx = jax.lax.cummax(jnp.where(self.boundary, iota, -1))
        firsts = jnp.take(
            values, jnp.maximum(start_idx, 0), mode="clip"
        )
        return jnp.take(firsts, self.end_positions, mode="clip")

    def run_mask(self) -> jax.Array:
        return (
            jnp.arange(self.capacity, dtype=jnp.int32) < self.num_runs
        )
