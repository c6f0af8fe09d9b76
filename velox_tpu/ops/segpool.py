"""Element-pool primitives for ARRAY/MAP columns — scatter-free.

A complex column stores its elements in a flat, fixed-capacity *pool* plus
per-row (start, size) spans (Arrow/Velox list layout: velox/vector/
ComplexVector.h ArrayVector offsets+sizes).  Everything here is built from
sort + scan + gather only, per the cost model in ops/segmented.py.

The central invariant is the **normalized pool**: rows' element runs are
contiguous, in row order, starting at 0 (starts = exclusive-cumsum(sizes)).
Host ingestion produces normalized pools; device-side row reordering (filter
compaction, joins) permutes the spans without touching the pool, so consumers
call :func:`normalize` first — a two-sort repack that tolerates arbitrary,
even duplicated, row→span maps.  With spans at hand, per-row reductions are
a segmented scan plus a gather at each span's end — no scatter, no
searchsorted, no result routing.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def owner_rows(starts: jax.Array, total: jax.Array, pool_cap: int) -> jax.Array:
    """rowid[p] for each pool position p, given *monotonic* row starts.

    ``rowid[p]`` = index of the last row whose start is <= p; for a dense pool
    that is the owning row.  Positions >= ``total`` get garbage — mask with
    ``jnp.arange(pool_cap) < total``.  Built as a 2-sort merge (no scatter,
    no searchsorted): markers for row starts and pool positions are sorted
    together; a cumulative count of start-markers yields the owner.
    """
    cap = starts.shape[0]
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    keys = jnp.concatenate([starts.astype(jnp.int32), pos])
    # start-markers sort before position-markers at the same key
    is_pos = jnp.concatenate(
        [jnp.zeros((cap,), jnp.int32), jnp.ones((pool_cap,), jnp.int32)]
    )
    src = jnp.concatenate([jnp.zeros((cap,), jnp.int32), pos])
    _, is_pos_s, src_s = jax.lax.sort([keys, is_pos, src], num_keys=2)
    owner = jnp.cumsum(1 - is_pos_s) - 1
    # second sort keyed on (is_pos, p): start-markers land in the first ``cap``
    # slots, position-markers in the last ``pool_cap`` slots ordered by p
    _, _, owner_by_pos = jax.lax.sort([is_pos_s, src_s, owner], num_keys=2)
    return owner_by_pos[cap:].astype(jnp.int32)


def dense_starts(sizes: jax.Array) -> jax.Array:
    """Exclusive cumulative sum of sizes: the normalized span starts."""
    c = jnp.cumsum(sizes.astype(jnp.int32))
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), c[:-1]])


def normalize(
    starts: jax.Array,
    sizes: jax.Array,
    pools: Tuple[jax.Array, ...],
    pool_cap: int,
) -> Tuple[jax.Array, jax.Array, Tuple[jax.Array, ...], jax.Array, jax.Array]:
    """Repack spans into a dense, row-ordered pool.

    Returns (new_starts, sizes, new_pools, rowid, emask) where ``rowid[p]`` is
    the owning row of new pool slot p and ``emask`` marks live slots.  Works
    for arbitrary span layouts (post-gather, even duplicated rows) as long as
    the total element count fits ``pool_cap``.
    """
    sizes = sizes.astype(jnp.int32)
    new_starts = dense_starts(sizes)
    total = new_starts[-1] + sizes[-1]
    rowid = owner_rows(new_starts, total, pool_cap)
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    emask = pos < total
    offset = pos - jnp.take(new_starts, rowid, mode="clip")
    src = jnp.take(starts.astype(jnp.int32), rowid, mode="clip") + offset
    src = jnp.where(emask, src, 0)
    new_pools = tuple(jnp.take(p, src, axis=0, mode="clip") for p in pools)
    # duplicated spans (join-expanded rows, shared literals) can exceed the
    # static pool; rows past the fit are truncated — callers surface the
    # overflow flag as a row error so this never silently corrupts
    overflow = total > pool_cap
    return new_starts, sizes, new_pools, rowid, emask, overflow


def pool_boundaries(rowid: jax.Array, emask: jax.Array) -> jax.Array:
    """True at the first live slot of each row's run (normalized pools)."""
    prev = jnp.concatenate([jnp.full((1,), -1, rowid.dtype), rowid[:-1]])
    return emask & (rowid != prev)


def segment_reduce(
    values: jax.Array,
    starts: jax.Array,
    sizes: jax.Array,
    rowid: jax.Array,
    emask: jax.Array,
    op: str,
    init=None,
    value_mask=None,
) -> jax.Array:
    """Per-row reduction over a *normalized* pool -> [rows] array.

    Empty rows (and rows whose elements are all masked off by ``value_mask``)
    get ``init`` (default: the op identity).  sum = prefix-scan difference at
    span ends; min/max = segmented scan + end gather.
    """
    from .segmented import identity_for, segmented_scan

    ident = jnp.asarray(identity_for(op, values.dtype), values.dtype)
    fill = ident if init is None else jnp.asarray(init, values.dtype)
    live = emask if value_mask is None else (emask & value_mask)
    v = jnp.where(live, values, ident)
    starts = starts.astype(jnp.int32)
    sizes = sizes.astype(jnp.int32)
    ends = jnp.maximum(starts + sizes - 1, 0)
    if op == "sum":
        totals = jnp.cumsum(v)
        at_end = jnp.take(totals, ends, mode="clip")
        before = jnp.where(
            starts > 0, jnp.take(totals, starts - 1, mode="clip"), jnp.zeros((), v.dtype)
        )
        out = at_end - before
    else:
        boundary = pool_boundaries(rowid, emask)
        scanned = segmented_scan(v, boundary, op)
        out = jnp.take(scanned, ends, mode="clip")
    if value_mask is not None:
        nlive = segment_reduce(
            live.astype(jnp.int32), starts, sizes, rowid, emask, "sum"
        )
        return jnp.where(nlive > 0, out, fill)
    return jnp.where(sizes > 0, out, fill)


def segment_any(match, starts, sizes, rowid, emask) -> jax.Array:
    return (
        segment_reduce(
            match.astype(jnp.int32), starts, sizes, rowid, emask, "sum", init=0
        )
        > 0
    )


def compact_pool(
    keep: jax.Array,
    starts: jax.Array,
    sizes: jax.Array,
    rowid: jax.Array,
    emask: jax.Array,
    pools: Tuple[jax.Array, ...],
) -> Tuple[jax.Array, jax.Array, Tuple[jax.Array, ...], jax.Array, jax.Array]:
    """Drop pool elements where ``keep`` is False (array filter / distinct).

    Input must be normalized; output is normalized.  Returns
    (starts, sizes, pools, rowid, emask) of the compacted pool.
    """
    live = keep & emask
    new_sizes = segment_reduce(
        live.astype(jnp.int32), starts, sizes, rowid, emask, "sum", init=0
    )
    # stable partition: kept elements first, original (row, offset) order kept
    perm = jnp.argsort(~live, stable=True).astype(jnp.int32)
    new_pools = tuple(jnp.take(p, perm, axis=0, mode="clip") for p in pools)
    pool_cap = keep.shape[0]
    new_starts = dense_starts(new_sizes)
    total = new_starts[-1] + new_sizes[-1]
    new_rowid = owner_rows(new_starts, total, pool_cap)
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    return new_starts, new_sizes, new_pools, new_rowid, pos < total


def sort_within_rows(
    order_key: jax.Array,
    rowid: jax.Array,
    emask: jax.Array,
    pools: Tuple[jax.Array, ...],
    descending: bool = False,
) -> Tuple[jax.Array, ...]:
    """Sort each row's elements by ``order_key`` (normalized pool, spans kept)."""
    if descending:
        if jnp.issubdtype(order_key.dtype, jnp.integer):
            order_key = -order_key.astype(jnp.int64)
        else:
            order_key = -order_key
    row_key = jnp.where(emask, rowid.astype(jnp.int32), jnp.int32(2**31 - 1))
    ops = [row_key, order_key] + list(pools)
    sorted_ops = jax.lax.sort(ops, num_keys=2)
    return tuple(sorted_ops[2:])
