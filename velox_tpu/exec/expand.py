"""Cardinality-changing streaming operators: Unnest, GroupId, AssignUniqueId.

Reference: velox/exec/Unnest.cpp, GroupId.cpp, AssignUniqueId.cpp.  These are
the reference's row-expanding operators; on the device they are trace-time batch
transforms that return a batch of a *different static capacity* (the element
pool size for Unnest, capacity x num_sets for GroupId), which downstream steps
consume like any other tile.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp

from ..dtypes import BIGINT, TypeKind
from ..expr.seg import SegValue
from ..ops.segpool import dense_starts, owner_rows
from ..plan.nodes import AssignUniqueIdNode, GroupIdNode, UnnestNode
from ..vector.column import Batch, Column


def apply_unnest(batch: Batch, node: UnnestNode) -> Batch:
    mask = batch.active_mask()
    segs: List[SegValue] = []
    sizes_list = []
    for name in node.unnest:
        col = batch.column(name)
        seg = SegValue.from_column(col)
        sizes = seg.sizes.astype(jnp.int32)
        live = mask if col.validity is None else (mask & col.validity)
        sizes_list.append(jnp.where(live, sizes, 0))
        segs.append(seg)
    out_sizes = sizes_list[0]
    for s in sizes_list[1:]:
        out_sizes = jnp.maximum(out_sizes, s)
    out_starts = dense_starts(out_sizes)
    pool_cap = max(sum(s.pool_cap for s in segs), 1)
    total = out_starts[-1] + out_sizes[-1]
    rowid = owner_rows(out_starts, total, pool_cap)
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    emask = pos < total
    offset = pos - jnp.take(out_starts, rowid, mode="clip")

    cols: List[Column] = []
    for name in node.replicate:
        src = batch.column(name)
        if src.dtype.is_complex:
            cols.append(src.gather(rowid))
            continue
        values, validity = src.decode(batch.capacity)
        v = jnp.take(values, rowid, axis=0, mode="clip")
        val = None if validity is None else jnp.take(validity, rowid, mode="clip")
        cols.append(Column.flat(v, src.dtype, val, src.strings))
    for seg, sizes in zip(segs, sizes_list):
        within = offset < jnp.take(sizes, rowid, mode="clip")
        idx = jnp.clip(
            jnp.take(seg.starts.astype(jnp.int32), rowid, mode="clip") + offset,
            0,
            seg.pool_cap - 1,
        )
        for elems in seg.children:
            taken = elems.take(idx)
            validity = taken.validity
            validity = within if validity is None else (validity & within)
            if isinstance(taken.values, SegValue):
                cols.append(taken.values.to_column(validity))
            else:
                cols.append(
                    Column.flat(taken.values, elems.dtype, validity, elems.strings)
                )
    if node.ordinality_name:
        cols.append(Column.flat((offset + 1).astype(jnp.int64), BIGINT))
    return Batch.make(
        node.output_schema, cols, total, capacity=pool_cap
    )


def apply_groupid(batch: Batch, node: GroupIdNode) -> Batch:
    nsets = len(node.grouping_sets)
    cap = batch.capacity
    mask = batch.active_mask()
    cols: List[Column] = []
    for name in node.output_schema.names[:-1]:  # all but group_id
        src = batch.column(name)
        values, validity = src.decode(cap)
        tiled = jnp.tile(values, nsets)
        base_validity = (
            jnp.tile(validity, nsets) if validity is not None else None
        )
        if name in node.grouping_keys and name not in node.agg_inputs:
            in_set = jnp.concatenate(
                [
                    jnp.full((cap,), name in s, jnp.bool_)
                    for s in node.grouping_sets
                ]
            )
            # zero the VALUES too: downstream grouping compares raw values,
            # so out-of-set keys must collapse to one constant per set (the
            # planner restores their NULL-ness from group_id afterwards)
            tiled = jnp.where(in_set, tiled, jnp.zeros_like(tiled))
            base_validity = (
                in_set if base_validity is None else (base_validity & in_set)
            )
        cols.append(Column.flat(tiled, src.dtype, base_validity, src.strings))
    gid = jnp.repeat(
        jnp.arange(nsets, dtype=jnp.int64), cap, total_repeat_length=cap * nsets
    )
    cols.append(Column.flat(gid, BIGINT))
    selection = jnp.tile(mask, nsets)
    return Batch.make(
        node.output_schema,
        cols,
        cap * nsets,
        selection=selection,
        capacity=cap * nsets,
    )


def apply_assign_unique_id(batch: Batch, node: AssignUniqueIdNode) -> Batch:
    offset = (
        batch.row_offset
        if batch.row_offset is not None
        else jnp.zeros((), jnp.int64)
    )
    ids = (jnp.int64(node.task_unique_id) << 40) | (
        offset + jnp.arange(batch.capacity, dtype=jnp.int64)
    )
    cols = list(batch.columns) + [Column.flat(ids, BIGINT)]
    return batch.with_columns(node.output_schema, cols)
