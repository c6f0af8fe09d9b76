"""Grace hash join: memory-bounded joins by key-hash partitioning.

Reference: velox/exec/Spiller.h:29-39 (kHashJoinBuild/kHashJoinProbe spill
kinds), velox/exec/HashBuild.cpp spill partitioning, and
docs/develop/spilling.rst — when a hash-join build exceeds the memory budget,
the reference spills build AND probe rows partitioned by key hash and joins
partition by partition, recursively re-partitioning partitions that still do
not fit.

Device re-design: the device never scatters rows into spill partitions.  Both
sides partition by the SAME salted splitmix64 key hash, but each side in its
natural habitat:

* the build side is a host Table (it overflowed HBM — that is why we are
  here); numpy boolean masks split it into P partition tables;
* the probe side stays a device pipeline; a FilterNode with the identical
  hash predicate (registered as ``__grace_hash``) is injected above the probe
  subtree, so each pass's scan program drops foreign-partition rows on
  device — the probe is re-scanned P times instead of spilled, which is the
  right trade when probe tiles are HBM-resident and the host link is slow.

Every equi-join type is partition-local under same-key-hash partitioning:
matches can only happen inside a partition, a probe row belongs to exactly
one partition (LEFT/semi/anti null-extension decided there), and unmatched
build rows of a FULL join surface in their own partition's epilogue.
NULL keys ride partition 0 (they never match; FULL/LEFT null-key rows are
emitted by partition 0's machinery).

Recursion: an oversized partition re-enters this path through the child
LocalExecutor's own memory pool, with a fresh salt derived from the new plan
node ids — the analog of the reference's multi-level recursive spill
(Spiller::state().maxPartitions per level).
"""

from __future__ import annotations

import zlib
from typing import List, Optional

import numpy as np

from ..dtypes import BIGINT
from ..io.table import Table
from ..plan.nodes import FilterNode, HashJoinNode, PlanNode, ValuesNode

_MIX1 = 0x9E3779B97F4A7C15
_MIX2 = 0xBF58476D1CE4E5B9
_MIX3 = 0x94D049BB133111EB


def splitmix64_np(x: np.ndarray, salt: int) -> np.ndarray:
    """Host-side salted splitmix64 (must match ``__grace_hash`` bit-for-bit)."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) ^ np.uint64(salt)
        z = (z + np.uint64(_MIX1)) * np.uint64(_MIX2)
        z ^= z >> np.uint64(30)
        z *= np.uint64(_MIX3)
        z ^= z >> np.uint64(27)
    return z.astype(np.int64)


def _register_grace_hash():
    import jax.numpy as jnp

    from ..expr.registry import ANY, INTEGER, DEFAULT_REGISTRY as reg

    if reg.signatures("__grace_hash"):
        return

    def _hash(ctx, out_t, arg_ts, a, salt):
        # int64 first: mirrors the host partitioner bit-for-bit (negative
        # values would differ under a direct float->uint64 conversion)
        z = a.astype(jnp.int64).astype(jnp.uint64) ^ jnp.asarray(salt).astype(
            jnp.uint64
        )
        z = (z + jnp.uint64(_MIX1)) * jnp.uint64(_MIX2)
        z = z ^ (z >> jnp.uint64(30))
        z = z * jnp.uint64(_MIX3)
        z = z ^ (z >> jnp.uint64(27))
        return z.astype(jnp.int64)

    reg.register("__grace_hash", [ANY, INTEGER], BIGINT, _hash)


def _salt_of(node: PlanNode) -> int:
    """Deterministic per-join salt: recursion levels create new node ids, so
    re-partitioning an oversized partition uses an independent hash."""
    return zlib.crc32(str(getattr(node, "id", "join")).encode()) or 1


def _combined_hash_np(table: Table, keys, salt: int) -> np.ndarray:
    h = None
    for k in keys:
        # same int64 conversion as the join's own key packing (joins.py)
        arr = np.asarray(table.columns[k]).astype(np.int64)
        hk = splitmix64_np(arr, salt)
        valid = table.validities.get(k)
        if valid is not None:
            hk = np.where(valid, hk, np.int64(0))
        h = hk if h is None else (h ^ hk)
    return h


def probe_filter_expr(node: HashJoinNode, P: int, p: int, salt: int):
    """The device-side partition predicate for pass ``p`` as a parsed Expr."""
    from ..expr.parser import parse_expr

    _register_grace_hash()
    schema = node.left.output_schema
    parts = [f"__grace_hash({k}, {salt})" for k in node.left_keys]
    text = parts[0]
    for t in parts[1:]:
        text = f"bitwise_xor({text}, {t})"
    pred = f"bitwise_and({text}, {P - 1}) = {p}"
    null_any = " or ".join(f"{k} is null" for k in node.left_keys)
    if p == 0:
        pred = f"({pred}) or {null_any}"
    else:
        pred = f"({pred}) and not ({null_any})"
    return parse_expr(pred, schema)


def partition_build(table: Table, keys, P: int, salt: int) -> List[Table]:
    """Split the host build table into P partition tables by salted key hash;
    NULL-key rows land in partition 0."""
    h = _combined_hash_np(table, keys, salt)
    part = h & np.int64(P - 1)
    for k in keys:
        valid = table.validities.get(k)
        if valid is not None:
            part = np.where(valid, part, np.int64(0))
    out = []
    for p in range(P):
        rows = np.flatnonzero(part == p)
        out.append(
            Table(
                table.schema,
                {n: np.asarray(v)[rows] for n, v in table.columns.items()},
                table.string_tables,
                {n: np.asarray(v)[rows] for n, v in table.validities.items()},
            )
        )
    return out


def pick_partition_count(build_bytes: int, budget: Optional[int]) -> int:
    """Power-of-two partition count targeting ~quarter-budget builds."""
    if not budget:
        return 4
    target = max(budget // 4, 1)
    P = 1
    while P < 64 and build_bytes // P > target:
        P *= 2
    return max(P, 2)


def grace_join_table(
    node: HashJoinNode,
    build_table: Table,
    tile_rows: int,
    config,
) -> Table:
    """Execute ``node`` partition by partition; returns the joined host Table.

    The caller hands over the already-materialized (host) build table; probe
    passes re-plan the join with a device-side partition filter and a
    ValuesNode build partition, each executed by a child LocalExecutor under
    its own memory pool (recursive pressure re-enters this path).
    """
    import dataclasses

    from ..utils.testvalue import adjust

    if node.null_aware:
        # NOT IN semantics resolve GLOBALLY before partitioning, after which
        # every partition-local join is a plain ANTI (reference:
        # HashJoinBridge's nullAware build summary):
        #   1. any NULL build key  -> x NOT IN (..., NULL) is never TRUE ->
        #      the whole result is empty
        #   2. empty build         -> every probe row keeps
        #   3. otherwise           -> probe NULL keys drop (FALSE/UNKNOWN),
        #      and no partition-local null handling remains
        import numpy as np

        from ..expr.parser import parse_expr
        from .runner import LocalExecutor as _LE

        def _key_has_null(k):
            v = build_table.validities.get(k)
            return v is not None and not np.asarray(v).all()

        out_names = list(node.output_columns)
        if any(_key_has_null(k) for k in node.right_keys):
            probe_schema = node.left.output_schema
            false_pred = parse_expr("1 = 0", probe_schema)
            empty = _LE(
                FilterNode(node.left, false_pred), tile_rows, config
            ).run()
            return empty.select(out_names)
        if build_table.num_rows == 0:
            return _LE(node.left, tile_rows, config).run().select(out_names)
        not_null = " and ".join(
            f"{k} is not null" for k in node.left_keys
        )
        node = dataclasses.replace(
            node,
            left=FilterNode(
                node.left, parse_expr(not_null, node.left.output_schema)
            ),
            null_aware=False,
        )
    from .grouped import concat_tables
    from .memory import Spiller, table_nbytes
    from .runner import LocalExecutor

    adjust("LocalExecutor::graceJoin", node)
    salt = _salt_of(node)
    P = pick_partition_count(
        table_nbytes(build_table), config.query_memory_limit_bytes
    )
    builds = partition_build(build_table, list(node.right_keys), P, salt)
    total_rows = build_table.num_rows
    spiller = None
    parts: List[Table] = []
    acc = 0
    for p in range(P):
        sub = dataclasses.replace(
            node,
            left=FilterNode(node.left, probe_filter_expr(node, P, p, salt)),
            right=ValuesNode(builds[p]),
        )
        sub_config = config
        if total_rows and builds[p].num_rows >= max(1, (3 * total_rows) // 4):
            # no-progress partition (one key dominates the build): hashing
            # cannot split equal keys, so recursing would loop forever —
            # run this partition unbounded instead (the reference hits the
            # same wall and switches its last spill level to kNoMoreSpill,
            # Spiller.cpp maxSpillLevel)
            adjust("LocalExecutor::graceNoProgress", node)
            sub_config = config.copy(query_memory_limit_bytes=None)
        part = LocalExecutor(sub, tile_rows, sub_config).run()
        parts.append(part)
        acc += table_nbytes(part)
        if (
            config.spill_enabled
            and acc > config.spill_bytes_threshold
            and not any(t.is_complex for t in part.schema.types)
        ):
            spiller = spiller or Spiller(
                compress=config.spill_compression != "none"
            )
            for t in parts:
                spiller.spill(t)
            parts.clear()
            acc = 0
    if spiller is not None:
        restored = list(spiller.restore())
        spiller.cleanup()
        parts = restored + parts
    return concat_tables(parts)
