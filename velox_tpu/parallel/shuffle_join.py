"""Partitioned (shuffle) hash joins over a device mesh.

Reference: velox/exec/HashJoinBridge.h + core/PlanNode.h:1107 — the reference
partitions BOTH join sides by key hash (PartitionedOutput kPartitioned mode) so
each worker joins only its key range; small build sides broadcast instead
(kBroadcast).  The choice is made by build cardinality.

Device re-design: the build side is partitioned by the SAME splitmix64 hash the
device exchange uses (parallel/exchange.py hash64) and uploaded as stacked
``[n_devices, part_capacity]`` arrays sharded over the mesh axis — device d
holds exactly the build rows with ``hash64(key) % n == d``.  Probe rows reach
their partition through ``exchange_rows`` (hash partition + all_to_all over
ICI) inside the per-tile shard_map program, then the standard sort-merge-lookup
probe (exec/joins.py) runs device-locally.

Scope: INNER/LEFT/LEFT_SEMI/ANTI builds, unique-key or duplicate-key.  A
duplicate-key (N:M) build keeps its per-key runs (start, count) per partition —
hash partitioning sends every row of a key to the same device, so the
device-local expansion probe (exec/joins.py probe_spans/expand) sees the
complete run.  Expansion output sizes are data-dependent: the executor sizes
each expansion's output bucket with slack, counts overflow on device, and
re-probes exact sizes on overflow (parallel/runner.py two-phase protocol).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..exec.joins import HashJoinExec, JoinBuildError, _KEY_SENTINEL, _NormalizedKey
from ..io.table import Table
from ..plan.nodes import HashJoinNode, JoinType


def hash64_np(keys: np.ndarray) -> np.ndarray:
    """numpy twin of parallel.exchange.hash64 — MUST stay bit-identical so
    host-partitioned build rows land on the device their probes shuffle to."""
    x = keys.astype(np.uint64)
    x = x * np.uint64(0x9E3779B97F4A7C15)
    x = x ^ (x >> np.uint64(31))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    return x


@dataclasses.dataclass
class ShuffleJoinState:
    """Host-partitioned build side, uploaded mesh-sharded.

    ``keys``/``cols`` are stacked [n, cap] device arrays with a NamedSharding
    over the mesh axis; ``counts`` [n] gives each partition's live prefix.
    """

    node: HashJoinNode
    keys: jax.Array  # [n, cap] int64, sentinel beyond counts[d]
    cols: Dict[str, Tuple[jax.Array, Optional[jax.Array]]]  # [n, cap] payloads
    counts: jax.Array  # [n] int32
    part_capacity: int
    normalizer: Optional[_NormalizedKey]
    build_tables: Dict[str, object]
    # duplicate-key (expansion) builds: per-slot run info, local indices
    expansion: bool = False
    run_start: Optional[jax.Array] = None  # [n, cap] int32
    run_count: Optional[jax.Array] = None  # [n, cap] int32
    # host-known (min, max) over ALL partitions' valid packed keys: a superset
    # range is valid per device and enables the packed single-operand probe
    key_range: Optional[Tuple[int, int]] = None

    def local_exec(self, d_keys, d_cols, d_count, d_rs=None, d_rc=None) -> HashJoinExec:
        """Build the device-local HashJoinExec view inside a shard_map trace:
        the [1, cap] shard reshapes to [cap] and becomes ordinary join state."""
        cap = self.part_capacity
        keys = d_keys.reshape((cap,))
        valid = jnp.arange(cap, dtype=jnp.int32) < d_count.reshape(())
        keys = jnp.where(valid, keys, jnp.int64(_KEY_SENTINEL))
        cols = {}
        for name, (g, gv) in d_cols.items():
            cols[name] = (
                g.reshape((cap,) + g.shape[2:]),
                None if gv is None else gv.reshape((cap,)),
            )
        return HashJoinExec(
            self.node,
            keys,
            cols,
            cap,
            self.build_tables,
            self.normalizer,
            valid,
            expansion=self.expansion,
            run_start=None if d_rs is None else d_rs.reshape((cap,)),
            run_count=None if d_rc is None else d_rc.reshape((cap,)),
            key_range=self.key_range,
            allow_fused=False,  # downstream shapes are sized to the capacity
        )


def partition_build(
    node: HashJoinNode,
    build_result: Table,
    n: int,
    mesh,
    axis: str,
) -> ShuffleJoinState:
    """Partition an executed build-side Table by key hash and upload sharded.

    Raises JoinBuildError for duplicate-key builds outside SEMI/ANTI (callers
    fall back to broadcast).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    key_names = list(node.right_keys)
    key_arrays = [np.asarray(build_result.columns[k]) for k in key_names]
    jt = node.join_type
    if jt not in (JoinType.INNER, JoinType.LEFT, JoinType.LEFT_SEMI, JoinType.ANTI):
        raise JoinBuildError(f"shuffle join does not support {jt}")
    if node.null_aware:
        # a NULL build key must empty EVERY partition's output — a global
        # property the per-partition probes cannot see; broadcast instead
        raise JoinBuildError("null-aware ANTI joins broadcast the build side")

    # NULL build keys never match (see HashJoinExec.build)
    keep = None
    for k in key_names:
        validity = build_result.validities.get(k)
        if validity is not None and not validity.all():
            keep = validity if keep is None else (keep & validity)
    if keep is not None:
        key_arrays = [a[keep] for a in key_arrays]

    if len(key_names) == 1:
        normalizer = None
        packed = key_arrays[0].astype(np.int64)
    else:
        normalizer = _NormalizedKey.fit(key_arrays)
        packed = normalizer.pack_host(key_arrays)

    semi = jt in (JoinType.LEFT_SEMI, JoinType.ANTI)
    expansion = False
    if semi:
        packed = np.unique(packed)
        row_src = None
    else:
        order = np.argsort(packed, kind="stable")
        packed = packed[order]
        expansion = bool(
            len(packed) > 1 and (packed[1:] == packed[:-1]).any()
        )
        row_src = (np.flatnonzero(keep)[order] if keep is not None else order)

    key_range = (
        (int(packed.min()), int(packed.max()))
        if len(packed) and normalizer is None
        else (
            (0, int(packed.max())) if len(packed) else None
        )  # packed multi-key values are non-negative
    )
    dest = (hash64_np(packed) % np.uint64(n)).astype(np.int64)
    # stable partition: rows stay key-sorted within each partition (and every
    # row of a duplicate key lands on ONE device with its run contiguous)
    part_order = np.argsort(dest, kind="stable")
    dest_sorted = dest[part_order]
    counts = np.bincount(dest_sorted, minlength=n).astype(np.int32)
    cap = 8
    while cap < max(int(counts.max()) if len(counts) else 1, 1):
        cap *= 2

    def stack(arr: np.ndarray, fill) -> np.ndarray:
        out = np.full((n, cap) + arr.shape[1:], fill, dtype=arr.dtype)
        start = 0
        for d in range(n):
            c = int(counts[d])
            out[d, :c] = arr[start : start + c]
            start += c
        return out

    shard = NamedSharding(mesh, P(axis))
    keys_part = packed[part_order]
    keys_stacked = jax.device_put(stack(keys_part, _KEY_SENTINEL), shard)
    rs_d = rc_d = None
    if expansion:
        # per-partition run (start, count) in LOCAL slot indices: runs are
        # contiguous within a partition, so recompute boundaries per device
        rs = np.zeros(len(keys_part), dtype=np.int32)
        rc = np.zeros(len(keys_part), dtype=np.int32)
        start = 0
        for d in range(n):
            c = int(counts[d])
            seg = keys_part[start : start + c]
            if c:
                boundary = np.ones(c, dtype=bool)
                boundary[1:] = seg[1:] != seg[:-1]
                starts_l = np.flatnonzero(boundary)
                lengths = np.diff(np.append(starts_l, c))
                rs[start : start + c] = np.repeat(starts_l, lengths)
                rc[start : start + c] = np.repeat(lengths, lengths)
            start += c
        rs_d = jax.device_put(stack(rs, 0), shard)
        rc_d = jax.device_put(stack(rc, 0), shard)
    cols: Dict[str, Tuple[jax.Array, Optional[jax.Array]]] = {}
    right_schema = node.right.output_schema
    if not semi:
        src_sorted = row_src[part_order]
        for name in node.output_columns:
            if name in right_schema and name not in key_names:
                arr = np.asarray(build_result.columns[name])[src_sorted]
                g = jax.device_put(stack(arr, 0), shard)
                validity = build_result.validities.get(name)
                gv = None
                if validity is not None:
                    gv = jax.device_put(
                        stack(validity[src_sorted], False), shard
                    )
                cols[name] = (g, gv)
    counts_d = jax.device_put(counts, shard)
    return ShuffleJoinState(
        node,
        keys_stacked,
        cols,
        counts_d,
        cap,
        normalizer,
        dict(build_result.string_tables),
        expansion=expansion,
        run_start=rs_d,
        run_count=rc_d,
        key_range=key_range,
    )


def probe_pack(state: ShuffleJoinState, batch) -> jax.Array:
    """Traced: the probe rows' normalized int64 keys (for the exchange's
    destination hash).  Out-of-range / NULL multi-key probes pack to -1 —
    they hash somewhere consistent and can never equal a build key there
    (packed build keys are non-negative)."""
    cap = batch.capacity
    vals, key_ok = [], jnp.ones((cap,), jnp.bool_)
    for k in state.node.left_keys:
        v, val = batch.column(k).decode(cap)
        vals.append(v)
        if val is not None:
            key_ok = key_ok & val
    if state.normalizer is None:
        return vals[0].astype(jnp.int64)
    packed, _ = state.normalizer.pack_device(vals, key_ok)
    return packed


def flatten_state(state: ShuffleJoinState):
    """(arrays, rebuild): the sharded arrays as shard_map operands + a
    function mapping the per-device views back to a local HashJoinExec."""
    arrays: List[jax.Array] = [state.keys, state.counts]
    if state.expansion:
        arrays += [state.run_start, state.run_count]
    base = len(arrays)
    layout: List[Tuple[str, bool]] = []
    for name, (g, gv) in state.cols.items():
        arrays.append(g)
        layout.append((name, gv is not None))
        if gv is not None:
            arrays.append(gv)

    def rebuild(local_arrays) -> HashJoinExec:
        keys, counts = local_arrays[0], local_arrays[1]
        rs = rc = None
        if state.expansion:
            rs, rc = local_arrays[2], local_arrays[3]
        cols = {}
        i = base
        for name, has_validity in layout:
            g = local_arrays[i]
            i += 1
            gv = None
            if has_validity:
                gv = local_arrays[i]
                i += 1
            cols[name] = (g, gv)
        return state.local_exec(keys, cols, counts, rs, rc)

    return arrays, rebuild
