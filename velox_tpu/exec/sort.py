"""Device-resident sort: OrderBy / TopN execute on the device, not the host.

Reference: velox/exec/OrderBy.h:35 + SortBuffer.cpp (accumulate, sort, emit),
velox/exec/TopN.h:23 (bounded priority queue), velox/exec/Merge.h:187 +
TreeOfLosers.h (k-way merge of sorted runs).

Device re-design — no priority queues, no loser trees, no scatters:

* Every sort key is encoded as an **order-preserving int64 operand**
  (``sort_operand``): integers widen, DOUBLE uses the sign-flip bit trick,
  VARCHAR codes gather through the dictionary's lexicographic ranks, DESC is
  bitwise NOT, NULLs go to an extreme sentinel per ``nulls_first``.  One
  ``jax.lax.sort`` then implements any ORDER BY clause.
* **TopN**: each tile sorts itself and keeps only its top K rows (a tile's
  K+1-th row can never be in the global top K), then one merge program sorts
  the n_tiles*K survivors and the host fetches exactly K rows.  With a slow
  host link this is the whole point: bytes fetched scale with K, not with the
  input (utils/transfer.py discipline).
* **OrderBy**: tiles are concatenated on device (dead rows carry a liveness
  flag that sorts them last) and sorted in one program; the host fetch of the
  live prefix arrives already ordered — the host lexsort finisher disappears.

Complex-typed (ARRAY/MAP/ROW) outputs fall back to the host finisher: their
element pools would need re-densification per permutation, which the
result-sized fetch already does better host-side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import RowType
from ..plan.nodes import SortKey
from ..vector.column import Batch, Column

_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min


def float_to_ordered_i64(x: jax.Array) -> jax.Array:
    """Map a float column to an int64 whose ordering matches the float
    ordering; NaN maps above +inf (Presto's NaN-is-largest convention) and
    ±0.0 share one code: the sign-magnitude bit flip of the IEEE bits
    (ops/f64bits)."""
    from ..ops.f64bits import f64_to_ordered

    return f64_to_ordered(x.astype(jnp.float64))


def sort_operand(
    values: jax.Array,
    validity: Optional[jax.Array],
    key: SortKey,
    ranks: Optional[np.ndarray] = None,
) -> jax.Array:
    """Encode one sort key column as an order-preserving int64 operand."""
    if ranks is not None:
        v = jnp.take(
            jnp.asarray(ranks, dtype=jnp.int32),
            values.astype(jnp.int32),
            mode="clip",
        ).astype(jnp.int64)
    elif jnp.issubdtype(values.dtype, jnp.floating):
        v = float_to_ordered_i64(values)
    else:
        v = values.astype(jnp.int64)
    if not key.ascending:
        v = ~v  # monotone-decreasing, overflow-free (unlike negation)
    if validity is not None:
        sentinel = jnp.int64(_I64_MIN if key.nulls_first else _I64_MAX)
        v = jnp.where(validity, v, sentinel)
    return v


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """Static description of an ORDER BY over a pipeline's output schema.

    ``ranks`` holds, per key, the VARCHAR dictionary's code->lexicographic-rank
    table (resolved at plan time from the column's StringTable) or None.
    """

    keys: Tuple[SortKey, ...]
    key_indices: Tuple[int, ...]  # column index per key
    ranks: Tuple[Optional[np.ndarray], ...]
    schema: RowType

    @staticmethod
    def plan(
        keys: Sequence[SortKey],
        schema: RowType,
        strings_of: Dict[str, object],
    ) -> Optional["SortSpec"]:
        """None if the sort cannot run on device: a complex-typed output
        column, a missing key, or a VARCHAR key with no resolvable dictionary
        (the host finisher covers those)."""
        if any(t.is_complex for t in schema.types):
            return None
        idx, ranks = [], []
        for k in keys:
            if k.name not in schema:
                return None
            idx.append(schema.index_of(k.name))
            if schema.type_of(k.name).is_string:
                tab = strings_of.get(k.name)
                if tab is None:
                    return None
                ranks.append(np.asarray(tab.sort_permutation(), np.int32))
            else:
                ranks.append(None)
        return SortSpec(tuple(keys), tuple(idx), tuple(ranks), schema)

    def operands(
        self, cols: Sequence[Column], capacity: int
    ) -> List[jax.Array]:
        ops = []
        for key, i, rk in zip(self.keys, self.key_indices, self.ranks):
            values, validity = cols[i].decode(capacity)
            ops.append(sort_operand(values, validity, key, rk))
        return ops


def flatten_columns(
    cols: Sequence[Column], capacity: int
) -> Tuple[List[jax.Array], List[bool]]:
    """(arrays, layout): per column its data then (optionally) its validity."""
    arrays: List[jax.Array] = []
    layout: List[bool] = []
    for c in cols:
        fc = c.flatten(capacity)
        arrays.append(fc.data)
        layout.append(fc.validity is not None)
        if fc.validity is not None:
            arrays.append(fc.validity)
    return arrays, layout


def tile_sorted_prefix(
    spec: SortSpec, batch: Batch, keep: Optional[int]
) -> Tuple[List[jax.Array], List[bool], jax.Array]:
    """Sort one tile by ``spec`` and keep the first ``keep`` live rows
    (None = all).  Returns (flat arrays, layout, live-count): each column's
    data (+validity) truncated to ``keep`` rows, live rows first in sort
    order.

    The per-tile half of device TopN: a tile's K+1-th row can never reach the
    global top K, so each tile forwards only K rows to the merge (the
    reference's per-driver TopN priority queue, velox/exec/TopN.cpp, as a
    sorted prefix).
    """
    cap = batch.capacity
    mask = batch.active_mask()
    ops = [~mask] + spec.operands(batch.columns, cap)
    perm_src = jnp.arange(cap, dtype=jnp.int32)
    # the row position is a final sort key: a total order, so ties resolve
    # by input position (deterministic; matches the host lexsort's stability)
    sorted_ops = jax.lax.sort(ops + [perm_src], num_keys=len(ops) + 1)
    perm = sorted_ops[-1]
    count = jnp.sum(mask).astype(jnp.int32)
    if keep is not None and keep < cap:
        perm = perm[:keep]
        count = jnp.minimum(count, keep)
    arrays, layout = flatten_columns(
        [c.gather(perm) for c in batch.columns], perm.shape[0]
    )
    return arrays, layout, count


def merge_sorted_chunks(
    spec: SortSpec,
    chunks: Sequence[Sequence[jax.Array]],
    counts: Sequence[jax.Array],
    layout: Sequence[bool],
    keep: Optional[int],
) -> Tuple[List[jax.Array], jax.Array]:
    """Merge per-tile flat-array chunks into one globally sorted prefix.

    One concatenated sort replaces the reference's TreeOfLosers k-way merge
    (velox/exec/TreeOfLosers.h): dead/padding rows carry a liveness flag that
    sorts them past every live row.  Returns (flat arrays, total live count),
    truncated to ``keep`` rows if given.
    """
    cat: List[jax.Array] = []
    k = 0
    for has_validity in layout:
        cat.append(jnp.concatenate([c[k] for c in chunks]))
        k += 1
        if has_validity:
            cat.append(jnp.concatenate([c[k] for c in chunks]))
            k += 1
    dead_parts = []
    for chunk, cnt in zip(chunks, counts):
        n = chunk[0].shape[0]
        dead_parts.append(jnp.arange(n, dtype=jnp.int32) >= cnt)
    dead = jnp.concatenate(dead_parts)
    total = dead.shape[0]

    # rebuild flat Column views over the concatenated arrays for the operands
    cols: List[Column] = []
    k = 0
    for dtype, has_validity in zip(spec.schema.types, layout):
        data = cat[k]
        k += 1
        validity = None
        if has_validity:
            validity = cat[k]
            k += 1
        cols.append(Column.flat(data, dtype, validity))
    ops = [dead] + spec.operands(cols, total)
    perm_src = jnp.arange(total, dtype=jnp.int32)
    sorted_ops = jax.lax.sort(ops + [perm_src], num_keys=len(ops) + 1)
    perm = sorted_ops[-1]
    live = jnp.sum((~dead).astype(jnp.int32))
    if keep is not None and keep < total:
        perm = perm[:keep]
        live = jnp.minimum(live, keep)
    out = [jnp.take(a, perm, mode="clip") for a in cat]
    return out, live
