"""Plan execution: plan tree -> jitted tile programs -> results.

Reference: velox/exec/Task.h:34 + Driver.h:302 + LocalPlanner.cpp:259.  The
reference runs a dynamic pull loop of operators on CPU threads (Driver::runInternal,
exec/Driver.cpp:429).  This design replaces that loop with a **static,
shape-stable compiled program per pipeline**: the host iterates fixed-capacity
tiles from the connector, and one jitted function applies the pipeline's whole
operator chain (scan filter -> filters/projects -> aggregation update) to each
tile, carrying accumulator state between tiles with buffer donation.  Blocking,
batching discipline, and operator fusion all become XLA's problem — which is the
point.

Aggregation modes (see exec/grouping.py): ungrouped (G=1), array (static key
ranges), sort (sort-within-tile + run reduction).  Sort-mode partials merge on
device by default (sorted-carry state; see AggExecutor.merge_sorted_carry) and
fall back to an exact host merge — which also supports spilling — when groups
exceed the carry capacity.

Transfer discipline: every host read is batched and result-sized
(utils/transfer.py); nothing is fetched per tile on the aggregation paths.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import DataType, RowType, TypeKind
from ..expr.compiler import ExprSet
from ..expr.ir import Expr, FieldAccess
from ..io.table import Table
from ..ops.compact import compact
from ..plan.nodes import (
    AggregationNode,
    EnforceSingleRowNode,
    FilterNode,
    HashJoinNode,
    LimitNode,
    OrderByNode,
    PlanNode,
    ProjectNode,
    SortKey,
    TableScanNode,
    TopNNode,
    ValuesNode,
)
from ..utils.devtime import tjit
from ..vector.column import Batch, Column
from ..vector.string_table import StringTable
from .aggregates import BoundAggregate, bind_aggregate
from .grouping import (
    MAX_ARRAY_GROUPS,
    ArrayGrouping,
    KeyInfo,
    SortGrouping,
    key_info,
)


class QueryError(RuntimeError):
    """Raised when any live row produced an evaluation error (division by zero,
    cast failure, ...).  Reference: VeloxUserError via EvalCtx error vectors."""


# ---------------------------------------------------------------------------
# Plan analysis


def resolve_column_strings(node: PlanNode, name: str) -> Optional[StringTable]:
    """Walk provenance of a column down to its scan to find its StringTable."""
    from ..expr.ir import DictLookup

    from ..plan.nodes import ArrowStreamNode

    if isinstance(node, (TableScanNode, ValuesNode, ArrowStreamNode)):
        return node.table.string_tables.get(name)
    if isinstance(node, ProjectNode):
        expr = node.exprs[node.names.index(name)]
        if isinstance(expr, FieldAccess):
            return resolve_column_strings(node.source, expr.name)
        if isinstance(expr, DictLookup) and expr.strings is not None:
            # string function bound to a new result dictionary (e.g. substr)
            return expr.strings
        if expr.dtype.is_string:
            # result reuses an input column's dictionary (see ExprSet string prop)
            hit = _first_string_field(expr)
            if hit is not None:
                return resolve_column_strings(node.source, hit)
        return None
    from ..plan.nodes import UnnestNode

    if isinstance(node, UnnestNode):
        for col, names in zip(node.unnest, node.unnested_names):
            if name in names:
                return _element_strings(node.source, col, names.index(name))
    if node.sources:
        for s in node.sources:
            if name in s.output_schema:
                return resolve_column_strings(s, name)
    return None


def resolve_column_bounds(node: PlanNode, name: str):
    """Walk provenance of a column down to its scan for (lo, hi) value bounds.

    Feeds the normalized-key sort packing (ops/sortkey.py) — the analog of the
    reference's VectorHasher range mode computed from column stats
    (velox/exec/VectorHasher.h:118) — and the narrow-sum decision
    (AggExecutor: a sum whose bound x capacity provably fits int64 drops the
    wide 96-bit limb accumulators).  Conservative: any step that can produce
    values outside the source column's range returns None (multi-operand sort
    fallback)."""
    from ..plan.nodes import ArrowStreamNode

    if isinstance(node, (TableScanNode, ValuesNode, ArrowStreamNode)):
        return node.table.column_bounds(name)
    if isinstance(node, ProjectNode):
        expr = node.exprs[node.names.index(name)]
        return _expr_bounds(expr, node.source)
    if isinstance(node, (FilterNode, LimitNode, TopNNode, OrderByNode)):
        return resolve_column_bounds(node.sources[0], name)
    if isinstance(node, HashJoinNode):
        # join output columns pass through from one side unchanged
        for s in (node.left, node.right):
            if name in s.output_schema:
                return resolve_column_bounds(s, name)
        return None
    return None


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _expr_bounds(e: Expr, src: PlanNode):
    """Interval arithmetic over integer-backed expressions (ints, dates,
    short decimals): (lo, hi) of the DEVICE representation, or None.

    Handles field provenance, integer/decimal literals, the implicit CASTs
    the registry inserts (decimal rescale = x10^ds; integer widening), and
    plus/minus/multiply/negate whose semantics are plain representation
    arithmetic (functions/presto/scalar.py: after coercion plus/minus share
    a scale, and multiply is va*vb with scale s1+s2).  Any overflow past
    int64 returns None."""
    from ..expr.ir import Call, Constant, Special, SpecialForm

    def _int_backed(t: DataType) -> bool:
        if t.kind == TypeKind.DECIMAL:
            return not t.is_long_decimal
        return t.is_integer or t.kind in (TypeKind.DATE, TypeKind.BOOLEAN)

    if isinstance(e, FieldAccess):
        return resolve_column_bounds(src, e.name)
    if isinstance(e, Constant):
        v = e.value
        if v is None or not _int_backed(e.dtype):
            return None
        if isinstance(v, (bool, np.bool_, int, np.integer)):
            return (int(v), int(v))
        return None
    if (
        isinstance(e, Special)
        and e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST)
        and len(e.args) == 1
    ):
        st, dt = e.args[0].dtype, e.dtype
        if not (_int_backed(st) and _int_backed(dt)):
            return None
        inner = _expr_bounds(e.args[0], src)
        if inner is None:
            return None
        s_in = st.scale if st.kind == TypeKind.DECIMAL else 0
        s_out = dt.scale if dt.kind == TypeKind.DECIMAL else 0
        d = s_out - s_in
        if d < 0:
            return None  # representation shrinks with rounding: bail
        lo, hi = inner[0] * 10**d, inner[1] * 10**d
        if lo < _I64_MIN or hi > _I64_MAX:
            return None
        return (lo, hi)
    if isinstance(e, Call) and e.name in ("plus", "minus", "multiply", "negate"):
        if not _int_backed(e.dtype):
            return None
        bs = [_expr_bounds(a, src) for a in e.args]
        if any(b is None for b in bs):
            return None
        if e.name == "negate":
            lo, hi = -bs[0][1], -bs[0][0]
        elif e.name == "plus":
            if e.args[0].dtype != e.args[1].dtype:
                return None  # un-aligned scales: representation math invalid
            lo, hi = bs[0][0] + bs[1][0], bs[0][1] + bs[1][1]
        elif e.name == "minus":
            if e.args[0].dtype != e.args[1].dtype:
                return None
            lo, hi = bs[0][0] - bs[1][1], bs[0][1] - bs[1][0]
        else:  # multiply: representation product (scale s1+s2)
            corners = [
                a * b for a in bs[0] for b in bs[1]
            ]
            lo, hi = min(corners), max(corners)
        if lo < _I64_MIN or hi > _I64_MAX:
            return None
        return (lo, hi)
    return None


def resolve_affine_product(src: PlanNode, name: str):
    """Resolve a named aggregation input to ``const * prod(scale*col + off)``
    over SCAN columns, or None.

    Feeds the int32 grouped piece-sum lowering (ops/piece_sum.py):
    a sum input that is a product of affine transforms of scan columns can be
    computed in-kernel from the raw bounds-narrowed device columns, so the
    whole grouped aggregation reads each scanned byte exactly once.  Returns
    (const, [(scan_node, col_name, scale, offset), ...]) with all literals
    folded.  Mirrors resolve_column_bounds' provenance walk; conservative —
    anything unrecognized returns None."""
    from ..expr.ir import Call, Special, SpecialForm

    def field(nm, node):
        if isinstance(node, TableScanNode):
            return ("scan", node, nm) if nm in node.output_schema.names else None
        if isinstance(node, ProjectNode):
            if nm in node.names:
                return ("expr", node.exprs[node.names.index(nm)], node.source)
            return None
        if isinstance(node, FilterNode):
            return field(nm, node.sources[0])
        return None

    def go(e, node):
        """-> (const, factors) with value == const * prod(s*col + o), or None."""
        if isinstance(e, FieldAccess):
            r = field(e.name, node)
            if r is None:
                return None
            if r[0] == "scan":
                return (1, [(r[1], r[2], 1, 0)])
            return go(r[1], r[2])
        b = _expr_bounds(e, node)
        if b is not None and b[0] == b[1]:
            return (b[0], [])
        if (
            isinstance(e, Special)
            and e.form in (SpecialForm.CAST, SpecialForm.TRY_CAST)
            and len(e.args) == 1
        ):
            st, dt = e.args[0].dtype, e.dtype
            s_in = st.scale if st.kind == TypeKind.DECIMAL else 0
            s_out = dt.scale if dt.kind == TypeKind.DECIMAL else 0
            d = s_out - s_in
            if d < 0:
                return None
            inner = go(e.args[0], node)
            if inner is None:
                return None
            return (inner[0] * 10**d, inner[1])
        if isinstance(e, Call):
            if e.name == "multiply" and len(e.args) == 2:
                a = go(e.args[0], node)
                b2 = go(e.args[1], node)
                if a is None or b2 is None:
                    return None
                return (a[0] * b2[0], a[1] + b2[1])
            if e.name == "negate" and len(e.args) == 1:
                a = go(e.args[0], node)
                if a is None:
                    return None
                return (-a[0], a[1])
            if e.name in ("plus", "minus") and len(e.args) == 2:
                if e.args[0].dtype != e.args[1].dtype:
                    return None  # un-aligned decimal scales
                a = go(e.args[0], node)
                b2 = go(e.args[1], node)
                if a is None or b2 is None:
                    return None
                sgn = -1 if e.name == "minus" else 1
                # affine fold: const +- (c * single factor)
                if not a[1] and len(b2[1]) == 1 and b2[0] != 0:
                    sn, cn, s, o = b2[1][0]
                    c = sgn * b2[0]
                    return (1, [(sn, cn, c * s, c * o + a[0])])
                if not b2[1] and len(a[1]) == 1 and a[0] != 0:
                    sn, cn, s, o = a[1][0]
                    return (1, [(sn, cn, a[0] * s, a[0] * o + sgn * b2[0])])
                if not a[1] and not b2[1]:
                    return (a[0] + sgn * b2[0], [])
                return None
        return None

    r = field(name, src)
    if r is None:
        return None
    if r[0] == "scan":
        return (1, [(r[1], r[2], 1, 0)])
    return go(r[1], r[2])


def resolve_column_nullable(node: PlanNode, name: str) -> bool:
    """May this column hold NULLs?  Conservative (True when unsure) — feeds
    null-aware grouping (SQL: NULL keys form ONE group; reference:
    velox/exec/VectorHasher.h null value-id handling).  The cost of a false
    positive is one spare code in the packed sort key, so precision matters
    mainly for array-mode radix budgets."""
    from ..plan.nodes import ArrowStreamNode

    if isinstance(node, (TableScanNode, ValuesNode, ArrowStreamNode)):
        v = node.table.validities.get(name)
        return v is not None and not bool(np.asarray(v).all())
    if isinstance(node, ProjectNode):
        expr = node.exprs[node.names.index(name)]
        if isinstance(expr, FieldAccess):
            return resolve_column_nullable(node.source, expr.name)
        from ..expr.ir import Constant

        if isinstance(expr, Constant):
            return expr.value is None
        return True
    if isinstance(node, (FilterNode, LimitNode, TopNNode, OrderByNode)):
        return resolve_column_nullable(node.sources[0], name)
    if isinstance(node, HashJoinNode):
        from ..plan.nodes import JoinType as _JT

        jt = node.join_type
        if name in node.right.output_schema and name not in node.left.output_schema:
            # build-side column: LEFT/FULL null-extend unmatched probe rows
            if jt in (_JT.LEFT, _JT.FULL):
                return True
            return resolve_column_nullable(node.right, name)
        if name in node.left.output_schema:
            if jt == _JT.FULL:
                return True  # unmatched-build epilogue nulls the probe side
            return resolve_column_nullable(node.left, name)
        return True
    if isinstance(node, AggregationNode):
        if name in node.grouping_keys:
            return resolve_column_nullable(node.sources[0], name)
        return True  # aggregate results (e.g. sum over zero rows) can be null
    if node.sources:
        for s in node.sources:
            if name in s.output_schema:
                return resolve_column_nullable(s, name)
    return True


def _element_strings(node: PlanNode, name: str, child_idx: int):
    """Dictionary of an ARRAY/MAP column's child (for unnested elements)."""
    from ..expr.ir import StringsCall
    from ..plan.nodes import ArrowStreamNode

    if isinstance(node, (TableScanNode, ValuesNode, ArrowStreamNode)):
        seg = node.table.columns.get(name)
        tabs = getattr(seg, "string_tables", None)
        if tabs and child_idx < len(tabs):
            return tabs[child_idx]
        return None
    if isinstance(node, ProjectNode):
        expr = node.exprs[node.names.index(name)]
        if isinstance(expr, StringsCall) and child_idx == 0:
            return expr.strings
        if isinstance(expr, FieldAccess):
            return _element_strings(node.source, expr.name, child_idx)
        return None
    for s in node.sources:
        if name in s.output_schema:
            return _element_strings(s, name, child_idx)
    return None


def _first_string_field(expr: Expr) -> Optional[str]:
    if isinstance(expr, FieldAccess) and expr.dtype.is_string:
        return expr.name
    for c in expr.children:
        hit = _first_string_field(c)
        if hit is not None:
            return hit
    return None


@dataclasses.dataclass
class _Linear:
    """A linearized single-pipeline plan (scan .. optional agg .. finishers)."""

    source: PlanNode  # TableScanNode or ValuesNode
    steps: List[Tuple]  # ('filter', Expr) | ('project', names, exprs, schema)
    agg: Optional[AggregationNode]
    finishers: List[PlanNode]  # OrderBy/TopN/Limit from bottom to top


def _linearize(root: PlanNode) -> _Linear:
    finishers: List[PlanNode] = []
    node = root
    while isinstance(node, (OrderByNode, TopNNode, LimitNode, EnforceSingleRowNode)):
        finishers.append(node)
        node = node.sources[0]
    agg = None
    if isinstance(node, AggregationNode):
        agg = node
        node = node.sources[0]
    from ..plan.nodes import AssignUniqueIdNode, GroupIdNode, UnnestNode

    steps_rev: List[Tuple] = []
    while isinstance(
        node,
        (
            FilterNode,
            ProjectNode,
            HashJoinNode,
            UnnestNode,
            GroupIdNode,
            AssignUniqueIdNode,
        ),
    ):
        if isinstance(node, FilterNode):
            steps_rev.append(("filter", node.predicate))
            node = node.sources[0]
        elif isinstance(node, ProjectNode):
            steps_rev.append(("project", node.names, node.exprs, node.output_schema))
            node = node.sources[0]
        elif isinstance(node, (UnnestNode, GroupIdNode, AssignUniqueIdNode)):
            steps_rev.append(("expand", node))
            node = node.sources[0]
        else:
            from ..plan.nodes import JoinType

            if node.join_type in (JoinType.RIGHT, JoinType.RIGHT_SEMI):
                # lower by swapping sides (reference: the planner flips
                # RIGHT to LEFT with probe/build exchanged)
                flipped = {
                    JoinType.RIGHT: JoinType.LEFT,
                    JoinType.RIGHT_SEMI: JoinType.LEFT_SEMI,
                }[node.join_type]
                node = HashJoinNode(
                    node.right,
                    node.left,
                    flipped,
                    node.right_keys,
                    node.left_keys,
                    node.output_columns,
                    node.filter,
                    id=node.id,
                )
            if node.filter is not None and node.join_type in (
                JoinType.INNER,
                JoinType.LEFT,
            ):
                # an INNER join's non-equi filter is semantically a filter
                # above the join (the reference fuses it in HashProbe; same
                # rows survive either way); a LEFT join's filter nulls the
                # build side of failing matches instead of dropping rows —
                # requires the referenced columns in the join output
                if node.join_type == JoinType.INNER:
                    steps_rev.append(("filter", node.filter))
                else:
                    ls = node.left.output_schema
                    rs = node.right.output_schema
                    build_cols = frozenset(
                        c for c in node.output_columns
                        if c in rs and c not in ls
                    )
                    steps_rev.append(
                        ("left_join_filter", node.filter, build_cols, node)
                    )
                node = HashJoinNode(
                    node.left,
                    node.right,
                    node.join_type,
                    node.left_keys,
                    node.right_keys,
                    node.output_columns,
                    None,
                    id=node.id,
                )
            # probe continues down the left (probe) side; the right (build) side
            # is executed eagerly when the pipeline is instantiated.
            steps_rev.append(("join", node))
            node = node.left
    # Any other node (Aggregation mid-plan, OrderBy under a join, Window, a
    # second join stage, ...) becomes a pipeline *source*: LocalExecutor
    # materializes it recursively (a pipeline barrier — the reference's
    # equivalent is the LocalPlanner splitting the plan into pipelines at
    # multi-source/blocking nodes, velox/exec/LocalPlanner.cpp:139).
    if isinstance(node, TableScanNode) and node.subfield_filter is not None:
        steps_rev.append(("filter", node.subfield_filter))
    steps = list(reversed(steps_rev))
    finishers.reverse()
    return _Linear(node, steps, agg, finishers)


def _pipeline_sort_keys(steps) -> Tuple[str, ...]:
    """Static walk of resolved pipeline steps: column names the final batch is
    key-ordered by (joins emit key-sorted output; projects track renames)."""
    sorted_by: Tuple[str, ...] = ()
    for step in steps:
        if step[0] == "join":
            exec_ = step[1]
            node = exec_.node
            out = set(node.output_columns)
            names = []
            for lk, rk in zip(node.left_keys, node.right_keys):
                if lk in out:
                    names.append(lk)
                elif rk in out:  # right key column carries the same values
                    names.append(rk)
                else:
                    break
            sorted_by = tuple(names)
        elif step[0] == "project":
            _, names, exprs, _schema = step
            mapping = {}
            for n, e in zip(names, exprs):
                if isinstance(e, FieldAccess):
                    mapping.setdefault(e.name, n)
            kept = []
            for k in sorted_by:
                if k in mapping:
                    kept.append(mapping[k])
                else:
                    break
            sorted_by = tuple(kept)
        elif step[0] == "expand":
            sorted_by = ()  # cardinality change invalidates ordering info
        # filters preserve order
    return sorted_by


# ---------------------------------------------------------------------------
# Streaming operator application (trace-time)


def _apply_steps(batch: Batch, steps: Sequence[Tuple]):
    """jit-friendly wrapper: steps bound via functools.partial (hashable)."""
    return apply_streaming(batch, steps)


def apply_streaming(batch: Batch, steps: Sequence[Tuple]):
    """Apply filter/project steps; returns (batch, error_count_on_live_rows)."""
    err = jnp.zeros((), dtype=jnp.int64)
    for step in steps:
        active = batch.active_mask()
        if step[0] == "filter":
            [r] = ExprSet([step[1]]).eval(batch)
            if r.errors is not None:
                err = err + jnp.sum((r.errors & active).astype(jnp.int64))
            keep = r.values.astype(jnp.bool_)
            if r.validity is not None:
                keep = keep & r.validity
            batch = batch.with_selection(keep)
        elif step[0] == "join":
            batch = step[1].probe(batch)
        elif step[0] == "left_join_filter":
            # LEFT join non-equi condition: matched rows failing the filter
            # become UNMATCHED — probe rows stay, build-side columns null out
            # (reference: HashProbe::applyFilter null-ing misses on LEFT).
            # Unmatched rows evaluate the filter over nulls -> Kleene null ->
            # already-null build columns stay null.
            expr, build_cols = step[1], step[2]
            [r] = ExprSet([expr]).eval(batch)
            if r.errors is not None:
                err = err + jnp.sum((r.errors & active).astype(jnp.int64))
            passed = r.values.astype(jnp.bool_)
            if r.validity is not None:
                passed = passed & r.validity
            new_cols = []
            for name, col in zip(batch.schema.names, batch.columns):
                if name in build_cols:
                    fc = col.flatten(batch.capacity)
                    v = (
                        passed
                        if fc.validity is None
                        else (fc.validity & passed)
                    )
                    col = Column.flat(fc.data, fc.dtype, v, fc.strings)
                new_cols.append(col)
            batch = dataclasses.replace(batch, columns=tuple(new_cols))
        elif step[0] == "expand":
            from ..plan.nodes import AssignUniqueIdNode, GroupIdNode, UnnestNode
            from .expand import (
                apply_assign_unique_id,
                apply_groupid,
                apply_unnest,
            )

            node = step[1]
            if isinstance(node, UnnestNode):
                batch = apply_unnest(batch, node)
            elif isinstance(node, GroupIdNode):
                batch = apply_groupid(batch, node)
            else:
                batch = apply_assign_unique_id(batch, node)
        else:
            _, names, exprs, schema = step
            cols, errors = ExprSet(list(exprs)).eval_to_columns(batch)
            if errors is not None:
                err = err + jnp.sum((errors & active).astype(jnp.int64))
            batch = batch.with_columns(schema, cols)
    return batch, err


# ---------------------------------------------------------------------------
# Aggregation executors


class AggExecutor:
    """Executes one AggregationNode over a stream of tiles."""

    def __init__(
        self,
        node: AggregationNode,
        capacity: int,
        presorted: bool = False,
        max_rows: Optional[int] = None,
    ):
        """``max_rows``: a proven upper bound on TOTAL input rows across all
        tiles (None = unbounded; e.g. expansion joins upstream) — gates the
        narrow-sum rebinding below."""
        self.node = node
        self.capacity = capacity
        self.presorted = presorted
        in_schema = node.source.output_schema
        self.aggs: List[BoundAggregate] = []
        self.arg_names: List[List[str]] = []
        # per agg, per arg: optional code->rank gather (string ordering); plus
        # per agg: the output StringTable and the rank->code inverse, if any
        self.arg_transforms: List[List[Optional[np.ndarray]]] = []
        self.out_strings: List[Optional[StringTable]] = []
        self.out_inverse: List[Optional[np.ndarray]] = []
        for call in node.aggregates:
            names: List[str] = []
            dtypes = []
            for arg in call.args:
                assert isinstance(arg, FieldAccess), "agg args must be fields"
                names.append(arg.name)
                dtypes.append(arg.dtype)
            bound = bind_aggregate(call.name, tuple(dtypes) or None, None)
            transforms: List[Optional[np.ndarray]] = [None] * len(names)
            out_tab = out_inv = None
            for j, (dt, role) in enumerate(zip(dtypes, bound.arg_roles)):
                if not dt.is_string:
                    continue
                tab = resolve_column_strings(node.source, names[j])
                if tab is None:
                    raise TypeError(
                        f"{call.name}({names[j]}): VARCHAR argument has no "
                        "resolvable dictionary"
                    )
                if role == "plain":
                    raise TypeError(f"{call.name} does not accept VARCHAR")
                if "order" in role:
                    # accumulate lexicographic ranks, not insertion codes
                    ranks = np.asarray(tab.sort_permutation(), np.int32)
                    transforms[j] = ranks
                    if "value" in role:
                        inv = np.empty(len(ranks), dtype=np.int64)
                        inv[ranks] = np.arange(len(ranks), dtype=np.int64)
                        out_tab, out_inv = tab, inv
                else:  # pure 'value': codes pass through untouched
                    if j == 0:
                        out_tab = tab
            self.aggs.append(bound)
            self.arg_names.append(names)
            self.arg_transforms.append(transforms)
            self.out_strings.append(out_tab)
            self.out_inverse.append(out_inv)

        # Narrow-sum rebinding: a wide (96-bit limb) integer sum whose input
        # bounds prove |sum| < 2^62 over this capacity drops to a single
        # int64 accumulator — one accumulator array instead of three per sum
        # (Q1-class aggregations are accumulator-count-bound on device).
        # Reference analog: DecimalAggregate's overflow-tracking is likewise
        # skipped when the type's range proves it dead
        # (velox/functions/prestosql/aggregates/DecimalAggregate.h).
        from .aggregates import narrow_int_avg, narrow_int_sum

        for i, (agg, names) in enumerate(zip(self.aggs, self.arg_names)):
            if (
                max_rows is not None
                and getattr(agg, "name", "") in ("sum", "avg")
                and len(getattr(agg, "acc_dtypes", ())) == 3
                and names
            ):
                b = resolve_column_bounds(node.source, names[0])
                if b is not None:
                    bound_mag = max(abs(b[0]), abs(b[1]))
                    if bound_mag * max(max_rows, 1) <= (1 << 62):
                        if agg.name == "sum":
                            self.aggs[i] = narrow_int_sum(
                                agg.result_type, agg.input_index
                            )
                        else:
                            t0 = in_schema.type_of(names[0])
                            scale = (
                                t0.scale
                                if t0.kind == TypeKind.DECIMAL
                                else 0
                            )
                            self.aggs[i] = narrow_int_avg(
                                scale, agg.input_index
                            )

        self.key_infos: List[KeyInfo] = [
            key_info(
                k,
                in_schema.type_of(k),
                resolve_column_strings(node.source, k),
                resolve_column_bounds(node.source, k),
                nullable=resolve_column_nullable(node.source, k),
            )
            for k in node.grouping_keys
        ]
        self.n_output_keys = len(self.key_infos)
        any_nullable = any(k.nullable for k in self.key_infos)
        if any_nullable:
            # presorted grouping relies on upstream key order, which does not
            # place NULL keys adjacently in general — fall back to the sort
            presorted = False
        from .collect_agg import CollectAggregate

        if any(isinstance(a, CollectAggregate) for a in self.aggs):
            # list-valued accumulators: rows are collected key-sorted and
            # groups assembled host-side (exec/collect_agg.py)
            self.mode = "collect_rows"
            self.num_groups = 0
            self.grouping = None
        elif not self.key_infos:
            self.mode = "ungrouped"
            self.num_groups = 1
            self.grouping = None
        elif all(k.radix is not None for k in self.key_infos) and _radix_product(
            self.key_infos
        ) <= MAX_ARRAY_GROUPS:
            self.mode = "array"
            self.grouping = ArrayGrouping(self.key_infos)
            self.num_groups = self.grouping.num_groups
        else:
            self.mode = "sort"
            self.grouping = SortGrouping(self.key_infos, presorted)
            if any_nullable and self.grouping.pack_plan(capacity) is None:
                # unbounded nullable keys: NULL-group identity rides a
                # synthetic null-bitmask key (one extra sort operand / carry
                # column); every downstream stage (carry merge, spill,
                # exchange, host merge) treats it as an ordinary key
                from ..dtypes import BIGINT

                nullable_names = tuple(
                    k.name for k in self.key_infos if k.nullable
                )
                self.key_infos.append(
                    KeyInfo(
                        "__nullbits__", BIGINT, None, None,
                        (0, (1 << len(nullable_names)) - 1),
                        nullable=False,
                        null_sources=nullable_names,
                    )
                )
                self.grouping = SortGrouping(self.key_infos, presorted)
            self.num_groups = capacity

    # ---- direct modes (ungrouped / array): carried accumulators ----------
    def init_carry(self):
        accs = tuple(agg.acc_init(self.num_groups) for agg in self.aggs)
        rowcounts = jnp.zeros((self.num_groups,), dtype=jnp.int64)
        return (accs, rowcounts)

    def _decode_args(self, batch: Batch, i: int):
        """Decode + transform aggregate i's argument columns.

        Returns (values tuple, per-row validity mask or None)."""
        values: List[jax.Array] = []
        validity = None
        for j, name in enumerate(self.arg_names[i]):
            v, val = batch.column(name).decode(batch.capacity)
            tr = self.arg_transforms[i][j]
            if tr is not None:
                v = jnp.take(jnp.asarray(tr), v.astype(jnp.int32), mode="clip")
            values.append(v)
            if val is not None:
                validity = val if validity is None else (validity & val)
        return tuple(values), validity

    # ---- int32 piece-sum fast path (ops/piece_sum.py) --------------------
    def try_enable_piece_path(self) -> bool:
        """Lower ALL accumulator updates onto the exact int32 grouped
        piece-sum path when every aggregate is a (narrow) sum/avg/count over
        a product of affine transforms of non-nullable scan columns with
        int32-provable bounds (resolve_affine_product).

        The default update widens inputs to int64 and pays ~G x A int64
        select/add ops per element; the piece path keeps all per-element
        arithmetic int32 over the raw bounds-narrowed device columns.  It
        was written for the engine's first target, whose int64 arithmetic
        was emulated; whether it wins on a GPU is not measured yet.
        Reference analog: single-pass accumulator updates over group
        pointers, velox/exec/GroupingSet.cpp:294."""
        import os

        if os.environ.get("VELOX_TPU_PIECE_AGG", "1") == "0":
            return False
        if self.mode not in ("array", "ungrouped"):
            return False
        if self.num_groups > 64 or self.capacity % 512:
            return False
        from ..ops.piece_sum import Factor, plan_spec

        node = self.node
        col_names: List[str] = []
        scan_id = [None]

        def col_index(scan_node, cn) -> Optional[int]:
            if scan_id[0] is None:
                scan_id[0] = id(scan_node)
            elif scan_id[0] != id(scan_node):
                return None  # factors must share one scan
            v = scan_node.table.validities.get(cn)
            if v is not None and not bool(np.asarray(v).all()):
                return None  # nullable input: counts would diverge
            if cn not in col_names:
                col_names.append(cn)
            return col_names.index(cn)

        spec_keys: List[tuple] = []
        spec_factors: List[list] = []

        def spec_of(factors) -> int:
            key = tuple((f.col, f.scale, f.offset) for f in factors)
            if key in spec_keys:
                return spec_keys.index(key)
            spec_keys.append(key)
            spec_factors.append(list(factors))
            return len(spec_keys) - 1

        count_idx = spec_of(())  # live-row count rides spec 0
        slot_map: List[List[int]] = []
        for i, agg in enumerate(self.aggs):
            if agg.pairs or agg.post_combine:
                return False
            if any(t is not None for t in self.arg_transforms[i]):
                return False
            if agg.name == "count" and not self.arg_names[i]:
                slot_map.append([count_idx])
                continue
            if (
                agg.name in ("sum", "avg", "count")
                and tuple(agg.acc_ops) in (("sum", "sum"), ("sum",))
                and all(dt == jnp.int64 for dt in agg.acc_dtypes)
                and len(self.arg_names[i]) == 1
            ):
                ap = resolve_affine_product(node.source, self.arg_names[i][0])
                if ap is None:
                    return False
                const, raw_factors = ap
                if not raw_factors or const == 0:
                    return False
                factors = []
                for j, (sn, cn, s, o) in enumerate(raw_factors):
                    if j == 0:
                        s, o = s * const, o * const
                    b = sn.table.column_bounds(cn)
                    if b is None or b[0] < -(1 << 31) or b[1] >= 1 << 31:
                        return False
                    ci = col_index(sn, cn)
                    if ci is None:
                        return False
                    lo = min(s * b[0] + o, s * b[1] + o)
                    hi = max(s * b[0] + o, s * b[1] + o)
                    factors.append(Factor(ci, s, o, lo, hi))
                if agg.name == "count":
                    # count(x) over proven non-null x == live-row count
                    slot_map.append([count_idx])
                    continue
                vi = spec_of(factors)
                slot_map.append([vi, count_idx])
                continue
            return False
        plans = tuple(plan_spec(f) for f in spec_factors)
        if any(p is None for p in plans):
            return False
        # cost gate: with few groups x accumulators the int64 update is
        # memory-bound already and the piece form only adds work (on the
        # first target it was slower for Q6, faster for Q1; not measured on
        # a GPU)
        total_slots = 1 + sum(len(s) for s in slot_map)
        if self.num_groups * total_slots < 16:
            return False
        self._piece_plan = (tuple(col_names), plans, slot_map, count_idx)
        return True

    def _piece_update(self, carry, scan_batch: Batch, mask, gids):
        from ..ops.piece_sum import grouped_piece_sums_xla
        from ..vector.column import Encoding as _Enc

        col_names, plans, slot_map, count_idx = self._piece_plan
        cols = []
        for nm in col_names:
            c = scan_batch.column(nm)
            if c.encoding != _Enc.FLAT or c.validity is not None:
                return None
            if not jnp.issubdtype(c.data.dtype, jnp.integer):
                return None
            cols.append(c.data)
        accs, rowcounts = carry
        small = self.num_groups <= 127
        gid_live = jnp.where(mask, gids, -1).astype(
            jnp.int8 if small else jnp.int32
        )
        outs = grouped_piece_sums_xla(
            tuple(cols), gid_live, plans, self.num_groups
        )
        rowcounts = rowcounts + outs[count_idx]
        new_accs = []
        for agg, acc, slots in zip(self.aggs, accs, slot_map):
            news = tuple(outs[s] for s in slots)
            new_accs.append(agg._combine_states(acc, news))
        return (tuple(new_accs), rowcounts)

    def update_carry(self, carry, batch: Batch, scan_batch: Optional[Batch] = None):
        """One tile's update of the direct-mode accumulators.

        EVERY plain (non-pair) accumulator reduction across all aggregates
        — plus the row counts — batches into ONE variadic reduce
        (ops/segmented.direct_group_reduce_batch), so each input column
        streams from HBM once per tile instead of once per accumulator.
        Lexicographic pairs (min_by/max_by) and exotic combine ops keep the
        per-aggregate path.  When the scan tile rides along row-aligned
        (filter/project-only pipelines) and try_enable_piece_path() proved
        an exact int32 lowering, the whole update runs as one grouped
        piece-sum over the raw narrow columns instead."""
        import os

        from ..ops.segmented import direct_group_reduce_batch

        accs, rowcounts = carry
        mask = batch.active_mask()
        if self.mode == "array":
            gids = self.grouping.group_ids(batch)
        else:
            gids = jnp.zeros((batch.capacity,), dtype=jnp.int32)
        if getattr(self, "_piece_plan", None) is not None and scan_batch is not None:
            res = self._piece_update(carry, scan_batch, mask, gids)
            if res is not None:
                return res

        if self.mode == "array" and self.num_groups <= 256:
            # materialize the composite group id ONCE as int8/int32: every
            # accumulator pass then re-reads 1-4 B/row instead of
            # recomputing it from the key columns' dictionary codes
            # (4 B per key per pass)
            small = self.num_groups <= 127
            gids = jax.lax.optimization_barrier(
                gids.astype(jnp.int8) if small else gids
            ).astype(jnp.int32)
        # Two update forms: the batched variadic reduce runs the whole
        # update in ONE pass but routes every element to every group; the
        # per-accumulator loop makes one memory-bound pass per accumulator
        # (identical count reductions CSE into one).  The per-accumulator
        # loop won on the first target and is the default; not measured on
        # a GPU.
        if os.environ.get("VELOX_TPU_BATCH_REDUCE", "0") == "0":
            return self._update_carry_per_acc(accs, rowcounts, batch, mask, gids)
        _BATCHABLE = ("sum", "min", "max", "band", "bor")
        items = [(mask.astype(jnp.int64), "sum")]  # rowcounts ride first
        slots: List[Tuple[int, int]] = []  # (agg idx, acc idx) per item
        deferred: List[int] = []
        masked_arrays: Dict[int, list] = {}
        for i, agg in enumerate(self.aggs):
            values, validity = self._decode_args(batch, i)
            m = mask if validity is None else (mask & validity)
            paired = agg._paired_payloads() | {
                y for y, _, _ in agg.pairs
            }
            if paired or any(op not in _BATCHABLE for op in agg.acc_ops):
                deferred.append(i)
                masked_arrays[i] = (values, m)
                continue
            arrays = agg._masked(agg.raw_inputs(values, m), m)
            masked_arrays[i] = None
            for j, (arr, op) in enumerate(zip(arrays, agg.acc_ops)):
                slots.append((i, j))
                items.append((arr, op))

        outs = direct_group_reduce_batch(items, mask, gids, self.num_groups)
        rowcounts = rowcounts + outs[0]
        news: Dict[int, list] = {
            i: [None] * len(self.aggs[i].acc_ops)
            for i, _ in slots
        }
        for (i, j), arr in zip(slots, outs[1:]):
            news[i][j] = arr
        out = []
        for i, (agg, acc) in enumerate(zip(self.aggs, accs)):
            if i in news:
                out.append(agg._combine_states(acc, tuple(news[i])))
            else:
                values, m = masked_arrays[i]
                out.append(
                    agg.update(acc, values, m, gids, self.num_groups)
                )
        return (tuple(out), rowcounts)

    def _update_carry_per_acc(self, accs, rowcounts, batch, mask, gids):
        """Legacy per-aggregate update (A/B toggle VELOX_TPU_BATCH_REDUCE=0)."""
        from ..ops.segmented import direct_group_reduce, masked_reduce

        out = []
        for i, (agg, acc) in enumerate(zip(self.aggs, accs)):
            values, validity = self._decode_args(batch, i)
            m = mask if validity is None else (mask & validity)
            out.append(agg.update(acc, values, m, gids, self.num_groups))
        ones = mask.astype(jnp.int64)
        if self.num_groups == 1:
            rowcounts = rowcounts + masked_reduce(ones, mask, "sum").reshape(1)
        else:
            rowcounts = rowcounts + direct_group_reduce(
                ones, mask, gids, self.num_groups, "sum"
            )
        return (tuple(out), rowcounts)

    # ---- sort mode: per-tile partial groups -------------------------------
    def _payload_and_plan(self, batch: Batch):
        payload: List[jax.Array] = []
        plan: List[Tuple[int, bool]] = []  # per agg: (n_args, has_validity)
        for i in range(len(self.aggs)):
            values, validity = self._decode_args(batch, i)
            payload.extend(values)
            if validity is not None:
                payload.append(validity)
            plan.append((len(values), validity is not None))
        return payload, plan

    def _reduce_sorted(self, plan, sorted_keys, sorted_payload, sorted_mask, runs):
        accs_out = []
        pos = 0
        for (n_args, has_validity), agg in zip(plan, self.aggs):
            values = tuple(sorted_payload[pos : pos + n_args])
            pos += n_args
            m = sorted_mask
            if has_validity:
                m = m & sorted_payload[pos].astype(jnp.bool_)
                pos += 1
            accs_out.append(agg.run_reduce(values, m, runs))
        key_arrays = SortGrouping.group_keys(sorted_keys, runs)
        return key_arrays, tuple(accs_out), runs.num_runs

    def tile_partial(self, batch: Batch):
        """Returns (key_arrays, accs_nested, num_groups_scalar)."""
        mask = batch.active_mask()
        payload, plan = self._payload_and_plan(batch)
        (
            sorted_keys,
            sorted_payload,
            sorted_mask,
            runs,
        ) = self.grouping.sort_and_group(batch, payload, mask)
        return self._reduce_sorted(
            plan, sorted_keys, sorted_payload, sorted_mask, runs
        )

    # ---- split-dispatch halves (ops/shared_sort.py): the grouping sort runs
    # as a canonical shared program between these two glue programs, so the
    # per-query program contains no lax.sort (compile cost; see
    # config.split_sort_programs)

    def tile_partial_pre(self, batch: Batch):
        mask = batch.active_mask()
        payload, plan = self._payload_and_plan(batch)
        # static layout, read back by tile_partial_post (pre traces first)
        self._split_agg_plan = (plan, len(payload))
        merged, carried = self.grouping.sort_inputs(batch, payload, mask)
        return merged, tuple(carried)

    def tile_partial_boundary(self, s_merged, s_carried):
        """Middle glue: boundaries, the run-end compaction word, AND the
        ride operands for the end-position canonical sort — the sorted key
        word itself plus every sum-class accumulator's prefix sum.  Riding
        them through the sort delivers per-run values already compacted at
        the run ends, which removes the full-capacity gathers from the post
        program (on the first target a random 8M-row gather cost far more
        than an extra sort operand; not measured on a GPU)."""
        from ..ops.shared_sort import _BUCKETS

        plan, n_payload = self._split_agg_plan
        mask = s_carried[-1].astype(jnp.bool_)
        boundary, endword = self.grouping.sorted_boundary(
            s_merged, s_carried[-1]
        )
        rides: List[jax.Array] = [s_merged]
        layout: List[Tuple[int, int]] = []  # (agg index, acc index)
        budget = _BUCKETS[-1] - 1
        pos = 0
        for ai, ((n_args, has_validity), agg) in enumerate(
            zip(plan, self.aggs)
        ):
            values = tuple(s_carried[pos : pos + n_args])
            pos += n_args
            m = mask
            if has_validity:
                m = m & s_carried[pos].astype(jnp.bool_)
                pos += 1
            paired = agg._paired_payloads() | {
                y for y, _, _ in agg.pairs
            }
            if not any(
                op == "sum" and i not in paired
                for i, op in enumerate(agg.acc_ops)
            ):
                continue
            arrays = agg._masked(agg.raw_inputs(values, m), m)
            for i, op in enumerate(agg.acc_ops):
                if op != "sum" or i in paired or len(layout) >= budget:
                    continue
                rides.append(
                    jnp.cumsum(arrays[i].astype(agg.acc_dtypes[i]))
                )
                layout.append((ai, i))
        self._split_ride_layout = tuple(layout)
        return boundary, endword, tuple(rides)

    def tile_partial_post(
        self, s_merged, s_carried, boundary, s_endword, s_rides
    ):
        plan, n_payload = self._split_agg_plan
        cap = s_merged.shape[0]
        idxb = max((cap - 1).bit_length(), 1)
        end_positions = (
            s_endword & ((jnp.int64(1) << idxb) - 1)
        ).astype(jnp.int32)
        (
            sorted_keys,
            sorted_payload,
            sorted_mask,
            runs,
        ) = self.grouping.group_from_sorted(
            s_merged,
            list(s_carried),
            n_payload,
            boundary=boundary,
            end_positions=end_positions,
        )
        ride_layout = self._split_ride_layout
        word_ends = s_rides[0]
        ride_ends = {
            key: s_rides[1 + j] for j, key in enumerate(ride_layout)
        }

        def ride_diff(at_ends):
            prev = jnp.concatenate(
                [jnp.zeros((1,), at_ends.dtype), at_ends[:-1]]
            )
            return at_ends - prev

        # keys: unpack from the ridden word at run ends — no gathers
        key_arrays = self.grouping.keys_from_word(word_ends)
        accs_out = []
        pos = 0
        for ai, ((n_args, has_validity), agg) in enumerate(
            zip(plan, self.aggs)
        ):
            values = tuple(sorted_payload[pos : pos + n_args])
            pos += n_args
            m = sorted_mask
            if has_validity:
                m = m & sorted_payload[pos].astype(jnp.bool_)
                pos += 1
            ridden = {
                i for (aj, i) in ride_layout if aj == ai
            }
            if len(ridden) == len(agg.acc_ops):
                accs_out.append(
                    tuple(
                        ride_diff(ride_ends[(ai, i)])
                        for i in range(len(agg.acc_ops))
                    )
                )
                continue
            full = agg.run_reduce(values, m, runs)
            accs_out.append(
                tuple(
                    ride_diff(ride_ends[(ai, i)]) if i in ridden else full[i]
                    for i in range(len(agg.acc_ops))
                )
            )
        return key_arrays, tuple(accs_out), runs.num_runs

    # ---- device-resident sorted-carry merge for sort mode ------------------
    #
    # Carry = (key arrays [G], acc arrays [G] per aggregate, live-group count).
    # Each tile's partial groups (sorted runs) are merged into the carry with
    # one multi-operand sort over [G + capacity] rows + segment reductions —
    # all on device, so the host fetches nothing until extraction.  This is
    # the streaming analog of the reference's partial->final aggregation
    # (velox/exec/GroupingSet.cpp), re-shaped for a device with fast sorts and
    # a high-latency host link.

    def init_sorted_carry(self, G: Optional[int] = None):
        G = G or self.capacity
        keys = tuple(
            jnp.zeros((G,), dtype=info.dtype.device_dtype)
            for info in self.key_infos
        )
        accs = tuple(agg.acc_init(G) for agg in self.aggs)
        count = jnp.zeros((), dtype=jnp.int32)
        overflow = jnp.zeros((), dtype=jnp.int32)
        return (keys, accs, count, overflow)

    def merge_sorted_carry(self, carry, batch: Batch):
        return self.merge_partial_into_carry(carry, self.tile_partial(batch))

    def merge_partial_into_carry(self, carry, partial):
        """Merge one partial-groups tuple into the carry.  The partial's third
        element is either a run-count scalar (slots [0, n) valid) or an
        explicit boolean validity mask (exchange-received groups are scattered
        across per-source bucket prefixes)."""
        from ..ops.segmented import SortedRuns

        keys_c, accs_c, count, overflow = carry
        tile_keys, tile_accs, liveness = partial
        G = keys_c[0].shape[0]
        cap = tile_keys[0].shape[0]
        idx_g = jnp.arange(G, dtype=jnp.int32)
        idx_t = jnp.arange(cap, dtype=jnp.int32)
        if getattr(liveness, "ndim", 0) == 0:
            # a partial shrunk to fewer slots than it has runs lost groups
            overflow = overflow + (liveness > cap).astype(jnp.int32)
            tile_valid = idx_t < liveness
        else:
            tile_valid = liveness
        valid = jnp.concatenate([idx_g < count, tile_valid])
        keys_all = [
            jnp.concatenate([kc, tk.astype(kc.dtype)])
            for kc, tk in zip(keys_c, tile_keys)
        ]
        flat_accs: List[jax.Array] = []
        for acc_c, acc_t in zip(accs_c, tile_accs):
            for a_c, a_t in zip(acc_c, acc_t):
                flat_accs.append(jnp.concatenate([a_c, a_t.astype(a_c.dtype)]))
        # Sort (liveness, keys) with the accumulators riding as non-key sort
        # OPERANDS instead of gathering them through the permutation (the
        # cheaper form on the first target; not measured on a GPU).  With
        # resolvable key bounds the key tuple packs into ONE int64 operand
        # (ops/sortkey.py).
        n = G + cap
        carried = flat_accs + [valid]
        plan = (
            self.grouping.pack_plan(n)
            if isinstance(self.grouping, SortGrouping)
            else None
        )
        if plan is not None:
            idx64 = jnp.arange(n, dtype=jnp.int64)
            packed = plan.pack_with_sentinel(keys_all, ~valid)
            merged = packed | idx64
            out = jax.lax.sort([merged] + carried, num_keys=1)
            s = out[0]
            low = plan.shifts[-1] if plan.shifts else 0
            codes = s >> low
            keys_s = [
                plan.unpack(s, i).astype(kv.dtype)
                for i, kv in enumerate(keys_all)
            ]
            accs_s = list(out[1 : 1 + len(flat_accs)])
            valid_s = out[-1]
            from ..ops.segmented import run_boundaries

            diff = codes != jnp.roll(codes, 1)
            boundary = run_boundaries(diff, valid_s)
            runs = SortedRuns(boundary, valid_s)
            new_keys = tuple(runs.first(kv)[:G] for kv in keys_s)
            new_accs = []
            i = 0
            for agg in self.aggs:
                k = len(agg.acc_ops)
                merged = agg.merge_runs(accs_s[i : i + k], valid_s, runs)
                i += k
                new_accs.append(tuple(m[:G] for m in merged))
            new_count = jnp.minimum(runs.num_runs, G).astype(jnp.int32)
            overflow = overflow + (runs.num_runs > G).astype(jnp.int32)
            return (new_keys, tuple(new_accs), new_count, overflow)
        # float keys merge on their order-preserving integer code (one NaN
        # group, -0.0 with +0.0), as SortGrouping groups them
        from ..ops.f64bits import f64_to_ordered, ordered_to_f64

        floats = {
            i: kv.dtype
            for i, kv in enumerate(keys_all)
            if jnp.issubdtype(kv.dtype, jnp.floating)
        }
        keys_all = [
            f64_to_ordered(kv) if i in floats else kv
            for i, kv in enumerate(keys_all)
        ]
        sorted_ops = jax.lax.sort(
            [~valid] + keys_all + carried, num_keys=1 + len(keys_all)
        )
        keys_s = [
            ordered_to_f64(kv, floats[i]) if i in floats else kv
            for i, kv in enumerate(sorted_ops[1 : 1 + len(keys_all)])
        ]
        accs_s = list(sorted_ops[1 + len(keys_all) : -1])
        valid_s = sorted_ops[-1]
        from ..ops.segmented import run_boundaries

        diff = jnp.zeros((n,), dtype=jnp.bool_)
        for kv in keys_s:
            diff = diff | (kv != jnp.roll(kv, 1))
        boundary = run_boundaries(diff, valid_s)
        runs = SortedRuns(boundary, valid_s)
        new_keys = tuple(runs.first(kv)[:G] for kv in keys_s)
        new_accs = []
        i = 0
        for agg in self.aggs:
            k = len(agg.acc_ops)
            merged = agg.merge_runs(accs_s[i : i + k], valid_s, runs)
            i += k
            new_accs.append(tuple(m[:G] for m in merged))
        new_count = jnp.minimum(runs.num_runs, G).astype(jnp.int32)
        overflow = overflow + (runs.num_runs > G).astype(jnp.int32)
        return (new_keys, tuple(new_accs), new_count, overflow)

    # ---- host-exact final merge for sort mode -----------------------------
    def merge_partials_host(self, key_chunks, acc_chunks):
        """key_chunks: list over tiles of list-per-key np arrays;
        acc_chunks: list over tiles of nested accs as np arrays."""
        keys = [np.concatenate([kc[i] for kc in key_chunks]) for i in range(len(self.key_infos))]
        accs = []
        for ai, agg in enumerate(self.aggs):
            accs.append(
                tuple(
                    np.concatenate([ac[ai][j] for ac in acc_chunks])
                    for j in range(len(agg.acc_dtypes))
                )
            )
        from ..ops.f64bits import np_f64_to_ordered

        # float keys compare by their integer code: one NaN group, -0.0 == 0.0
        codes = [
            np_f64_to_ordered(k) if k.dtype.kind == "f" else k for k in keys
        ]
        order = np.lexsort(tuple(reversed(codes)))
        keys = [k[order] for k in keys]
        codes = [c[order] for c in codes]
        accs = [tuple(a[order] for a in acc) for acc in accs]
        n = len(keys[0])
        if n == 0:
            starts = np.zeros(0, dtype=np.int64)
        else:
            diff = np.zeros(n, dtype=bool)
            diff[0] = True
            for k in codes:
                diff[1:] |= k[1:] != k[:-1]
            starts = np.flatnonzero(diff)
        group_keys = [k[starts] for k in keys]
        merged = [
            agg.host_merge_sorted(list(acc), starts)
            for agg, acc in zip(self.aggs, accs)
        ]
        return group_keys, merged

    # ---- spill format for sort-mode partials -------------------------------
    def _partial_schema(self) -> RowType:
        names, types = [], []
        for i, k in enumerate(self.key_infos):
            names.append(f"k{i}")
            types.append(k.dtype)
        from ..dtypes import BIGINT, DOUBLE

        for ai, agg in enumerate(self.aggs):
            for j, dt in enumerate(agg.acc_dtypes):
                names.append(f"a{ai}_{j}")
                types.append(DOUBLE if jnp.issubdtype(dt, jnp.floating) else BIGINT)
        return RowType(names, types)

    def partials_to_table(self, key_chunks, acc_chunks) -> Table:
        """Pack collected partial-group chunks into one host Table (spill unit)."""
        schema = self._partial_schema()
        cols: Dict[str, np.ndarray] = {}
        for i in range(len(self.key_infos)):
            cols[f"k{i}"] = np.concatenate([kc[i] for kc in key_chunks])
        for ai, agg in enumerate(self.aggs):
            for j in range(len(agg.acc_dtypes)):
                cols[f"a{ai}_{j}"] = np.concatenate(
                    [ac[ai][j] for ac in acc_chunks]
                )
        return Table(schema, cols)

    def table_to_partials(self, table: Table):
        """Inverse of partials_to_table: one (key_chunk, acc_chunk) pair."""
        keys = [table.columns[f"k{i}"] for i in range(len(self.key_infos))]
        accs = []
        for ai, agg in enumerate(self.aggs):
            accs.append(
                tuple(
                    table.columns[f"a{ai}_{j}"]
                    for j in range(len(agg.acc_dtypes))
                )
            )
        return keys, accs

    # ---- extraction -------------------------------------------------------
    def extract(self, key_arrays, accs, rowcounts=None) -> Table:
        node = self.node
        names = list(node.output_schema.names)
        types = list(node.output_schema.types)
        cols: Dict[str, np.ndarray] = {}
        tables: Dict[str, StringTable] = {}
        validities: Dict[str, np.ndarray] = {}
        nkeys = len(node.grouping_keys)
        if self.mode == "array":
            # keep only groups that actually received rows
            live = np.asarray(rowcounts) > 0
            host_keys = self.grouping.key_arrays()
            key_valids = self.grouping.key_validities()
            for info, name, arr, kv in zip(
                self.key_infos, names[:nkeys], host_keys, key_valids
            ):
                cols[name] = arr[live]
                if info.strings is not None:
                    tables[name] = info.strings
                if kv is not None:
                    v = kv[live]
                    if not v.all():
                        validities[name] = v
        else:
            live = None
            # sort mode: NULL groups carry either the packed null VALUE
            # (bounds hi + 1) or a bit in the synthetic __nullbits__ key
            nullbits = None
            if (
                self.key_infos
                and self.key_infos[-1].null_sources is not None
                and key_arrays is not None
                and len(key_arrays) == len(self.key_infos)
            ):
                nullbits = np.asarray(key_arrays[-1]).astype(np.int64)
            nb_sources = (
                list(self.key_infos[-1].null_sources) if nullbits is not None else []
            )
            for info, name, arr in zip(
                self.key_infos, names[:nkeys], key_arrays or []
            ):
                arr = np.asarray(arr)
                valid = None
                if nullbits is not None and info.name in nb_sources:
                    bit = nb_sources.index(info.name)
                    valid = (nullbits >> bit) & 1 == 0
                elif info.nullable and info.bounds is not None:
                    null_v = info.bounds[1] + 1
                    valid = arr.astype(np.int64) != null_v
                if valid is not None and not valid.all():
                    arr = np.where(valid, arr, np.zeros_like(arr))
                    validities[name] = valid
                cols[name] = arr
                if info.strings is not None:
                    tables[name] = info.strings
        for i, (agg, acc, name) in enumerate(zip(self.aggs, accs, names[nkeys:])):
            acc_np = tuple(np.asarray(a) for a in acc)
            if live is not None:
                acc_np = tuple(a[live] for a in acc_np)
            values, validity = agg.extract(acc_np)
            values = np.asarray(values)
            inv = self.out_inverse[i]
            if inv is not None:
                # min/max over VARCHAR accumulated lexicographic ranks
                values = inv[np.clip(values.astype(np.int64), 0, len(inv) - 1)]
            if self.out_strings[i] is not None:
                tables[name] = self.out_strings[i]
            cols[name] = values
            if validity is not None:
                validity = np.asarray(validity)
                if not validity.all():
                    validities[name] = validity
        return Table(RowType(names, types), cols, tables, validities)


def _col_len(c) -> int:
    return len(c)


def _np_classic_agg(agg, ex, i, cols, vals, order, starts, gids, num_groups):
    """Classic aggregates alongside collect aggregates, computed host-side on
    the group-sorted rows (count/sum/min/max/avg/arbitrary/count_if)."""
    names = ex.arg_names[i]
    n = len(gids)
    mask = np.ones(n, dtype=bool)
    values = []
    for j, nm in enumerate(names):
        v = np.asarray(cols[nm])[order]
        tr = ex.arg_transforms[i][j]
        if tr is not None:
            v = tr[np.clip(v.astype(np.int64), 0, len(tr) - 1)]
        val = vals.get(nm)
        if val is not None:
            mask &= val[order]
        values.append(v)
    counts = np.bincount(gids[mask], minlength=num_groups).astype(np.int64)
    name = agg.name
    if name == "count":
        return (counts if names else np.diff(np.append(starts, n))), None
    if name == "count_if":
        v = np.where(mask, values[0].astype(np.int64), 0)
        return np.add.reduceat(v, starts) if len(starts) else v[:0], None
    v = values[0]
    if name in ("sum", "avg"):
        acc = np.where(mask, v.astype(np.float64 if v.dtype.kind == "f" else np.int64), 0)
        sums = np.add.reduceat(acc, starts) if len(starts) else acc[:0]
        if name == "avg":
            dt = ex.node.source.output_schema.type_of(names[0])
            scale = 10.0 ** dt.scale if dt.kind == TypeKind.DECIMAL else 1.0
            return sums / np.maximum(counts, 1) / scale, counts > 0
        return sums, counts > 0
    if name in ("min", "max", "arbitrary"):
        op = np.maximum if name == "max" else np.minimum
        if v.dtype.kind == "f":
            ident = np.inf if name != "max" else -np.inf
        else:
            info = np.iinfo(np.int64)
            ident = info.min if name == "max" else info.max
            v = v.astype(np.int64)
        vm = np.where(mask, v, ident)
        out = op.reduceat(vm, starts) if len(starts) else vm[:0]
        inv = ex.out_inverse[i]
        if inv is not None:
            out = inv[np.clip(out.astype(np.int64), 0, len(inv) - 1)]
        return out, counts > 0
    raise NotImplementedError(
        f"{name} cannot be combined with collect aggregates in one "
        "aggregation yet; split the aggregation into two nodes"
    )


def _radix_product(infos: Sequence[KeyInfo]) -> int:
    p = 1
    for k in infos:
        p *= k.radix + (1 if k.nullable else 0)  # +1 id for the NULL group
    return p


# ---------------------------------------------------------------------------
# Finishers (OrderBy / TopN / Limit) — applied to small host-side results


def _sort_indices(table: Table, keys: Sequence[SortKey]) -> np.ndarray:
    arrays = []
    for key in reversed(keys):
        arr = table.columns[key.name]
        if key.name in table.string_tables:
            ranks = table.string_tables[key.name].sort_permutation()
            arr = ranks[arr]
        arr = np.asarray(arr)
        if not key.ascending:
            if arr.dtype.kind in "iu":
                arr = -arr.astype(np.int64)
            else:
                arr = -arr
        validity = table.validities.get(key.name)
        if validity is not None and not validity.all():
            # NULL ordering: a flag more significant than the value (matches
            # the device sort's sentinel encoding, exec/sort.py)
            arrays.append(np.where(validity, arr, np.zeros_like(arr)))
            arrays.append(
                np.where(validity, 1, 0)
                if key.nulls_first
                else np.where(validity, 0, 1)
            )
        else:
            arrays.append(arr)
    return np.lexsort(tuple(arrays))



def _host_widen(arr, dtype) -> np.ndarray:
    """Cast a fetched narrow-on-the-wire array back to the schema's host
    dtype (Column._widen's host-side twin)."""
    if dtype.is_complex or dtype.is_long_decimal:
        return arr
    want = np.dtype(dtype.device_dtype)
    a = np.asarray(arr)
    return a if a.dtype == want else a.astype(want)


def _prefetch_tiles(get_tile, n_tiles: int, depth: int = 2):
    """Iterate tiles with host->device transfers staged ``depth`` ahead.

    ``jax.device_put`` is asynchronous: starting tile i+1's upload before
    dispatching compute on tile i overlaps the (slow) host link with device
    execution — the upload-path analog of the reference's split preloading
    (velox/exec/TableScan.cpp:245 CachedBufferedInput prefetch).  Tiles
    already device-resident pass through untouched.
    """
    buf = {}

    def stage(i):
        if i < n_tiles and i not in buf:
            buf[i] = jax.tree_util.tree_map(
                lambda x: jax.device_put(x)
                if isinstance(x, (np.ndarray, jax.Array))
                else x,
                get_tile(i),
            )

    for i in range(n_tiles):
        stage(i)
        stage(i + 1)
        yield buf.pop(i)


def _replace_plan_node(
    root: PlanNode, target: PlanNode, replacement: PlanNode
) -> PlanNode:
    """Rebuild the plan with ``target`` (by identity) swapped for
    ``replacement``; shared subtrees above the target are re-created."""
    import dataclasses as _dc

    def walk(node: PlanNode) -> PlanNode:
        # match by identity or id: _linearize may hand back a reconstructed
        # node (e.g. a RIGHT join flipped to LEFT) that kept the tree id
        if node is target or node.id == target.id:
            return replacement
        changed = {}
        for attr in ("source", "left", "right"):
            child = getattr(node, attr, None)
            if isinstance(child, PlanNode):
                new = walk(child)
                if new is not child:
                    changed[attr] = new
        inputs = getattr(node, "inputs", None)
        if inputs and all(isinstance(i, PlanNode) for i in inputs):
            new_inputs = tuple(walk(i) for i in inputs)
            if any(a is not b for a, b in zip(new_inputs, inputs)):
                changed["inputs"] = new_inputs
        if changed:
            node = _dc.replace(node, **changed)
        return node

    return walk(root)


def apply_finishers(table: Table, finishers: Sequence[PlanNode]) -> Table:
    for node in finishers:
        if isinstance(node, (OrderByNode, TopNNode)):
            order = _sort_indices(table, node.keys)
            if isinstance(node, TopNNode):
                order = order[: node.count]
            table = Table(
                table.schema,
                {n: v[order] for n, v in table.columns.items()},
                table.string_tables,
                {n: v[order] for n, v in table.validities.items()},
            )
        elif isinstance(node, LimitNode):
            sl = slice(node.offset, node.offset + node.count)
            table = Table(
                table.schema,
                {n: v[sl] for n, v in table.columns.items()},
                table.string_tables,
                {n: v[sl] for n, v in table.validities.items()},
            )
        elif isinstance(node, EnforceSingleRowNode):
            if table.num_rows > 1:
                raise QueryError(
                    f"scalar subquery produced {table.num_rows} rows, expected <= 1"
                )
    return table


# ---------------------------------------------------------------------------
# The single-chip runner


def _arrow_stream_cls():
    from ..plan.nodes import ArrowStreamNode

    return ArrowStreamNode


def _merge_exchange_cls():
    from ..plan.nodes import MergeExchangeNode

    return MergeExchangeNode


def _pick_capacity(num_rows: int, tile_rows: int) -> int:
    cap = 1024
    while cap < min(num_rows, tile_rows):
        cap *= 2
    return cap


@dataclasses.dataclass
class RunStats:
    """Per-run counters (reference: TaskStats, velox/exec/TaskStats.h:30)."""

    tiles: int = 0
    rows_in: int = 0
    compile_seconds: float = 0.0
    device_seconds: float = 0.0
    total_seconds: float = 0.0


class LocalExecutor:
    """A compiled, reusable executor for one plan (the Task analog).

    Construction does everything expensive once: linearization, eager build-side
    execution for joins (the HashJoinBridge analog), and the jit wrappers — so
    repeated ``run`` calls reuse XLA executables.  Error counts are carried
    on-device and checked once at the end (no per-tile host sync).
    """

    def __init__(
        self,
        root: PlanNode,
        tile_rows: int = 1 << 20,
        config=None,
        pool=None,
    ):
        from ..config import DEFAULT_CONFIG
        from ..plan.nodes import TableWriteMergeNode, TableWriteNode
        from .memory import ROOT_POOL

        # HBM accounting: every executor reserves its device-resident state
        # (scan tiles, join builds, aggregation carries) against a per-query
        # pool; sub-executors share the parent's pool.  Reference:
        # velox/common/memory/MemoryPool.h:109 + MemoryArbitrator.h:43.
        cfg = config or None
        self._own_pool = pool is None
        if pool is None:
            from ..config import DEFAULT_CONFIG as _DC

            limit = (cfg or _DC).query_memory_limit_bytes
            pool = ROOT_POOL.add_child(
                f"query.{getattr(root, 'id', 'plan')}", limit=limit
            )
        self.pool = pool
        self._write_sink_factory = None
        self._tw_merge = False
        if isinstance(root, TableWriteMergeNode):
            # merge fragment row counts into one row (exec/TableWriteMerge.cpp)
            self._tw_merge = True
            root = root.source
        if isinstance(root, TableWriteNode):
            # the writer consumes the child pipeline's full result
            self._write_sink_factory = root.sink_factory
            root = root.source
        from .strcast import rewrite_string_construction

        root, self._strcast_specs = rewrite_string_construction(root)
        from .sketch import rewrite_sketch_aggregates

        root = rewrite_sketch_aggregates(root, cfg)
        from .joins import rewrite_filtered_existence_joins

        root = rewrite_filtered_existence_joins(root)
        from .hugeint import rewrite_long_decimals

        root, self._hugeint_logical = rewrite_long_decimals(root)
        self.root = root
        self.tile_rows = tile_rows
        self.config = config or DEFAULT_CONFIG
        lin = _linearize(root)
        from .joins import HashJoinExec

        from .joins import DuplicateBuildKeys

        from .memory import MemoryPoolError

        resolved: List[Tuple] = []
        for step in lin.steps:
            if step[0] == "join":
                from ..plan.nodes import JoinType as _JT

                sub = device = exec_ = None
                try:
                    sub = LocalExecutor(
                        step[1].right, tile_rows, config, pool=self.pool
                    )
                    device = (
                        None
                        if step[1].join_type == _JT.FULL  # host build keeps keys
                        else sub.run_device()
                    )
                    exec_ = None
                    if device is not None:
                        # build data stays in HBM end to end (no host round trip)
                        batches, err = device
                        try:
                            exec_ = HashJoinExec.build_from_device(
                                step[1], batches, err,
                                split_sorts=getattr(
                                    self.config, "split_sort_programs", True
                                ),
                            )
                        except DuplicateBuildKeys:
                            pass  # N:M build: host path constructs run spans
                    if exec_ is None:
                        exec_ = HashJoinExec.build(step[1], sub.run())
                    from .memory import device_tree_bytes

                    self.pool.reserve(
                        device_tree_bytes(
                            (
                                exec_.build_keys,
                                exec_.build_cols,
                                exec_.build_valid,
                                exec_.run_start,
                                exec_.run_count,
                            )
                        )
                    )
                except MemoryPoolError:
                    # Grace hash join (exec/grace.py): the build does not fit
                    # the memory budget — partition both sides by a salted
                    # key hash and join partition by partition, then resume
                    # planning with the joined rows as a Values source.
                    if not self._own_pool or not self.config.spill_enabled:
                        raise
                    self.pool.detach()
                    sub = device = exec_ = None  # free oversized build state
                    from ..plan.nodes import ValuesNode as _VN
                    from .grace import grace_join_table

                    jnode = step[1]
                    build_table = LocalExecutor(
                        jnode.right, tile_rows, config
                    ).run()
                    merged = grace_join_table(
                        jnode, build_table, tile_rows, self.config
                    )
                    new_root = _replace_plan_node(
                        self.root, jnode, _VN(merged, id=jnode.id)
                    )
                    self.__init__(new_root, tile_rows, config, pool=None)
                    return
                resolved.append(
                    ("xjoin", exec_) if exec_.expansion else ("join", exec_)
                )
            else:
                resolved.append(step)
        for i, step in enumerate(resolved):
            if (
                step[0] == "left_join_filter"
                and i > 0
                and resolved[i - 1][0] == "xjoin"
            ):
                # non-equi filter on an N:M LEFT join: the single-candidate
                # null-out path cannot see every match — re-plan through the
                # uid/inner/left composition (joins.rewrite_left_filter_nm)
                from .joins import rewrite_left_filter_nm

                orig = step[3]
                if self._own_pool:
                    self.pool.detach()
                new_root = _replace_plan_node(
                    self.root, orig, rewrite_left_filter_nm(orig)
                )
                self.__init__(new_root, tile_rows, config, pool=None)
                return
        # expansion (N:M) joins split the pipeline into phases: the output
        # row count is data-dependent, so each expansion is sized by one
        # per-tile scalar fetch and materialized into a power-of-two bucket
        # before the remaining (tail) steps run (exec/joins.py probe_spans)
        self._pre_segments: List[Tuple] = []
        cur: List[Tuple] = []
        for step in resolved:
            if step[0] == "xjoin":
                self._pre_segments.append((tuple(cur), step[1]))
                cur = []
            else:
                cur.append(step)
        lin.steps = cur
        self._all_steps = resolved  # incl. xjoin steps (schema tracking)
        self._pending_errs: List = []
        if self._pre_segments:
            self._seg_jits = [
                tjit(functools.partial(_apply_steps, steps=seg), label="glue")
                for seg, _ in self._pre_segments
            ]
            self._span_jits = [
                tjit(ex.probe_spans, label="probe_spans")
                for _, ex in self._pre_segments
            ]
            self._expand_jits = [
                tjit(ex.expand, label="join_expand", static_argnums=2)
                for _, ex in self._pre_segments
            ]
            self._full_tail_jits = {
                i: jax.jit(ex.full_tail)
                for i, (_, ex) in enumerate(self._pre_segments)
                if ex.expansion and ex.node.join_type.name == "FULL"
            }
            self._matched: Dict[int, jax.Array] = {}
        from .window import WindowNode

        if isinstance(lin.source, WindowNode):
            # Window is a full-materialization barrier (reference: SortWindowBuild
            # accumulates all input before emitting) — execute it now into a
            # host Table and treat the result as the pipeline's source.
            lin.source = ValuesNode(
                _materialize_window(
                    lin.source, tile_rows, pool=self.pool, config=self.config
                ),
                id=lin.source.id,
            )
        elif isinstance(lin.source, _arrow_stream_cls()):
            pass  # has .table / .output_schema: scan-like source
        elif type(lin.source).__name__ == "UnionAllNode":
            # UNION ALL barrier: materialize children, align by POSITION
            # (SQL set-op semantics), concatenate rows
            from .grouped import concat_tables

            node = lin.source
            first = node.output_schema
            parts = []
            for s in node.inputs:
                p = LocalExecutor(s, tile_rows, config, pool=self.pool).run()
                if list(p.schema.names) != list(first.names):
                    ren = dict(zip(p.schema.names, first.names))
                    p = Table(
                        first,
                        {ren[n]: v for n, v in p.columns.items()},
                        {ren[n]: v for n, v in p.string_tables.items()},
                        {ren[n]: v for n, v in p.validities.items()},
                    )
                parts.append(p)
            lin.source = ValuesNode(concat_tables(parts), id=node.id)
        elif isinstance(lin.source, _merge_exchange_cls()):
            # sorted merge of sorted inputs (MergeExchange): concatenate child
            # results and re-establish the order through the DEVICE sort
            # (exec/sort.py — stable, so the ordering is identical to the
            # reference's TreeOfLosers k-way merge), inheriting its
            # external-sort spill under memory pressure; complex-typed
            # outputs fall back to the host lexsort inside that path
            from ..plan.nodes import OrderByNode as _OBN

            node = lin.source
            parts = [
                LocalExecutor(s, tile_rows, config, pool=self.pool).run()
                for s in node.inputs
            ]
            from .grouped import concat_tables

            merged = concat_tables(parts)
            sort_plan = _OBN(ValuesNode(merged), node.keys)
            merged = LocalExecutor(
                sort_plan, tile_rows, config, pool=self.pool
            ).run()
            lin.source = ValuesNode(merged, id=node.id)
        elif not isinstance(lin.source, (TableScanNode, ValuesNode)):
            # Generic pipeline barrier: materialize the subtree (e.g. an
            # aggregation feeding a join probe side) and scan its result.
            sub = LocalExecutor(lin.source, tile_rows, config, pool=self.pool).run()
            lin.source = ValuesNode(sub, id=lin.source.id)
        self.lin = lin
        self.source_table = lin.source.table.select(
            list(lin.source.output_schema.names)
        )
        self.capacity = _pick_capacity(
            max(self.source_table.num_rows, 1), tile_rows
        )
        self.agg_exec: Optional[AggExecutor] = None

        if lin.agg is not None:
            sort_keys = _pipeline_sort_keys(lin.steps)
            presorted = bool(
                sort_keys
                and lin.agg.grouping_keys
                and sort_keys[0] == lin.agg.grouping_keys[0]
                # single-tile pipelines skip presorted grouping on purpose:
                # a full per-tile sort makes runs EXACT groups, so the
                # single-tile fast path needs NO carry merge at all — one
                # packed sort beats sort-free grouping + a merge sort over
                # carry+tile (presorted runs can split logical groups when
                # secondary keys interleave, forcing the merge)
                and self.source_table.num_tiles(self.capacity) > 1
            )
            # total-row bound for narrow sums: filters/projects and
            # NON-expanding joins of row-preserving kinds cannot grow the
            # row count (expansion joins and FULL epilogues can)
            from ..plan.nodes import JoinType as _JTn

            def _keeps_rowbound(s) -> bool:
                if s[0] in ("filter", "project", "left_join_filter"):
                    return True
                if s[0] == "join":
                    je = s[1]
                    return not getattr(
                        je, "expansion", True
                    ) and je.node.join_type in (
                        _JTn.INNER, _JTn.LEFT, _JTn.LEFT_SEMI, _JTn.ANTI
                    )
                return False

            agg_max_rows = (
                self.source_table.num_rows
                if not self._pre_segments
                and all(_keeps_rowbound(s) for s in lin.steps)
                else None
            )
            ex = AggExecutor(
                lin.agg, self.capacity, presorted, max_rows=agg_max_rows
            )
            self.agg_exec = ex
            if ex.mode == "collect_rows":
                self.kind = "collect_agg"
                needed: List[str] = list(lin.agg.grouping_keys)
                for names in ex.arg_names:
                    for nm in names:
                        if nm not in needed:
                            needed.append(nm)
                self._collect_needed = needed

                @jax.jit
                def collect_rows(batch):
                    batch2, err = apply_streaming(batch, lin.steps)
                    return compact(batch2.project(needed)), err

                self._collect_rows_jit = collect_rows
            elif ex.mode in ("ungrouped", "array"):
                self.kind = "direct_agg"
                # filter/project steps never compact, so the scan tile stays
                # row-aligned with the aggregation input — the precondition
                # for the int32 piece-sum path (raw narrow columns in, one
                # pass over every scanned byte)
                piece_rows_aligned = all(
                    s[0] in ("filter", "project") for s in lin.steps
                )
                use_piece = piece_rows_aligned and ex.try_enable_piece_path()

                def tile_step(carry, batch):
                    (accs_rc, errs) = carry
                    batch2, err = apply_streaming(batch, lin.steps)
                    return (
                        ex.update_carry(
                            accs_rc,
                            batch2,
                            scan_batch=batch if use_piece else None,
                        ),
                        errs + err,
                    )

                self._tile_step = tjit(
                    tile_step, label="agg_tile_step", donate_argnums=(0,)
                )
            elif self.config.device_agg_merge:
                self.kind = "sort_agg_device"

                # Split into small programs instead of one: the first
                # target's compiler took superlinear time in program size
                # (whether XLA's GPU compiler does is not measured yet).  Pipelines
                # containing joins (several large sorts each) additionally
                # split at the pipeline/grouping boundary.
                has_joins = any(s[0] == "join" for s in lin.steps)
                split_plan = (
                    self._plan_split_sorts(lin, ex)
                    if getattr(self.config, "split_sort_programs", True)
                    else None
                )
                if split_plan is not None:
                    sort_tile_partial = self._make_split_tile_partial(
                        split_plan, ex
                    )
                    self._split_mode = True
                elif has_joins:
                    steps_jit = tjit(
                        lambda batch: apply_streaming(batch, lin.steps),
                        label="pipeline_steps",
                    )

                    partial_only = tjit(
                        lambda b2: ex.tile_partial(b2), label="tile_partial"
                    )

                    def sort_tile_partial(batch):
                        b2, err = steps_jit(batch)
                        return partial_only(b2), err

                else:

                    @tjit(label="tile_partial")
                    def sort_tile_partial(batch):
                        batch2, err = apply_streaming(batch, lin.steps)
                        return ex.tile_partial(batch2), err

                def sort_merge_step_fn(carry, partial, err):
                    state, errs = carry
                    return (ex.merge_partial_into_carry(state, partial), errs + err)

                sort_merge_step = tjit(
                    sort_merge_step_fn, label="carry_merge",
                    donate_argnums=(0,),
                )

                self._sort_tile_partial_jit = sort_tile_partial
                self._sort_merge_step = sort_merge_step
            else:
                self.kind = "sort_agg"

                @tjit(label="tile_partial")
                def tile_partial(batch):
                    batch2, err = apply_streaming(batch, lin.steps)
                    return ex.tile_partial(batch2), err

                self._tile_partial = tile_partial
        else:
            self.kind = "collect"
            collect_split = (
                self._plan_split_collect(lin)
                if getattr(self.config, "split_sort_programs", True)
                else None
            )
            if collect_split is not None:
                tile_out = self._make_split_tile_out(collect_split)
                self._split_mode = True
            else:

                @tjit(label="tile_out")
                def tile_out(batch):
                    batch2, err = apply_streaming(batch, lin.steps)
                    return compact(batch2), err

            self._tile_out = tile_out
            out_schema = lin.source.output_schema
            for step in self._all_steps:
                if step[0] == "project":
                    out_schema = step[3]
                elif step[0] in ("join", "xjoin"):
                    out_schema = step[1].node.output_schema
                elif step[0] == "expand":
                    out_schema = step[1].output_schema
            self.out_schema = out_schema
            self._plan_device_sort()

    def _plan_device_sort(self):
        """Decide whether the leading OrderBy/TopN finisher runs on device
        (exec/sort.py); host finishers remain the fallback for complex types
        and unresolvable VARCHAR keys."""
        from .sort import SortSpec

        self._device_sort = None
        lin = self.lin
        if not lin.finishers or not isinstance(
            lin.finishers[0], (OrderByNode, TopNNode)
        ):
            return
        node0 = lin.finishers[0]
        below = node0.sources[0]
        strings_of = {
            k.name: resolve_column_strings(below, k.name) for k in node0.keys
        }
        spec = SortSpec.plan(node0.keys, self.out_schema, strings_of)
        if spec is None:
            return
        if isinstance(node0, TopNNode):
            keep = node0.count
        elif len(lin.finishers) > 1 and isinstance(lin.finishers[1], LimitNode):
            # ORDER BY + LIMIT: a sorted prefix of offset+count rows suffices
            keep = lin.finishers[1].offset + lin.finishers[1].count
        else:
            keep = None  # full device OrderBy
        self._device_sort = (spec, keep)

    # ------------------------------------------------------------------
    def _expand_tile(self, batch: Batch, start: int = 0) -> Batch:
        """Run the expansion-join phases on one tile (see __init__).

        ``start`` skips segments at/below a FULL join whose epilogue tile
        enters the pipeline mid-chain."""
        from ..plan.nodes import JoinType as _JT
        from ..utils.transfer import bucket_of, fetch_tree

        for i in range(start, len(self._pre_segments)):
            batch, err = self._seg_jits[i](batch)
            self._pending_errs.append(err)
            spans = self._span_jits[i](batch)
            ex = self._pre_segments[i][1]
            if ex.node.join_type == _JT.FULL:
                self._matched[i] = self._or_jit(self._matched[i], spans[4])
            total = int(fetch_tree(spans[3]))
            out_cap = bucket_of(max(total, 1))
            batch = self._expand_jits[i](batch, spans[:4], out_cap)
        return batch

    @staticmethod
    @jax.jit
    def _or_jit(a, b):
        return a | b

    def _drain_pending_errs(self) -> int:
        if not self._pending_errs:
            return 0
        from ..utils.transfer import fetch_tree

        total = sum(int(e) for e in fetch_tree(list(self._pending_errs)))
        self._pending_errs = []
        return total

    # ---- split-dispatch pipelines (ops/shared_sort.py) -------------------

    def _plan_split_sorts(self, lin, ex):
        """Segment the pipeline at sort boundaries so every lax.sort runs as
        a canonical SHARED program (ops/shared_sort.py) instead of inside
        this query's own programs, so a query compiles no sort of its own
        (written for the first target's compiler, which charged tens of
        seconds per program containing a sort; the GPU compile times are
        printed by chip_smoke.py).

        Returns a list of ("glue", steps_tuple) / ("join", exec) segments,
        or None when the pipeline has shapes this path does not cover
        (expansion joins, presorted or unpackable grouping, too many riding
        payload operands)."""
        if ex.mode != "sort":
            return None
        allowed = ("filter", "project", "join", "left_join_filter")
        if any(s[0] not in allowed for s in lin.steps):
            return None
        from .grouping import SortGrouping

        if not isinstance(ex.grouping, SortGrouping):
            return None
        segments: List[Tuple[str, object]] = []
        glue: List[Tuple] = []
        cap = self.capacity
        any_split_join = False
        for step in lin.steps:
            if step[0] == "join":
                exec_ = step[1]
                if exec_.supports_split_probe(cap):
                    if glue:
                        segments.append(("glue", tuple(glue)))
                        glue = []
                    segments.append(("join", exec_))
                    any_split_join = True
                else:
                    glue.append(step)
                cap = exec_.probe_output_capacity(cap)
            else:
                glue.append(step)
        if glue:
            segments.append(("glue", tuple(glue)))
        group_split = ex.grouping.supports_split(cap)
        if group_split:
            # riding payload bound (canonical bucket family): worst case one
            # validity operand per aggregate plus the mask
            n_payload = sum(a.num_args + 1 for a in ex.aggs) + 1
            from ..ops.shared_sort import _BUCKETS

            if n_payload > _BUCKETS[-1]:
                group_split = False
        if not group_split and not any_split_join:
            # nothing to hoist: presorted grouping is sort-free and no join
            # qualified — the fused paths are already cheap to compile
            return None
        return segments, group_split

    def _plan_split_collect(self, lin):
        """Segment a collect-kind pipeline: split probes out of the per-query
        program and hoist the final compaction's argsort into the canonical
        shared sort.  None when a step kind is not covered."""
        allowed = ("filter", "project", "join", "left_join_filter")
        if any(s[0] not in allowed for s in lin.steps):
            return None
        segments: List[Tuple[str, object]] = []
        glue: List[Tuple] = []
        cap = self.capacity
        for step in lin.steps:
            if step[0] == "join" and step[1].supports_split_probe(cap):
                if glue:
                    segments.append(("glue", tuple(glue)))
                    glue = []
                segments.append(("join", step[1]))
                cap = step[1].probe_output_capacity(cap)
            else:
                if step[0] == "join":
                    cap = step[1].probe_output_capacity(cap)
                glue.append(step)
        if glue:
            segments.append(("glue", tuple(glue)))
        return segments

    def _make_split_steps_runner(self, segments):
        """run_steps(batch) -> (batch, err): glue segments as jits, split
        probes as host dispatches through the canonical shared sorts."""
        compiled: List[Tuple[str, object]] = []
        for kind, obj in segments:
            if kind == "glue":
                compiled.append(
                    (
                        "glue",
                        tjit(
                            lambda b, _st=obj: apply_streaming(b, _st),
                            label="glue",
                        ),
                    )
                )
            else:
                compiled.append(("join", obj))

        def run_steps(batch):
            err_total = None
            for kind, fn in compiled:
                if kind == "glue":
                    batch, e = fn(batch)
                    err_total = e if err_total is None else err_total + e
                else:
                    batch = fn.probe_split_host(batch)
            if err_total is None:
                err_total = jnp.zeros((), dtype=jnp.int64)
            return batch, err_total

        return run_steps

    def _make_split_tile_out(self, segments):
        """Host-level collect program: glue + split probes + shared-sort
        compaction (ops/compact.py split halves)."""
        from ..ops.compact import compact_from_sorted_word, compaction_word
        from ..ops.shared_sort import shared_sort_word

        run_steps = self._make_split_steps_runner(segments)
        word_jit = tjit(
            lambda b: compaction_word(b.active_mask()), label="compact_word"
        )
        post_jit = tjit(compact_from_sorted_word, label="compact_post")

        def tile_out(batch):
            batch, err_total = run_steps(batch)
            s_word, _ = shared_sort_word(word_jit(batch), [])
            return post_jit(batch, s_word), err_total

        return tile_out

    def _make_split_tile_partial(self, split_plan, ex):
        """Host-level tile program: dispatches glue jits, split probes, and
        (when the grouping splits) the canonical grouping sort as separate
        programs.

        Live-count shrink (single-tile pipelines): the merged sort packs a
        liveness sentinel as the most significant field, so its output is
        live-prefix — every program AFTER it (boundary glue, run-end
        canonical sort, post) can run over bucket_of(live) rows instead of
        the tile capacity.  The count program dispatches BEFORE the big
        sort, so its fetch overlaps the sort's own device time.  (Q3 SF1:
        ~3.2M live of 8.4M capacity.)"""
        from ..ops.shared_sort import shared_sort_word
        from ..utils.transfer import _prefix_slicer, bucket_of, fetch_tree

        segments, group_split = split_plan
        run_steps = self._make_split_steps_runner(segments)
        single_tile = self.source_table.num_tiles(self.capacity) == 1
        if group_split:
            pre_jit = tjit(ex.tile_partial_pre, label="group_pre")
            bound_jit = tjit(ex.tile_partial_boundary, label="group_boundary")
            post_jit = tjit(ex.tile_partial_post, label="group_post")
            count_jit = tjit(
                lambda b: jnp.sum(b.active_mask().astype(jnp.int32)),
                label="live_count",
            )
        else:
            partial_jit = tjit(ex.tile_partial, label="tile_partial")

        def sort_tile_partial(batch):
            batch, err_total = run_steps(batch)
            if group_split:
                count_d = count_jit(batch) if single_tile else None
                merged, carried = pre_jit(batch)
                s_merged, s_carried = shared_sort_word(merged, list(carried))
                if count_d is not None:
                    # fetch overlaps the canonical sort just dispatched
                    live = int(fetch_tree(count_d))
                    bucket = min(
                        bucket_of(max(live, 1)), batch.capacity
                    )
                    if bucket <= batch.capacity // 2:
                        cut = _prefix_slicer(bucket)
                        (s_merged,) = cut((s_merged,))
                        s_carried = list(cut(tuple(s_carried)))
                boundary, endword, rides = bound_jit(
                    s_merged, tuple(s_carried)
                )
                s_end, s_rides = shared_sort_word(endword, list(rides))
                partial = post_jit(
                    s_merged, tuple(s_carried), boundary, s_end,
                    tuple(s_rides),
                )
            else:
                partial = partial_jit(batch)
            return partial, err_total

        return sort_tile_partial

    def run(
        self,
        prefetched_tiles: Optional[List[Batch]] = None,
        stats: Optional[RunStats] = None,
    ) -> Table:
        t_start = time.perf_counter()
        lin = self.lin
        if prefetched_tiles is not None:
            assert prefetched_tiles[0].capacity == self.capacity, (
                "prefetched tile capacity mismatch"
            )
            n_tiles = len(prefetched_tiles)
            get_tile = lambda i: prefetched_tiles[i]  # noqa: E731
        else:
            n_tiles = self.source_table.num_tiles(self.capacity)
            get_tile = lambda i: self.source_table.tile(i, self.capacity)  # noqa: E731
        if self._pre_segments:
            from ..plan.nodes import JoinType as _JT

            self._matched = {
                i: ex.init_matched()
                for i, (_, ex) in enumerate(self._pre_segments)
                if ex.node.join_type == _JT.FULL
            }
            full_idx = sorted(self._matched)
            inner_get = get_tile
            real_n = n_tiles

            def get_tile(i):
                if i < real_n:
                    return self._expand_tile(inner_get(i))
                # FULL join epilogue: unmatched build rows enter the pipeline
                # just above their join, after all real tiles marked matches
                j = full_idx[i - real_n]
                ex = self._pre_segments[j][1]
                tail = self._full_tail_jits[j](self._matched[j])
                return self._expand_tile(tail, start=j + 1)

            n_tiles = real_n + len(full_idx)
        if stats is not None:
            stats.tiles = n_tiles
            stats.rows_in = self.source_table.num_rows

        from ..utils.transfer import fetch_prefix, fetch_tree

        skip_finishers = 0
        if self.kind == "direct_agg":
            ex = self.agg_exec
            carry = (ex.init_carry(), jnp.zeros((), dtype=jnp.int64))
            t0 = time.perf_counter()
            for tile in _prefetch_tiles(get_tile, n_tiles):
                carry = self._tile_step(carry, tile)
            # one batched fetch for the whole final state
            (accs_np, rowcounts_np), errs = fetch_tree(carry)
            if stats is not None:
                stats.device_seconds = time.perf_counter() - t0
            _raise_on_errors(int(errs) + self._drain_pending_errs())
            result = ex.extract(None, accs_np, rowcounts_np)
        elif self.kind == "sort_agg_device":
            from ..utils.transfer import _prefix_slicer, bucket_of

            ex = self.agg_exec
            t0 = time.perf_counter()
            tile_iter = _prefetch_tiles(get_tile, n_tiles)
            partial0, err0 = self._sort_tile_partial_jit(next(tile_iter))
            if n_tiles == 1 and not ex.presorted:
                # single tile: the partial IS the final state — no merge
                keys_d, accs_d = partial0[0], partial0[1]
                count_d, errs_d = partial0[2], err0
                overflow_d = jnp.zeros((), dtype=jnp.int32)
            else:
                # adaptive carry size: ~4x tile 0's group count (the reference
                # sizes its hash table adaptively too, HashTable::decideHashMode);
                # undersized carries are detected on device and fall back
                (nruns0,) = fetch_tree((partial0[2],))
                G = min(self.capacity, bucket_of(max(int(nruns0), 1) * 4))
                # HBM reservation for the carry (x2: donation keeps the
                # previous state alive while the merge builds the next);
                # on pressure after arbitration, degrade to the spilling
                # host-merge path (MemoryReclaimer's spill contract).
                from .memory import MemoryPoolError

                per_row = sum(
                    np.dtype(info.dtype.device_dtype).itemsize
                    for info in ex.key_infos
                ) + sum(
                    np.dtype(dt).itemsize
                    for agg in ex.aggs
                    for dt in agg.acc_dtypes
                )
                try:
                    self.pool.reserve(2 * G * per_row)
                except MemoryPoolError:
                    from ..utils.testvalue import adjust

                    adjust("LocalExecutor::carryMemoryFallback", self)
                    return self._merge_hugeint(
                        apply_finishers(
                            self._run_sort_agg_host(get_tile, n_tiles, stats),
                            lin.finishers,
                        )
                    )

                def shrink(partial):
                    keys, accs, nruns = partial
                    if G == self.capacity:
                        return partial
                    cut = _prefix_slicer(G)
                    keys2 = cut(tuple(keys))
                    accs2 = tuple(cut(tuple(acc)) for acc in accs)
                    return (keys2, accs2, nruns)

                carry = (
                    ex.init_sorted_carry(G),
                    jnp.zeros((), dtype=jnp.int64),
                )
                carry = self._sort_merge_step(carry, shrink(partial0), err0)
                for tile in tile_iter:
                    partial, err = self._sort_tile_partial_jit(tile)
                    carry = self._sort_merge_step(carry, shrink(partial), err)
                (keys_d, accs_d, count_d, overflow_d), errs_d = carry
            # fetch the scalars first, then only the live-group prefix
            count, overflow, errs = fetch_tree((count_d, overflow_d, errs_d))
            if int(overflow):
                from ..utils.testvalue import adjust

                adjust("AggExecutor::carryOverflowFallback", self)
                # more distinct groups than carry slots: fall back to the
                # host-merge path, which handles unbounded group counts
                # (and can spill) at the cost of per-tile fetches.
                return self._merge_hugeint(
                    apply_finishers(
                        self._run_sort_agg_host(get_tile, n_tiles, stats),
                        lin.finishers,
                    )
                )
            topn_k = self._device_topn_k()
            if topn_k is not None and int(count) > topn_k:
                # TopN over agg outputs: select the top-K groups ON DEVICE and
                # fetch only K rows — K is the result size (the
                # fetch-result-sized discipline).  The
                # host finisher re-sorts the K rows exactly afterwards.
                if getattr(self.config, "split_sort_programs", True):
                    keys_d, accs_d, count_d = self._device_topn_jit(
                        keys_d, accs_d, count_d, count_host=int(count)
                    )
                else:
                    keys_d, accs_d, count_d = self._device_topn_jit(
                        keys_d, accs_d, count_d
                    )
                count = min(int(count), topn_k)
            flat = list(keys_d) + [a for acc in accs_d for a in acc]
            fetched = fetch_prefix(flat, int(count))
            if stats is not None:
                stats.device_seconds = time.perf_counter() - t0
            _raise_on_errors(int(errs) + self._drain_pending_errs())
            nkeys = len(ex.key_infos)
            group_keys = fetched[:nkeys]
            accs_np = []
            i = nkeys
            for agg in ex.aggs:
                accs_np.append(tuple(fetched[i : i + len(agg.acc_dtypes)]))
                i += len(agg.acc_dtypes)
            result = ex.extract(group_keys, accs_np)
        elif self.kind == "sort_agg":
            result = self._run_sort_agg_host(get_tile, n_tiles, stats)
        elif self.kind == "collect_agg":
            result = self._run_collect_agg(get_tile, n_tiles, stats)
        elif getattr(self, "_device_sort", None) is not None:
            # OrderBy/TopN executes on device (exec/sort.py); the finisher it
            # implements is consumed here
            result = self._run_collect_sorted(get_tile, n_tiles, stats)
            skip_finishers = 1
        else:
            from ..utils.transfer import _prefix_slicer, bucket_of

            chunks: List[Dict[str, np.ndarray]] = []
            valid_chunks: List[Dict[str, np.ndarray]] = []
            tables: Dict[str, StringTable] = {}
            t0 = time.perf_counter()
            outs = []
            for tile in _prefetch_tiles(get_tile, n_tiles):
                outs.append(self._tile_out(tile))
            # round trip 1: every tile's (length, error) together
            lens_errs = fetch_tree([(o.length, e) for o, e in outs])
            err_total = sum(int(e) for _, e in lens_errs)
            # fail BEFORE host assembly: errored rows (e.g. pool overflow)
            # can hold data the host-side converters cannot interpret
            _raise_on_errors(err_total + self._drain_pending_errs())
            # round trip 2: every tile's live-prefix column data together
            cut_tiles, specs = [], []
            for (out, _), (n_d, _) in zip(outs, lens_errs):
                n = int(n_d)
                arrays, spec = [], []
                complex_cols: Dict[str, Column] = {}
                for name, col in zip(out.schema.names, out.columns):
                    if col.dtype.is_complex:
                        # whole Column pytree (spans + pools) rides in the
                        # same batched fetch; host side re-densifies
                        complex_cols[name] = col
                        spec.append((name, "complex"))
                        continue
                    arrays.append(col.data)
                    spec.append((name, col.validity is not None))
                    if col.validity is not None:
                        arrays.append(col.validity)
                    if col.strings is not None:
                        tables[name] = col.strings
                bucket = min(bucket_of(max(n, 1)), out.capacity)
                cut_tiles.append(
                    (_prefix_slicer(bucket)(tuple(arrays)), complex_cols)
                )
                specs.append((n, spec))
            fetched_tiles = fetch_tree(cut_tiles)
            for (arrays, complex_cols), (n, spec) in zip(fetched_tiles, specs):
                row: Dict[str, np.ndarray] = {}
                vrow: Dict[str, np.ndarray] = {}
                k = 0
                for name, has_validity in spec:
                    if has_validity == "complex":
                        from ..vector.complex import column_to_host

                        seg, validity = column_to_host(complex_cols[name], n)
                        row[name] = seg
                        if validity is not None:
                            vrow[name] = validity
                        continue
                    row[name] = arrays[k][:n]
                    k += 1
                    if has_validity:
                        vrow[name] = arrays[k][:n]
                        k += 1
                chunks.append(row)
                valid_chunks.append(vrow)
            if stats is not None:
                stats.device_seconds = time.perf_counter() - t0
            from ..vector.complex import HostSegments

            cols = {}
            for n, t in zip(self.out_schema.names, self.out_schema.types):
                if not chunks:
                    cols[n] = np.zeros(0)
                elif t.is_complex:
                    parts = [c[n] for c in chunks]
                    cols[n] = type(parts[0]).concat(parts)
                else:
                    cols[n] = _host_widen(
                        np.concatenate([c[n] for c in chunks]), t
                    )
            validities = {}
            for n in self.out_schema.names:
                if any(n in vc for vc in valid_chunks):
                    # tiles without a validity array are all-valid
                    validities[n] = np.concatenate(
                        [
                            vc.get(n, np.ones(len(c[n]), dtype=bool))
                            for vc, c in zip(valid_chunks, chunks)
                        ]
                    )
            result = Table(self.out_schema, cols, tables, validities)

        result = apply_finishers(result, lin.finishers[skip_finishers:])
        if getattr(self, "_hugeint_logical", None) is not None:
            from .hugeint import merge_result

            result = merge_result(result, self._hugeint_logical)
        if getattr(self, "_strcast_specs", None):
            from .strcast import render_result

            result = render_result(result, self._strcast_specs)
        if self._write_sink_factory is not None:
            from ..dtypes import BIGINT as _BIGINT

            sink = self._write_sink_factory()
            sink.append(result)
            sink.finish()
            result = Table(
                RowType(["rows"], [_BIGINT]),
                {"rows": np.asarray([result.num_rows], dtype=np.int64)},
            )
        if self._tw_merge:
            from ..dtypes import BIGINT as _BIGINT

            rows = result.columns.get("rows")
            total = int(np.sum(rows)) if rows is not None else result.num_rows
            result = Table(
                RowType(["rows"], [_BIGINT]),
                {"rows": np.asarray([total], dtype=np.int64)},
            )
        from ..utils import reporter as _rep

        _rep.increment_counter(_rep.METRIC_QUERY_COUNT)
        _rep.increment_counter(_rep.METRIC_TILES_EXECUTED, n_tiles)
        _rep.increment_counter(
            _rep.METRIC_ROWS_SCANNED, self.source_table.num_rows
        )
        _rep.record_metric(
            _rep.METRIC_QUERY_SECONDS, time.perf_counter() - t_start
        )
        if stats is not None:
            stats.total_seconds = time.perf_counter() - t_start
        return result

    # ---- device TopN over aggregation outputs -----------------------------
    def _device_topn_k(self) -> Optional[int]:
        """K if the first finisher is a TopN whose every sort key maps to a
        device-orderable operand (group key, or sum/min/max/count/arbitrary
        accumulator limbs); else None (host path)."""
        lin = self.lin
        if not lin.finishers or not isinstance(lin.finishers[0], TopNNode):
            return None
        if getattr(self, "_topn_unsupported", False):
            return None
        fn = getattr(self, "_device_topn_jit", None)
        if fn is not None:
            return lin.finishers[0].count
        ex = self.agg_exec
        node = lin.finishers[0]
        out_names = list(ex.node.output_schema.names)
        nkeys = len(ex.key_infos)
        plan: List[Tuple] = []  # ('key', idx, desc, ranks|None) | ('agg', idx, desc)
        for sk in node.keys:
            if sk.name in ex.node.grouping_keys:
                idx = list(ex.node.grouping_keys).index(sk.name)
                info = ex.key_infos[idx]
                ranks = (
                    np.asarray(info.strings.sort_permutation(), np.int32)
                    if info.strings is not None
                    else None
                )
                plan.append(("key", idx, not sk.ascending, ranks))
            elif sk.name in out_names[nkeys:]:
                ai = out_names[nkeys:].index(sk.name)
                agg = ex.aggs[ai]
                name = getattr(agg, "name", "")
                if name not in ("sum", "min", "max", "count", "count_if", "arbitrary"):
                    self._topn_unsupported = True
                    return None
                if name == "arbitrary" and ex.out_strings[ai] is not None:
                    # arbitrary(VARCHAR) accumulates codes, not lex ranks
                    self._topn_unsupported = True
                    return None
                plan.append(("agg", ai, not sk.ascending))
            else:
                self._topn_unsupported = True
                return None
        # total order: every remaining group key as a tiebreaker
        for idx, info in enumerate(ex.key_infos):
            ranks = (
                np.asarray(info.strings.sort_permutation(), np.int32)
                if info.strings is not None
                else None
            )
            plan.append(("key", idx, False, ranks))

        def topn(keys_d, accs_d, count_d):
            G = keys_d[0].shape[0] if keys_d else accs_d[0][0].shape[0]
            idxs = jnp.arange(G, dtype=jnp.int32)
            operands: List[jax.Array] = [(idxs >= count_d).astype(jnp.int8)]
            for item in plan:
                if item[0] == "key":
                    _, i, desc, ranks = item
                    arr = keys_d[i]
                    if ranks is not None:
                        arr = jnp.take(
                            jnp.asarray(ranks), arr.astype(jnp.int32), mode="clip"
                        )
                    limbs = [arr]
                else:
                    _, ai, desc = item
                    acc = accs_d[ai]
                    agg = ex.aggs[ai]
                    if agg.name == "sum" and len(agg.acc_dtypes) == 3:
                        limbs = [acc[0], acc[1]]  # wide hi, lo
                    else:
                        limbs = [acc[0]]
                for limb in limbs:
                    if desc:
                        limb = (
                            -limb
                            if jnp.issubdtype(limb.dtype, jnp.floating)
                            else -limb.astype(jnp.int64)
                        )
                    operands.append(limb)
            perm_src = jnp.arange(G, dtype=jnp.int32)
            # order-preserving int64 encoding for every key operand so the
            # sort can run as a canonical shared program (float bitcast does
            # NOT preserve order for negatives; exec/sort.py holds the trick)
            from .sort import float_to_ordered_i64

            ops64 = [
                float_to_ordered_i64(op)
                if jnp.issubdtype(op.dtype, jnp.floating)
                else op.astype(jnp.int64)
                for op in operands
            ]
            return tuple(ops64), perm_src

        def topn_post(keys_d, accs_d, count_d, perm):
            # only the top-K slots are ever read downstream: gather K2 rows,
            # not G — full-capacity gathers were the dominant cost of the
            # old topn on the first target
            from ..utils.transfer import bucket_of

            K2 = min(bucket_of(max(node.count, 1)), perm.shape[0])
            permK = perm[:K2]
            new_keys = tuple(jnp.take(k, permK, mode="clip") for k in keys_d)
            new_accs = tuple(
                tuple(jnp.take(a, permK, mode="clip") for a in acc)
                for acc in accs_d
            )
            return new_keys, new_accs, jnp.minimum(count_d, node.count)

        def topn_words(keys_d, accs_d, count_d):
            """Packed lexicographic key WORDS for the chained-radix topn:
            bounded limbs (dictionary ranks, bounded group keys) share words
            greedily; full-width limbs (float sums) stand alone.  The
            chained form reuses ONE canonical stable 1-key program instead
            of compiling a fused multi-operand sort per query.

            Dead slots (index >= count) carry no word of their own (that
            cost a whole radix pass): full-width words force them to
            INT64_MAX and every packed word reserves its top bit as a dead
            flag, so dead rows lose every comparison against live rows —
            exactly, because any tie on all full words is broken by a
            packed word's flag (a dead-only word is appended in the rare
            all-full-width shape)."""
            from .sort import float_to_ordered_i64

            G = keys_d[0].shape[0] if keys_d else accs_d[0][0].shape[0]
            idxs = jnp.arange(G, dtype=jnp.int32)
            dead = idxs >= count_d
            pieces: List[Tuple[jax.Array, int]] = []
            for item in plan:
                if item[0] == "key":
                    _, i, desc, ranks = item
                    arr = keys_d[i]
                    info = ex.key_infos[i]
                    if ranks is not None:
                        code = jnp.take(
                            jnp.asarray(ranks), arr.astype(jnp.int32),
                            mode="clip",
                        ).astype(jnp.int64)
                        span = max(len(ranks), 2)
                        if desc:
                            code = jnp.int64(span - 1) - code
                        pieces.append((code, (span - 1).bit_length() or 1))
                        continue
                    if info.bounds is not None:
                        lo, hi = info.bounds
                        span = hi - lo + 1
                        v = arr.astype(jnp.int64)
                        code = jnp.clip(v - jnp.int64(lo), 0, span - 1)
                        if desc:
                            code = jnp.int64(span - 1) - code
                        pieces.append(
                            (code, max((span - 1).bit_length(), 1))
                        )
                        continue
                    limbs = [arr]
                else:
                    _, ai, desc = item
                    acc = accs_d[ai]
                    agg = ex.aggs[ai]
                    if agg.name == "sum" and len(agg.acc_dtypes) == 3:
                        limbs = [acc[0], acc[1]]  # wide hi, lo
                    else:
                        limbs = [acc[0]]
                for limb in limbs:
                    code = (
                        float_to_ordered_i64(limb)
                        if jnp.issubdtype(limb.dtype, jnp.floating)
                        else limb.astype(jnp.int64)
                    )
                    if desc:
                        code = ~code  # order-reversing, overflow-free
                    pieces.append((code, 64))
            words: List[jax.Array] = []
            packed_any = False
            dead64 = dead.astype(jnp.int64)
            i64max = jnp.int64(np.iinfo(np.int64).max)

            def flush_packed(cur):
                # top bit = dead flag (packing is capped at 62 bits below)
                return (dead64 << 62) | cur

            cur = None
            cur_bits = 0
            for code, width in pieces:
                if width >= 62:
                    if cur is not None:
                        words.append(flush_packed(cur))
                        packed_any = True
                        cur, cur_bits = None, 0
                    # full-width word: dead lanes forced to MAX
                    words.append(jnp.where(dead, i64max, code))
                elif cur is not None and cur_bits + width <= 62:
                    cur = (cur << width) | code
                    cur_bits += width
                else:
                    if cur is not None:
                        words.append(flush_packed(cur))
                        packed_any = True
                    cur, cur_bits = code, width
            if cur is not None:
                words.append(flush_packed(cur))
                packed_any = True
            if not packed_any:
                words.append(dead64)  # all-full-width shape: explicit flag
            return tuple(words)

        if getattr(self.config, "split_sort_programs", True):
            from ..ops.shared_sort import chained_lex_sort

            pre_jit = tjit(topn_words, label="topn_words")
            post_jit = tjit(topn_post, label="topn_post")

            def topn_split(keys_d, accs_d, count_d, count_host=None):
                if count_host is not None:
                    # live groups occupy the first `count` slots: run the
                    # radix passes over the next bucket, not the carry
                    # capacity (Q3 SF1: 1.1M live groups in an 8.4M-slot
                    # carry — a 4x cut on every pass and gather)
                    from ..utils.transfer import bucket_of

                    cap = (
                        keys_d[0].shape[0]
                        if keys_d
                        else accs_d[0][0].shape[0]
                    )
                    G2 = min(
                        cap, bucket_of(max(int(count_host), node.count, 1))
                    )
                    if G2 < cap:
                        keys_d = tuple(k[:G2] for k in keys_d)
                        accs_d = tuple(
                            tuple(a[:G2] for a in acc) for acc in accs_d
                        )
                words = pre_jit(keys_d, accs_d, count_d)
                perm = chained_lex_sort(list(words))
                return post_jit(keys_d, accs_d, count_d, perm)

            self._device_topn_jit = topn_split
        else:

            def topn_fused(keys_d, accs_d, count_d):
                ops64, perm_src = topn(keys_d, accs_d, count_d)
                sorted_ops = jax.lax.sort(
                    list(ops64) + [perm_src], num_keys=len(ops64)
                )
                return topn_post(keys_d, accs_d, count_d, sorted_ops[-1])

            self._device_topn_jit = jax.jit(topn_fused)
        return node.count

    def __del__(self):
        pool = getattr(self, "pool", None)
        if pool is not None and getattr(self, "_own_pool", False):
            pool.detach()

    def _get_tile_partial(self):
        """Jitted per-tile partial-group program (built lazily: the device-merge
        path only needs it when it falls back on group-count overflow)."""
        fn = getattr(self, "_tile_partial", None)
        if fn is None:
            ex, lin = self.agg_exec, self.lin

            @jax.jit
            def tile_partial(batch):
                batch2, err = apply_streaming(batch, lin.steps)
                return ex.tile_partial(batch2), err

            self._tile_partial = fn = tile_partial
        return fn

    def _run_sort_agg_host(self, get_tile, n_tiles: int, stats) -> Table:
        """Host-merge grouped aggregation: unbounded group counts + spilling
        (reference: GroupingSet::getOutputWithSpill, velox/exec/GroupingSet.cpp:956)."""
        from ..utils.transfer import fetch_prefix, fetch_tree

        ex = self.agg_exec
        tile_partial = self._get_tile_partial()
        err_total = 0
        key_chunks, acc_chunks = [], []
        spiller = None
        chunk_bytes = 0
        t0 = time.perf_counter()
        for tile in _prefetch_tiles(get_tile, n_tiles):
            (key_arrays, accs, ngroups), err = tile_partial(tile)
            g, err_i = fetch_tree((ngroups, err))
            err_total += int(err_i)
            g = int(g)
            flat = list(key_arrays) + [a for acc in accs for a in acc]
            fetched = fetch_prefix(flat, g)
            nkeys = len(ex.key_infos)
            keys_np = fetched[:nkeys]
            accs_np = []
            k = nkeys
            for agg in ex.aggs:
                accs_np.append(tuple(fetched[k : k + len(agg.acc_dtypes)]))
                k += len(agg.acc_dtypes)
            key_chunks.append(keys_np)
            acc_chunks.append(accs_np)
            chunk_bytes += sum(a.nbytes for a in keys_np) + sum(
                b.nbytes for acc in accs_np for b in acc
            )
            if (
                self.config.spill_enabled
                and chunk_bytes > self.config.spill_bytes_threshold
            ):
                from .memory import Spiller

                spiller = spiller or Spiller(
                    compress=self.config.spill_compression != "none"
                )
                spiller.spill(ex.partials_to_table(key_chunks, acc_chunks))
                key_chunks, acc_chunks = [], []
                chunk_bytes = 0
        if stats is not None:
            stats.device_seconds = time.perf_counter() - t0
        _raise_on_errors(err_total + self._drain_pending_errs())
        if spiller is not None:
            for t in spiller.restore():
                keys, accs = ex.table_to_partials(t)
                key_chunks.append(keys)
                acc_chunks.append(accs)
            spiller.cleanup()
        group_keys, merged = ex.merge_partials_host(key_chunks, acc_chunks)
        return ex.extract(group_keys, merged)

    def _run_collect_agg(self, get_tile, n_tiles: int, stats) -> Table:
        """Grouped aggregation with list-valued accumulators (array_agg family):
        collect key-sorted rows, assemble groups host-side (exec/collect_agg.py)."""
        from ..utils.transfer import _prefix_slicer, bucket_of, fetch_tree
        from ..vector.complex import HostSegments, column_to_host
        from .collect_agg import CollectAggregate, compute_collect

        ex = self.agg_exec
        node = ex.node
        needed = self._collect_needed
        t0 = time.perf_counter()
        outs = [
            self._collect_rows_jit(t)
            for t in _prefetch_tiles(get_tile, n_tiles)
        ]
        lens_errs = fetch_tree([(o.length, e) for o, e in outs])
        err_total = sum(int(e) for _, e in lens_errs)
        _raise_on_errors(err_total + self._drain_pending_errs())
        # fetch all tiles' live prefixes in one round trip
        cut_tiles, metas = [], []
        for (out, _), (n_d, _) in zip(outs, lens_errs):
            n = int(n_d)
            arrays, complex_cols, meta = [], {}, []
            for name, col in zip(out.schema.names, out.columns):
                if col.dtype.is_complex:
                    complex_cols[name] = col
                    meta.append((name, "complex"))
                    continue
                arrays.append(col.data)
                meta.append((name, col.validity is not None))
                if col.validity is not None:
                    arrays.append(col.validity)
            bucket = min(bucket_of(max(n, 1)), out.capacity)
            cut_tiles.append((_prefix_slicer(bucket)(tuple(arrays)), complex_cols))
            metas.append((n, meta))
        fetched = fetch_tree(cut_tiles)
        if stats is not None:
            stats.device_seconds = time.perf_counter() - t0
        chunks: List[Dict[str, object]] = []
        vchunks: List[Dict[str, np.ndarray]] = []
        for (arrays, complex_cols), (n, meta) in zip(fetched, metas):
            row, vrow = {}, {}
            k = 0
            for name, hv in meta:
                if hv == "complex":
                    seg, validity = column_to_host(complex_cols[name], n)
                    row[name] = seg
                    if validity is not None:
                        vrow[name] = validity
                    continue
                row[name] = arrays[k][:n]
                k += 1
                if hv:
                    vrow[name] = arrays[k][:n]
                    k += 1
            chunks.append(row)
            vchunks.append(vrow)
        in_schema = node.source.output_schema
        cols: Dict[str, object] = {}
        vals: Dict[str, np.ndarray] = {}
        for name in needed:
            if in_schema.type_of(name).is_complex:
                parts = [c[name] for c in chunks]
                cols[name] = type(parts[0]).concat(parts)
            else:
                cols[name] = _host_widen(
                    np.concatenate([c[name] for c in chunks]),
                    in_schema.type_of(name),
                )
            if any(name in vc for vc in vchunks):
                vals[name] = np.concatenate(
                    [
                        vc.get(name, np.ones(_col_len(c[name]), dtype=bool))
                        for vc, c in zip(vchunks, chunks)
                    ]
                )
        n_rows = _col_len(cols[needed[0]]) if needed else 0
        # sort rows by grouping keys (stable: row order preserved per group)
        keys = [np.asarray(cols[k]) for k in node.grouping_keys]
        if keys:
            order = np.lexsort(tuple(reversed(keys)))
            keys_s = [k[order] for k in keys]
            diff = np.zeros(n_rows, dtype=bool)
            if n_rows:
                diff[0] = True
                for k in keys_s:
                    diff[1:] |= k[1:] != k[:-1]
            starts = np.flatnonzero(diff)
            num_groups = len(starts)
            lengths = np.diff(np.append(starts, n_rows))
            gids = np.repeat(np.arange(num_groups), lengths)
        else:
            order = np.arange(n_rows)
            keys_s = []
            starts = np.zeros(1, np.int64)
            num_groups = 1
            gids = np.zeros(n_rows, np.int64)
        out_names = list(node.output_schema.names)
        nkeys = len(node.grouping_keys)
        out_cols: Dict[str, object] = {}
        out_tables: Dict[str, StringTable] = {}
        out_valid: Dict[str, np.ndarray] = {}
        for info, name, arr in zip(ex.key_infos, out_names[:nkeys], keys_s):
            out_cols[name] = arr[starts]
            if info.strings is not None:
                out_tables[name] = info.strings
        for i, (agg, name) in enumerate(zip(ex.aggs, out_names[nkeys:])):
            argn = ex.arg_names[i]
            if isinstance(agg, CollectAggregate):
                args, validities, tabs = [], [], []
                for nm in argn:
                    c = cols[nm]
                    if isinstance(c, (HostSegments,)) or hasattr(c, "take_rows"):
                        args.append(c.take_rows(order))
                    else:
                        args.append(np.asarray(c)[order])
                    v = vals.get(nm)
                    validities.append(None if v is None else v[order])
                    tabs.append(
                        resolve_column_strings(node.source, nm)
                        if not in_schema.type_of(nm).is_complex
                        else None
                    )
                value, validity = compute_collect(
                    agg, gids, starts, num_groups, args, validities, tabs
                )
                out_cols[name] = value
                if validity is not None:
                    out_valid[name] = validity
            else:
                value, validity = _np_classic_agg(
                    agg, ex, i, cols, vals, order, starts, gids, num_groups
                )
                out_cols[name] = value
                if ex.out_strings[i] is not None:
                    out_tables[name] = ex.out_strings[i]
                if validity is not None and not validity.all():
                    out_valid[name] = validity
        return Table(node.output_schema, out_cols, out_tables, out_valid)

    def _merge_hugeint(self, result: Table) -> Table:
        """Re-pack limb pairs into logical long-decimal columns (exec/hugeint)."""
        if getattr(self, "_hugeint_logical", None) is None:
            return result
        from .hugeint import merge_result

        return merge_result(result, self._hugeint_logical)

    def _sort_run_table(self, arrays_np, layout) -> Table:
        """Assemble a host Table from one sorted run's fetched flat arrays."""
        cols: Dict[str, np.ndarray] = {}
        validities: Dict[str, np.ndarray] = {}
        k = 0
        for name, has_validity in zip(self.out_schema.names, layout):
            cols[name] = arrays_np[k]
            k += 1
            if has_validity:
                v = arrays_np[k]
                k += 1
                if not v.all():
                    validities[name] = v
        return Table(
            self.out_schema,
            cols,
            dict(self._sort_info["strings"]),
            validities,
        )

    def _run_collect_sorted(self, get_tile, n_tiles: int, stats) -> Table:
        """Collect pipeline whose leading OrderBy/TopN runs on device.

        TopN fetches exactly K rows over the host link (bytes scale with the
        result, not the input); OrderBy fetches the live prefix already
        globally sorted, so the host lexsort finisher disappears.  Reference:
        velox/exec/OrderBy.h:35 / TopN.h:23; design notes in exec/sort.py.
        """
        from ..utils.transfer import bucket_of, fetch_prefix, fetch_tree
        from .sort import merge_sorted_chunks, tile_sorted_prefix

        spec, keep = self._device_sort
        lin = self.lin
        tile_keep = None if keep is None else bucket_of(max(keep, 1))
        if not hasattr(self, "_sort_info"):
            self._sort_info = {}
            steps = lin.steps
            info = self._sort_info
            split_steps = (
                self._plan_split_collect(lin)
                if getattr(self.config, "split_sort_programs", True)
                else None
            )
            if split_steps is not None:
                # sort-free programs: steps run through the segment runner,
                # the ORDER BY sort through the canonical shared program
                # (ops/shared_sort.py), and the gather/flatten as post glue
                from ..ops.shared_sort import shared_sort_ops
                from .sort import flatten_columns

                run_steps = self._make_split_steps_runner(split_steps)

                @tjit(label="orderby_pre")
                def sort_pre(batch2):
                    mask = batch2.active_mask()
                    ops = [~mask] + spec.operands(
                        batch2.columns, batch2.capacity
                    )
                    perm_src = jnp.arange(batch2.capacity, dtype=jnp.int32)
                    info["strings"] = {
                        name: col.strings
                        for name, col in zip(
                            batch2.schema.names, batch2.columns
                        )
                        if col.strings is not None
                    }
                    return ops, perm_src, mask

                @tjit(label="orderby_post")
                def sort_post(batch2, perm, mask):
                    count = jnp.sum(mask).astype(jnp.int32)
                    if tile_keep is not None and tile_keep < batch2.capacity:
                        perm = perm[:tile_keep]
                        count = jnp.minimum(count, tile_keep)
                    arrays, layout = flatten_columns(
                        [c.gather(perm) for c in batch2.columns],
                        perm.shape[0],
                    )
                    info["layout"] = layout
                    return arrays, count

                def tile_sorted(batch):
                    batch2, err = run_steps(batch)
                    ops, perm_src, mask = sort_pre(batch2)
                    s_keys, _ = shared_sort_ops(list(ops) + [perm_src], [])
                    arrays, count = sort_post(
                        batch2, s_keys[-1].astype(jnp.int32), mask
                    )
                    return arrays, count, err

                self._split_mode = True
            else:

                @tjit(label="tile_sorted")
                def tile_sorted(batch):
                    batch2, err = apply_streaming(batch, steps)
                    arrays, layout, count = tile_sorted_prefix(
                        spec, batch2, tile_keep
                    )
                    # static per-program facts, captured at trace time
                    info["layout"] = layout
                    info["strings"] = {
                        name: col.strings
                        for name, col in zip(
                            batch2.schema.names, batch2.columns
                        )
                        if col.strings is not None
                    }
                    return arrays, count, err

            self._tile_sorted_jit = tile_sorted
            self._merge_jits = {}
        t0 = time.perf_counter()

        # ---- accumulate per-tile sorted runs, spilling under pressure -----
        # Each tile's output is already a sorted run, so a spilled run is a
        # valid external-sort unit (reference: velox/exec/SortBuffer.cpp
        # spill() writes sorted runs; PrefixSort merge re-reads them).  TopN
        # chunks are K-sized and never spill.
        from .memory import MemoryPoolError, Spiller

        spiller = None
        reserved = 0
        resident_bytes = 0
        chunk_nbytes = None
        outs = []
        errs = []

        def _spill_resident():
            """Fetch every resident run's live prefix and spill it to disk."""
            nonlocal spiller, resident_bytes, reserved
            from ..utils.testvalue import adjust

            adjust("LocalExecutor::sortSpill", self)
            spiller = spiller or Spiller(
                    compress=self.config.spill_compression != "none"
                )
            layout_ = self._sort_info["layout"]
            for arrays_d, count_d, _ in outs:
                n = int(fetch_tree(count_d))
                arrays_np = fetch_prefix(list(arrays_d), n)
                spiller.spill(self._sort_run_table(arrays_np, layout_))
            outs.clear()
            if reserved:
                self.pool.release(reserved)
                reserved = 0
            resident_bytes = 0

        for tile in _prefetch_tiles(get_tile, n_tiles):
            out = self._tile_sorted_jit(tile)
            errs.append(out[2])
            outs.append(out)
            if keep is not None or not self.config.spill_enabled:
                continue
            if chunk_nbytes is None:
                chunk_nbytes = sum(
                    int(np.dtype(a.dtype).itemsize) * int(a.shape[0])
                    for a in out[0]
                )
            resident_bytes += chunk_nbytes
            try:
                self.pool.reserve(chunk_nbytes)
                reserved += chunk_nbytes
            except MemoryPoolError:
                _spill_resident()
            if resident_bytes > self.config.spill_bytes_threshold:
                _spill_resident()

        layout = self._sort_info["layout"]
        if spiller is not None:
            # external sort: spill the tail too, then merge runs on the host
            if outs:
                _spill_resident()
            errs_np = fetch_tree(errs)
            _raise_on_errors(
                sum(int(e) for e in errs_np) + self._drain_pending_errs()
            )
            parts = list(spiller.restore())
            spiller.cleanup()
            merged = Table.concat(parts) if len(parts) > 1 else parts[0]
            order = _sort_indices(merged, spec.keys)
            result = Table(
                merged.schema,
                {n: v[order] for n, v in merged.columns.items()},
                merged.string_tables,
                {n: v[order] for n, v in merged.validities.items()},
            )
            if stats is not None:
                stats.device_seconds = time.perf_counter() - t0
            return result

        chunks = [o[0] for o in outs]
        counts = [o[1] for o in outs]
        if len(chunks) == 1:
            flat, live_d = chunks[0], counts[0]
        else:
            mkey = tuple(c[0].shape[0] for c in chunks)
            fn = self._merge_jits.get(mkey)
            if fn is None:
                fn = jax.jit(
                    lambda ch, cn: merge_sorted_chunks(
                        spec, ch, cn, layout, keep
                    )
                )
                self._merge_jits[mkey] = fn
            flat, live_d = fn(chunks, counts)
        if keep is not None:
            # K is small: the rows, live count, and error totals ride ONE
            # round trip; the host trims to the live count afterwards
            live, errs_np, arrays = fetch_tree((live_d, errs, list(flat)))
            n = min(int(live), keep)
            arrays = [a[:n] for a in arrays]
        else:
            counts_np, errs_np = fetch_tree(
                (counts if len(chunks) > 1 else [live_d], errs)
            )
            n = sum(int(c) for c in counts_np)
            arrays = fetch_prefix(list(flat), n)
        if stats is not None:
            stats.device_seconds = time.perf_counter() - t0
        _raise_on_errors(
            sum(int(e) for e in errs_np) + self._drain_pending_errs()
        )
        cols: Dict[str, np.ndarray] = {}
        validities: Dict[str, np.ndarray] = {}
        k = 0
        for name, has_validity in zip(self.out_schema.names, layout):
            cols[name] = arrays[k]
            k += 1
            if has_validity:
                v = arrays[k]
                k += 1
                if not v.all():
                    validities[name] = v
        return Table(
            self.out_schema,
            cols,
            dict(self._sort_info["strings"]),
            validities,
        )

    def run_device(self):
        """Execute a collect-kind pipeline keeping results device-resident.

        Returns (list of compacted device Batches, error-count scalar), or
        None when the pipeline kind needs host finalization (aggregations,
        finishers) — callers fall back to ``run()`` there.
        """
        if self.kind != "collect" or self.lin.finishers:
            return None
        n_tiles = self.source_table.num_tiles(self.capacity)
        batches, errs = [], []
        for i in range(n_tiles):
            tile = self.source_table.tile(i, self.capacity)
            if self._pre_segments:
                tile = self._expand_tile(tile)
            out, e = self._tile_out(tile)
            batches.append(out)
            errs.append(e)
        errs.extend(self._pending_errs)
        self._pending_errs = []
        # a TUPLE of per-tile error scalars: summed inside the consumer's
        # program (an eager `err + e` here compiles its own add program)
        return batches, tuple(errs)

    def device_tiles(self) -> List[Batch]:
        """Upload the source scan HBM-resident (steady-state benchmarking)."""
        from .memory import device_tree_bytes

        tiles = self.source_table.device_tiles(self.capacity)
        self.pool.reserve(device_tree_bytes([t.columns for t in tiles]))
        return tiles


def _window_one_tile(wnode, child: Table, capacity: int) -> Table:
    """Run a WindowNode over one host Table slice as a single device program."""
    from .window import WindowExec

    batch = child.tile(0, capacity)
    cache = wnode.__dict__.setdefault("_window_jits", {})
    fn = cache.get(capacity)
    if fn is None:
        ex = WindowExec(wnode, capacity)
        fn = jax.jit(lambda b: compact(ex.apply(b)))
        cache[capacity] = fn
    out = fn(batch)
    from ..utils.transfer import fetch_prefix, fetch_tree

    n = int(fetch_tree(out.length))
    arrays, spec = [], []
    tables: Dict[str, StringTable] = {}
    for name, col in zip(out.schema.names, out.columns):
        arrays.append(col.data)
        spec.append((name, col.validity is not None))
        if col.validity is not None:
            arrays.append(col.validity)
        if col.strings is not None:
            tables[name] = col.strings
    fetched = fetch_prefix(arrays, n)
    cols: Dict[str, np.ndarray] = {}
    validities: Dict[str, np.ndarray] = {}
    k = 0
    for name, has_validity in spec:
        cols[name] = _host_widen(
            fetched[k], wnode.output_schema.type_of(name)
        )
        k += 1
        if has_validity:
            validities[name] = fetched[k]
            k += 1
    return Table(wnode.output_schema, cols, tables, validities)


def _table_rows(table: Table, idx) -> Table:
    """Host row-subset of a Table (gather by index array or slice)."""
    return Table(
        table.schema,
        {n: np.asarray(v)[idx] for n, v in table.columns.items()},
        table.string_tables,
        {n: np.asarray(v)[idx] for n, v in table.validities.items()},
    )


def _materialize_window(wnode, tile_rows: int, pool=None, config=None) -> Table:
    """Execute a WindowNode into a host Table.

    Window functions never cross partitions, so inputs larger than one tile
    split into chunks of WHOLE partitions (greedy packing after a host
    partition-key sort) and the same compiled per-chunk program runs over
    each — the analog of the reference's SortWindowBuild emitting one
    partition batch at a time (velox/exec/WindowBuild.h).  A single partition
    larger than the tile gets its own program sized to fit (memory then
    scales with the largest partition, not the whole input).

    Completed per-chunk results spill to disk past the configured threshold
    (reference: Window spill via SortWindowBuild, exec/Window.cpp reclaim) —
    host RAM then holds one chunk at a time plus the sorted input.
    """
    config = config or DEFAULT_CONFIG
    child = LocalExecutor(wnode.source, tile_rows, pool=pool).run()
    rows = child.num_rows
    if rows <= tile_rows:
        return _window_one_tile(
            wnode, child, _pick_capacity(max(rows, 1), 1 << 62)
        )
    if not wnode.partition_keys:
        # global window: ONE partition — it gets a single program sized to
        # fit (the oversized-partition path below)
        return _window_one_tile(
            wnode, child, _pick_capacity(max(rows, 1), 1 << 62)
        )
    # group whole partitions: host sort by partition keys (rank-ordered)
    order = _sort_indices(
        child, [SortKey(k) for k in wnode.partition_keys]
    )
    sorted_t = _table_rows(child, order)
    keys = [np.asarray(sorted_t.columns[k]) for k in wnode.partition_keys]
    diff = np.zeros(rows, dtype=bool)
    diff[0] = True
    for k in keys:
        diff[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(diff)
    sizes = np.diff(np.append(starts, rows))
    chunks: List[Tuple[int, int]] = []
    cur_start, cur_rows = 0, 0
    for st, sz in zip(starts, sizes):
        if cur_rows and cur_rows + int(sz) > tile_rows:
            chunks.append((cur_start, int(st)))
            cur_start, cur_rows = int(st), 0
        cur_rows += int(sz)
    chunks.append((cur_start, rows))
    from .memory import Spiller, table_nbytes

    spiller = None
    parts = []
    acc_bytes = 0
    for a, b in chunks:
        sub = _table_rows(sorted_t, slice(a, b))
        part = _window_one_tile(wnode, sub, _pick_capacity(b - a, 1 << 62))
        parts.append(part)
        acc_bytes += table_nbytes(part)
        if (
            config.spill_enabled
            and acc_bytes > config.spill_bytes_threshold
            and not any(t.is_complex for t in part.schema.types)
        ):
            from ..utils.testvalue import adjust

            adjust("LocalExecutor::windowSpill", wnode)
            spiller = spiller or Spiller(
                compress=config.spill_compression != "none"
            )
            for p in parts:
                spiller.spill(p)
            parts.clear()
            acc_bytes = 0
    from .grouped import concat_tables

    if spiller is not None:
        restored = list(spiller.restore())
        spiller.cleanup()
        parts = restored + parts
    return concat_tables(parts)


def run_plan(
    root: PlanNode,
    tile_rows: int = 1 << 20,
    stats: Optional[RunStats] = None,
    prefetched_tiles: Optional[List[Batch]] = None,
) -> Table:
    """One-shot convenience around LocalExecutor (tests, small queries)."""
    return LocalExecutor(root, tile_rows).run(prefetched_tiles, stats)


def _raise_on_errors(count: int):
    if count:
        raise QueryError(
            f"{count} row(s) raised during evaluation (division by zero / bad cast); "
            "wrap the expression in try(...) to null them instead"
        )
