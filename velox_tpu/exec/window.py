"""Window operator: partitioned, ordered analytic functions.

Reference: velox/exec/Window.h:38 + WindowBuild (Sort/Streaming), WindowPartition,
velox/exec/WindowFunction.h:34; function set from velox/functions/prestosql/window/.

Device re-design: the reference accumulates all input, sorts it into partitions, and
runs per-partition function loops.  Here the whole input is one device program:

  sort rows by (partition keys, order keys)  ->  partition/peer run boundaries ->
  every window function is a *segmented scan* (running frames), a *run reduction
  + gather-back* (full frames), or a *guarded shift* (lead/lag).

No scatters; ranks and frame sums come from the same SortedRuns machinery as
sort-mode aggregation (ops/segmented.py).

Scope: ROWS and RANGE frames — UNBOUNDED PRECEDING .. CURRENT ROW (the SQL
default, with correct RANGE peer semantics), full-partition frames, and
k-bounded ROWS/RANGE frames (positional offsets / RMQ sparse tables; see
_framed_agg below).  Inputs larger than one tile chunk by WHOLE partitions
with completed chunks spilling to disk past the threshold
(runner._materialize_window — the SortWindowBuild + spill analog).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..dtypes import BIGINT, DOUBLE, DataType, RowType, TypeKind
from ..ops.f64bits import f64_to_ordered
from ..ops.segmented import SortedRuns, segmented_scan
from ..plan.nodes import PlanNode, SortKey, _next_id
from ..vector.column import Batch, Column


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """One window function call: name(arg?) with optional lead/lag params."""

    name: str
    arg: Optional[str] = None  # input column name
    offset: int = 1  # lead/lag offset; also nth_value's n and ntile's buckets
    full_frame: bool = False  # aggregate over the whole partition
    # frame (preceding, following); None component = UNBOUNDED.  Absent
    # (frame is None) = the SQL default RANGE UNBOUNDED PRECEDING..CURRENT ROW.
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None
    # 'rows' (positional offsets) or 'range' (order-key value offsets,
    # PlanNode.h:1989 WindowFrame kRange with k bounds)
    frame_unit: str = "rows"
    # lead/lag/first/last IGNORE NULLS (reference: WindowFunction.h kIgnoreNulls)
    ignore_nulls: bool = False

    def result_type(self, input_type: Optional[DataType]) -> DataType:
        if self.name in ("row_number", "rank", "dense_rank", "ntile", "count"):
            return BIGINT
        if self.name in (
            "percent_rank", "cume_dist", "avg",
            "variance", "var_samp", "var_pop",
            "stddev", "stddev_samp", "stddev_pop",
        ):
            return DOUBLE
        if self.name == "nth_value":
            return input_type
        if self.name == "sum":
            from .aggregates import _sum_result_type

            return _sum_result_type(input_type)
        return input_type  # lead/lag/first_value/last_value/min/max


@dataclasses.dataclass
class WindowNode(PlanNode):
    source: PlanNode
    partition_keys: Tuple[str, ...]
    order_keys: Tuple[SortKey, ...]
    calls: Tuple[WindowCall, ...]
    call_names: Tuple[str, ...]
    id: str = dataclasses.field(default_factory=lambda: _next_id("window"))

    def __post_init__(self):
        self.sources = (self.source,)
        in_schema = self.source.output_schema
        names = list(in_schema.names)
        types = list(in_schema.types)
        for call, out_name in zip(self.calls, self.call_names):
            arg_t = in_schema.type_of(call.arg) if call.arg else None
            names.append(out_name)
            types.append(call.result_type(arg_t))
        self.output_schema = RowType(names, types)


_CALL_RE = re.compile(
    r"^\s*(?P<fn>[a-z_]+)\s*\(\s*(?P<args>[^)]*)\)\s*"
    r"(?P<ignore>(ignore|respect)\s+nulls\s*)?"
    r"(?P<frame>(rows|range)\s+between\s+.*)?$",
    re.IGNORECASE,
)
_BOUND_RE = re.compile(
    r"^(unbounded\s+(preceding|following)|current\s+row|(\d+)\s+(preceding|following))$",
    re.IGNORECASE,
)


def _parse_bound(text: str, is_start: bool) -> Optional[int]:
    """Returns offset semantics: ints are distances; None = unbounded."""
    m = _BOUND_RE.match(text.strip())
    if not m:
        raise ValueError(f"cannot parse frame bound {text!r}")
    t = text.strip().lower()
    if t.startswith("unbounded"):
        return None
    if t == "current row":
        return 0
    k = int(m.group(3))
    return k if (("preceding" in t) == is_start) else -k


def parse_window_call(text: str) -> WindowCall:
    """'rank()' | 'sum(x)' | 'lag(x, 2)' |
    'sum(x) rows between 2 preceding and current row' -> WindowCall."""
    m = _CALL_RE.match(text.strip())
    if not m:
        raise ValueError(f"cannot parse window call {text!r}")
    fn = m.group("fn").lower()
    args = [a.strip() for a in m.group("args").split(",") if a.strip()]
    frame = None
    unit = "rows"
    if m.group("frame"):
        text_f = m.group("frame").strip()
        unit = "range" if text_f.lower().startswith("range") else "rows"
        body = re.sub(
            r"^(rows|range)\s+between\s+", "", text_f, flags=re.IGNORECASE
        )
        start_s, end_s = re.split(r"\s+and\s+", body, flags=re.IGNORECASE)
        frame = (_parse_bound(start_s, True), _parse_bound(end_s, False))
    ignore = bool(m.group("ignore")) and m.group("ignore").lower().startswith(
        "ignore"
    )
    if fn in ("lead", "lag"):
        return WindowCall(
            fn, args[0], int(args[1]) if len(args) > 1 else 1,
            ignore_nulls=ignore,
        )
    if fn in ("first_value", "last_value"):
        return WindowCall(fn, args[0], full_frame=True, ignore_nulls=ignore)
    if fn == "nth_value":
        return WindowCall(fn, args[0], offset=int(args[1]))
    if fn in (
        "variance", "var_samp", "var_pop",
        "stddev", "stddev_samp", "stddev_pop",
    ):
        if frame is None:
            # SQL default frame, peer-inclusive (RANGE ... CURRENT ROW)
            frame, unit = (None, 0), "range"
        return WindowCall(fn, args[0], frame=frame, frame_unit=unit)
    if fn in ("sum", "avg", "count", "min", "max"):
        return WindowCall(
            fn, args[0] if args else None, frame=frame, frame_unit=unit
        )
    if fn in ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist"):
        return WindowCall(fn)
    if fn == "ntile":
        return WindowCall(fn, None, offset=int(args[0]))
    raise KeyError(f"unknown window function {fn!r}")


class WindowExec:
    """Computes all window columns over one sorted device tile."""

    def __init__(self, node: WindowNode, capacity: int):
        self.node = node
        self.capacity = capacity

    def apply(self, batch: Batch) -> Batch:
        node = self.node
        cap = batch.capacity
        in_schema = node.source.output_schema
        mask = batch.active_mask()

        # float keys sort and compare by their order-preserving integer code
        # (NaN largest and one peer group, -0.0 == +0.0); RANGE frames keep
        # doing arithmetic on the (sign-flipped for DESC) float values, which
        # ride the sort as extra operands
        pkeys = []
        for k in node.partition_keys:
            v = batch.column(k).decode(cap)[0]
            floating = jnp.issubdtype(v.dtype, jnp.floating)
            pkeys.append(f64_to_ordered(v) if floating else v)
        okeys, float_raw = [], {}
        for i, sk in enumerate(node.order_keys):
            v, _ = batch.column(sk.name).decode(cap)
            if jnp.issubdtype(v.dtype, jnp.floating):
                code = f64_to_ordered(v)
                float_raw[i] = v if sk.ascending else -v
                v = code if sk.ascending else ~code
            elif not sk.ascending:
                v = -v.astype(jnp.int64)
            okeys.append(v)
        extra = list(float_raw.values())

        # payload: every input column (+ validity lanes) so output is the
        # sorted batch with window columns appended
        payload: List[jax.Array] = []
        col_slots: List[Tuple[int, bool]] = []
        for col in batch.columns:
            values, validity = col.decode(cap)
            payload.append(values)
            if validity is not None:
                payload.append(validity)
                col_slots.append((len(payload) - 2, True))
            else:
                col_slots.append((len(payload) - 1, False))

        operands = [~mask] + pkeys + okeys + payload + extra + [mask]
        sorted_ops = jax.lax.sort(
            operands, num_keys=1 + len(pkeys) + len(okeys), is_stable=True
        )
        s_pkeys = sorted_ops[1 : 1 + len(pkeys)]
        s_okeys = sorted_ops[1 + len(pkeys) : 1 + len(pkeys) + len(okeys)]
        n_head = 1 + len(pkeys) + len(okeys)
        s_payload = sorted_ops[n_head : n_head + len(payload)]
        s_extra = dict(zip(float_raw, sorted_ops[n_head + len(payload) : -1]))
        s_mask = sorted_ops[-1]

        idx = jnp.arange(cap, dtype=jnp.int32)
        part_diff = jnp.zeros((cap,), jnp.bool_)
        for kv in s_pkeys:
            part_diff = part_diff | (kv != jnp.roll(kv, 1))
        part_boundary = s_mask & ((idx == 0) | part_diff)
        peer_diff = part_diff
        for kv in s_okeys:
            peer_diff = peer_diff | (kv != jnp.roll(kv, 1))
        peer_boundary = s_mask & ((idx == 0) | peer_diff)

        part_runs = SortedRuns(part_boundary, s_mask)
        part_id = part_runs.run_index  # per-row partition ordinal
        part_start = segmented_scan(idx, part_boundary, "first")
        rn = (idx - part_start + 1).astype(jnp.int64)
        peer_start = segmented_scan(idx, peer_boundary, "first")
        rank = (peer_start - part_start + 1).astype(jnp.int64)
        dense = segmented_scan(
            peer_boundary.astype(jnp.int64), part_boundary, "sum"
        )
        # per-row partition size: reduce ones per partition, gather back by id
        ones = jnp.ones((cap,), jnp.int64)
        part_sizes = part_runs.reduce(ones, s_mask, "sum")
        size_per_row = jnp.take(part_sizes, jnp.clip(part_id, 0, cap - 1), mode="clip")

        def arg_of(call: WindowCall):
            if call.arg is None:
                return None, None
            i = in_schema.index_of(call.arg)
            slot, has_validity = col_slots[i]
            values = s_payload[slot]
            validity = s_payload[slot + 1] if has_validity else None
            return values, validity

        out_cols: List[jax.Array] = []
        out_validity: List[Optional[jax.Array]] = []
        for call in node.calls:
            values, validity = arg_of(call)
            name = call.name
            if name == "row_number":
                out_cols.append(rn)
                out_validity.append(None)
            elif name == "rank":
                out_cols.append(rank)
                out_validity.append(None)
            elif name == "dense_rank":
                out_cols.append(dense)
                out_validity.append(None)
            elif name == "percent_rank":
                denom = jnp.maximum(size_per_row - 1, 1).astype(jnp.float64)
                out_cols.append(
                    jnp.where(size_per_row > 1, (rank - 1) / denom, 0.0)
                )
                out_validity.append(None)
            elif name == "cume_dist":
                # rows <= current peer group = index of the peer run's last row + 1
                peer_runs = SortedRuns(peer_boundary, s_mask)
                peer_id = peer_runs.run_index
                peer_last = peer_runs.reduce(idx, s_mask, "max")
                lp = jnp.take(peer_last, jnp.clip(peer_id, 0, cap - 1), mode="clip")
                out_cols.append(
                    (lp - part_start + 1).astype(jnp.float64)
                    / jnp.maximum(size_per_row, 1)
                )
                out_validity.append(None)
            elif name == "ntile":
                n = call.offset
                size = jnp.maximum(size_per_row, 1)
                base = size // n
                rem = size % n
                r0 = rn - 1
                cut = rem * (base + 1)
                tile_id = jnp.where(
                    r0 < cut,
                    r0 // jnp.maximum(base + 1, 1),
                    rem + (r0 - cut) // jnp.maximum(base, 1),
                )
                out_cols.append((tile_id + 1).astype(jnp.int64))
                out_validity.append(None)
            elif name in ("lead", "lag") and call.ignore_nulls:
                # k-th non-null before/after: rank rows among VALID rows and
                # gather from the stable-partitioned valid prefix
                valid_row = s_mask & (
                    validity if validity is not None else jnp.ones_like(s_mask)
                )
                perm = jnp.argsort(~valid_row, stable=True).astype(jnp.int32)
                cnt = jnp.cumsum(valid_row.astype(jnp.int32))  # valids <= idx
                total_valid = cnt[-1]
                if name == "lag":
                    # valids strictly before idx = cnt - valid(idx)
                    target = cnt - valid_row.astype(jnp.int32) - call.offset
                else:
                    target = cnt + call.offset - 1
                ok = (target >= 0) & (target < total_valid)
                pos = jnp.take(perm, jnp.clip(target, 0, cap - 1), mode="clip")
                same_part = (
                    jnp.take(part_id, pos, mode="clip") == part_id
                )
                ok = ok & same_part & s_mask
                out_cols.append(jnp.take(values, pos, mode="clip"))
                out_validity.append(ok)
            elif name == "first_value" and call.ignore_nulls:
                valid_row = s_mask & (
                    validity if validity is not None else jnp.ones_like(s_mask)
                )
                cand = jnp.where(valid_row, idx, jnp.int32(cap))
                first_valid = part_runs.reduce(cand, s_mask, "min")
                fv = jnp.take(
                    first_valid, jnp.clip(part_id, 0, cap - 1), mode="clip"
                )
                ok = fv < cap
                out_cols.append(jnp.take(values, jnp.clip(fv, 0, cap - 1), mode="clip"))
                out_validity.append(ok)
            elif name == "last_value" and call.ignore_nulls:
                valid_row = s_mask & (
                    validity if validity is not None else jnp.ones_like(s_mask)
                )
                cand = jnp.where(valid_row, idx, jnp.int32(-1))
                last_valid = part_runs.reduce(cand, s_mask, "max")
                lv = jnp.take(
                    last_valid, jnp.clip(part_id, 0, cap - 1), mode="clip"
                )
                ok = lv >= 0
                out_cols.append(jnp.take(values, jnp.clip(lv, 0, cap - 1), mode="clip"))
                out_validity.append(ok)
            elif name in ("lead", "lag"):
                k = call.offset if name == "lag" else -call.offset
                shifted = jnp.roll(values, k, axis=0)
                shifted_part = jnp.roll(part_id, k, axis=0)
                # the source row must be alive too (padding rows inherit the
                # last partition's run index)
                ok = (shifted_part == part_id) & s_mask & jnp.roll(s_mask, k, axis=0)
                if k > 0:
                    ok = ok & (idx >= k)
                else:
                    ok = ok & (idx < cap + k)
                v_ok = ok
                if validity is not None:
                    v_ok = v_ok & jnp.roll(validity, k, axis=0)
                out_cols.append(shifted)
                out_validity.append(v_ok)
            elif name == "first_value":
                out_cols.append(segmented_scan(values, part_boundary, "first"))
                out_validity.append(
                    None
                    if validity is None
                    else segmented_scan(validity, part_boundary, "first")
                )
            elif name == "last_value":
                per_part = part_runs.reduce(idx, s_mask, "max")
                last_pos = jnp.take(
                    per_part, jnp.clip(part_id, 0, cap - 1), mode="clip"
                )
                out_cols.append(jnp.take(values, last_pos, mode="clip"))
                out_validity.append(
                    None
                    if validity is None
                    else jnp.take(validity, last_pos, mode="clip")
                )
            elif name == "nth_value":
                values, validity = arg_of(call)
                per_part_last = part_runs.reduce(idx, s_mask, "max")
                part_last = jnp.take(
                    per_part_last, jnp.clip(part_id, 0, cap - 1), mode="clip"
                )
                pos = part_start + jnp.int32(call.offset - 1)
                # visible once the default frame (up to the current peer group's
                # last row) includes the nth row
                peer_runs0 = SortedRuns(peer_boundary, s_mask)
                at_peer_end0 = peer_runs0.reduce(idx, s_mask, "max")
                frame_hi = jnp.take(
                    at_peer_end0,
                    jnp.clip(peer_runs0.run_index, 0, cap - 1),
                    mode="clip",
                )
                ok = (pos <= part_last) & (pos <= frame_hi)
                out_cols.append(jnp.take(values, jnp.clip(pos, 0, cap - 1), mode="clip"))
                v = ok
                if validity is not None:
                    v = v & jnp.take(validity, jnp.clip(pos, 0, cap - 1), mode="clip")
                out_validity.append(v)
            elif (
                name
                in (
                    "sum", "avg", "count", "min", "max",
                    "variance", "var_samp", "var_pop",
                    "stddev", "stddev_samp", "stddev_pop",
                )
                and call.frame is not None
            ):
                # k-bounded frames.  ROWS: positional offsets clamped to the
                # partition.  RANGE: order-key value offsets resolved to row
                # positions with a scatter-free rank merge (the reference's
                # kPreceding/kFollowing RANGE bounds, PlanNode.h:1989).
                if call.arg is None:
                    base_vals, v_mask = ones, s_mask
                else:
                    base_vals, validity = arg_of(call)
                    v_mask = s_mask if validity is None else (s_mask & validity)
                acc_dtype = (
                    jnp.float64
                    if jnp.issubdtype(base_vals.dtype, jnp.floating)
                    else jnp.int64
                )
                per_part_last = part_runs.reduce(idx, s_mask, "max")
                part_last = jnp.take(
                    per_part_last, jnp.clip(part_id, 0, cap - 1), mode="clip"
                )
                k_pre, k_post = call.frame
                if call.frame_unit == "range" and (
                    k_pre is not None or k_post is not None
                ):
                    if len(s_okeys) != 1:
                        raise NotImplementedError(
                            "RANGE k frames need exactly one ORDER BY key"
                        )
                    from ..ops.segmented import rank_in_segments

                    okey = s_extra.get(0, s_okeys[0])
                    big = jnp.int64(1) << 40
                    seg = jnp.where(s_mask, part_id.astype(jnp.int64), big)
                    if k_pre is None:
                        lo = part_start
                    else:
                        lo = rank_in_segments(
                            seg, okey, seg, okey - k_pre, inclusive=False
                        )
                    if k_post is None:
                        hi = part_last
                    else:
                        hi = (
                            rank_in_segments(
                                seg, okey, seg, okey + k_post, inclusive=True
                            )
                            - 1
                        )
                else:
                    lo = (
                        part_start
                        if k_pre is None
                        else jnp.maximum(idx - k_pre, part_start)
                    )
                    hi = (
                        part_last
                        if k_post is None
                        else jnp.minimum(idx + k_post, part_last)
                    )
                lo = jnp.clip(jnp.maximum(lo, part_start), 0, cap - 1)
                hi = jnp.clip(jnp.minimum(hi, part_last), 0, cap - 1)
                empty = hi < lo
                if name not in ("sum", "avg", "count", "min", "max"):
                    # variance family over the frame via prefix sums of x, x^2
                    scale = 0
                    if call.arg is not None:
                        t = in_schema.type_of(call.arg)
                        if t.kind == TypeKind.DECIMAL:
                            scale = t.scale
                    vf = base_vals.astype(jnp.float64) / (10.0**scale)
                    vf = jnp.where(v_mask, vf, 0.0)
                    pref_s = segmented_scan(vf, part_boundary, "sum")
                    pref_ss = segmented_scan(vf * vf, part_boundary, "sum")
                    prefc = segmented_scan(
                        v_mask.astype(jnp.int64), part_boundary, "sum"
                    )
                    lo_prev = jnp.clip(lo - 1, 0, cap - 1)
                    has_prev = lo > part_start

                    def fdiff(pref, zero=0.0):
                        at_hi = jnp.take(pref, hi, mode="clip")
                        at_lo = jnp.where(
                            has_prev,
                            jnp.take(pref, lo_prev, mode="clip"),
                            jnp.asarray(zero, pref.dtype),
                        )
                        return at_hi - at_lo

                    ws = fdiff(pref_s)
                    wss = fdiff(pref_ss)
                    wn = fdiff(prefc, 0).astype(jnp.float64)
                    m2 = jnp.maximum(wss - ws * ws / jnp.maximum(wn, 1.0), 0.0)
                    pop = name.endswith("_pop")
                    denom = wn if pop else jnp.maximum(wn - 1.0, 1.0)
                    out = m2 / jnp.maximum(denom, 1.0)
                    if name.startswith("stddev"):
                        out = jnp.sqrt(out)
                    ok = (~empty) & (wn >= (1 if pop else 2))
                    out_cols.append(out)
                    out_validity.append(ok)
                elif name in ("min", "max"):
                    from ..ops.segmented import (
                        identity_for,
                        sparse_table,
                        sparse_table_query,
                    )

                    op = name
                    ident = identity_for(op, acc_dtype)
                    masked = jnp.where(
                        v_mask,
                        base_vals.astype(acc_dtype),
                        jnp.asarray(ident, acc_dtype),
                    )
                    table = sparse_table(masked, op)
                    out = sparse_table_query(table, lo, hi, op, ident)
                    prefc = segmented_scan(
                        v_mask.astype(jnp.int64), part_boundary, "sum"
                    )
                    cnt_hi = jnp.take(prefc, hi, mode="clip")
                    lo_prev = jnp.clip(lo - 1, 0, cap - 1)
                    has_prev = lo > part_start
                    cnt_lo = jnp.where(
                        has_prev, jnp.take(prefc, lo_prev, mode="clip"), 0
                    )
                    wcnt = cnt_hi - cnt_lo
                    out_cols.append(out)
                    out_validity.append(~empty & (wcnt > 0))
                else:
                    masked = jnp.where(v_mask, base_vals.astype(acc_dtype), 0)
                    pref = segmented_scan(masked, part_boundary, "sum")
                    prefc = segmented_scan(
                        v_mask.astype(jnp.int64), part_boundary, "sum"
                    )
                    sum_hi = jnp.take(pref, hi, mode="clip")
                    cnt_hi = jnp.take(prefc, hi, mode="clip")
                    lo_prev = jnp.clip(lo - 1, 0, cap - 1)
                    has_prev = lo > part_start
                    sum_lo = jnp.where(
                        has_prev, jnp.take(pref, lo_prev, mode="clip"), 0
                    )
                    cnt_lo = jnp.where(
                        has_prev, jnp.take(prefc, lo_prev, mode="clip"), 0
                    )
                    wsum = sum_hi - sum_lo
                    wcnt = cnt_hi - cnt_lo
                    if name == "count":
                        out_cols.append(jnp.where(empty, 0, wcnt))
                        out_validity.append(None)
                    elif name == "avg":
                        scale = 0
                        if call.arg is not None:
                            t = in_schema.type_of(call.arg)
                            if t.kind == TypeKind.DECIMAL:
                                scale = t.scale
                        out_cols.append(
                            wsum.astype(jnp.float64)
                            / jnp.maximum(wcnt, 1)
                            / (10.0**scale)
                        )
                        out_validity.append(~empty & (wcnt > 0))
                    else:
                        out_cols.append(wsum)
                        out_validity.append(~empty & (wcnt > 0))
            elif name in ("sum", "min", "max", "avg", "count"):
                if call.arg is None:  # count(*)
                    base_vals = ones
                    v_mask = s_mask
                else:
                    base_vals = values
                    v_mask = s_mask if validity is None else (s_mask & validity)
                acc_dtype = (
                    jnp.float64
                    if jnp.issubdtype(base_vals.dtype, jnp.floating)
                    else jnp.int64
                )
                from ..ops.segmented import identity_for

                op = {"sum": "sum", "avg": "sum", "count": "sum", "min": "min", "max": "max"}[name]
                masked = jnp.where(
                    v_mask,
                    base_vals.astype(acc_dtype),
                    jnp.asarray(identity_for(op, acc_dtype), acc_dtype),
                )
                running = segmented_scan(masked, part_boundary, op)
                counts_run = segmented_scan(
                    v_mask.astype(jnp.int64), part_boundary, "sum"
                )
                # default SQL frame is RANGE ... CURRENT ROW: peers share the
                # value at the *last* peer row
                peer_runs = SortedRuns(peer_boundary, s_mask)
                peer_id = peer_runs.run_index
                at_peer_end = peer_runs.reduce(idx, s_mask, "max")
                lp = jnp.take(at_peer_end, jnp.clip(peer_id, 0, cap - 1), mode="clip")
                running = jnp.take(running, lp, mode="clip")
                counts = jnp.take(counts_run, lp, mode="clip")
                if name == "count":
                    out_cols.append(counts)
                    out_validity.append(None)
                elif name == "avg":
                    scale = 0
                    if call.arg is not None:
                        t = in_schema.type_of(call.arg)
                        if t.kind == TypeKind.DECIMAL:
                            scale = t.scale
                    out_cols.append(
                        running.astype(jnp.float64)
                        / jnp.maximum(counts, 1)
                        / (10.0**scale)
                    )
                    out_validity.append(counts > 0)
                else:
                    out_cols.append(running)
                    out_validity.append(counts > 0)
            else:
                raise KeyError(f"unknown window function {name!r}")

        # assemble output batch (sorted order)
        cols: List[Column] = []
        for (slot, has_validity), col, dtype in zip(
            col_slots, batch.columns, in_schema.types
        ):
            values = s_payload[slot]
            validity = s_payload[slot + 1] if has_validity else None
            cols.append(Column.flat(values, dtype, validity, col.strings))
        out_types = node.output_schema.types[len(in_schema) :]
        for arr, validity, dtype in zip(out_cols, out_validity, out_types):
            cols.append(
                Column.flat(arr.astype(dtype.device_dtype), dtype, validity)
            )
        return Batch(
            tuple(cols), batch.length, s_mask, node.output_schema, cap
        )
