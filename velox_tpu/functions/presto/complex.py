"""Presto array/map functions + lambda (higher-order) functions.

Reference: velox/functions/prestosql/ArrayFunctions.h, MapFunctions.h and the
lambda family (velox/functions/prestosql/Transform.cpp, Filter.cpp, Reduce.cpp,
ZipWith.cpp) built on velox/expression/LambdaExpr.h + ComplexViewTypes.h.

Device re-design: an ARRAY/MAP value is per-row spans over fixed element pools
(velox_tpu.expr.seg.SegValue).  Three evaluation regimes, all scatter-free:

* span lookups (cardinality, element_at, slice) — pure gathers on any layout;
* pool passes (transform, filter, min/max, distinct) — normalize the pool to
  row order once (sort-based, memoized), then the whole pool is processed in
  one vectorized pass; lambdas evaluate their body over the *pool* with outer
  columns gathered per element through rowid;
* offset iteration (reduce with an arbitrary, non-associative lambda) — a
  while_loop over element offsets, each step processing every row in parallel
  (iterations = longest array, not pool size).

Unlike the scalar registry, these are dispatched by name from the expression
compiler (velox_tpu.expr.compiler EvalContext._call) because their argument
values are SegValues / Lambda nodes rather than flat arrays; the registry
entries below exist for parse-time type resolution only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ...dtypes import (
    BIGINT,
    BOOLEAN,
    DOUBLE,
    DataType,
    RowType,
    TypeKind,
    array as array_t,
    map_ as map_t,
)
from ...expr.ir import Call, Expr, FieldAccess, Lambda
from ...expr.registry import ANY, DEFAULT_REGISTRY, INTEGER as INT_M, NUMERIC
from ...expr.seg import Elems, SegValue
from ...ops.segpool import (
    compact_pool,
    dense_starts,
    owner_rows,
    segment_any,
    segment_reduce,
)

_INT_MAX = 2**31 - 1


def _and(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _result(ctx, values, validity=None, errors=None, strings=None):
    from ...expr.compiler import EvalResult

    return EvalResult(values, validity, errors, strings)


# ---------------------------------------------------------------------------
# lambda evaluation


def _free_fields(expr: Expr, bound: frozenset) -> List[FieldAccess]:
    out: Dict[str, FieldAccess] = {}

    def walk(e: Expr, bound_names):
        if isinstance(e, FieldAccess):
            if e.name not in bound_names and e.name not in out:
                out[e.name] = e
            return
        if isinstance(e, Lambda):
            bound_names = bound_names | set(e.params)
        for c in e.children:
            walk(c, bound_names)

    walk(expr, set(bound))
    return list(out.values())


def _eval_lambda(
    ctx,
    lam: Lambda,
    bindings: List[Elems],
    size: int,
    rowid: Optional[jax.Array],
):
    """Evaluate a lambda body over ``size`` slots.

    ``bindings`` supplies the parameter element pools; free (captured) outer
    columns are gathered per slot through ``rowid`` (None = slots are rows).
    Returns an EvalResult over the slots.
    """
    from ...expr.compiler import EvalContext
    from ...vector.column import Batch, Column

    names = list(lam.params)
    cols: List[Column] = []
    for elems in bindings:
        if isinstance(elems.values, SegValue):
            cols.append(elems.values.to_column(elems.validity))
        else:
            cols.append(
                Column.flat(elems.values, elems.dtype, elems.validity, elems.strings)
            )
    types = [e.dtype for e in bindings]
    for fa in _free_fields(lam.body, frozenset(lam.params)):
        col = ctx.batch.column(fa.name)
        values, validity = col.decode(ctx.capacity)
        if rowid is not None:
            values = jnp.take(values, rowid, axis=0, mode="clip")
            if validity is not None:
                validity = jnp.take(validity, rowid, mode="clip")
        names.append(fa.name)
        types.append(fa.dtype)
        cols.append(Column.flat(values, fa.dtype, validity, col.strings))
    pseudo = Batch.make(
        RowType(names, types), cols, size, capacity=size
    )
    sub = EvalContext(pseudo, ctx.registry)
    return sub.evaluate(lam.body)


# ---------------------------------------------------------------------------
# shared helpers


def _seg_arg(ctx, e: Expr):
    r = ctx.evaluate(e)
    assert isinstance(r.values, SegValue), f"{e} did not produce a SegValue"
    return r


def _elem_result(ctx, elems: Elems, pos, ok, row_validity, errors):
    """Gather pool elements at per-row positions -> EvalResult."""
    taken = elems.take(jnp.clip(pos, 0, elems.pool_cap - 1))
    validity = _and(_and(taken.validity, ok), row_validity)
    if validity is None:
        validity = ok
    return _result(ctx, taken.values, validity, errors, strings=taken.strings)


def _broadcast_rows(values, validity, rowid):
    v = jnp.take(values, rowid, axis=0, mode="clip")
    val = None if validity is None else jnp.take(validity, rowid, mode="clip")
    return v, val


# ---------------------------------------------------------------------------
# array functions


def _cardinality(ctx, expr: Call):
    r = ctx.evaluate(expr.args[0])
    seg = r.values
    return _result(ctx, seg.sizes.astype(jnp.int64), r.validity, r.errors)


def _array_index(ctx, expr: Call, strict: bool):
    r = _seg_arg(ctx, expr.args[0])
    seg: SegValue = r.values
    i = ctx.evaluate(expr.args[1])
    idx = i.values.astype(jnp.int32)
    sizes = seg.sizes.astype(jnp.int32)
    eff = jnp.where(idx < 0, sizes + idx, idx - 1)
    oob = (eff < 0) | (eff >= sizes) | (idx == 0)
    pos = seg.starts.astype(jnp.int32) + eff
    row_validity = _and(r.validity, i.validity)
    errors = _or(r.errors, i.errors)
    if strict:
        err = oob if row_validity is None else (oob & row_validity)
        errors = _or(errors, err)
        return _elem_result(
            ctx, seg.children[0], pos, jnp.ones_like(oob), row_validity, errors
        )
    return _elem_result(ctx, seg.children[0], pos, ~oob, row_validity, errors)


def _map_lookup(ctx, expr: Call, strict: bool):
    r = _seg_arg(ctx, expr.args[0])
    k = ctx.evaluate(expr.args[1])
    norm = r.values.normalized()
    keys, vals = norm.children
    k_pool, k_val = _broadcast_rows(k.values, k.validity, norm.rowid)
    match = norm.emask & (keys.values == k_pool)
    if keys.validity is not None:
        match = match & keys.validity
    if k_val is not None:
        match = match & k_val
    pool_cap = keys.pool_cap
    pos_arr = jnp.where(match, jnp.arange(pool_cap, dtype=jnp.int32), _INT_MAX)
    first = segment_reduce(
        pos_arr, norm.starts, norm.sizes, norm.rowid, norm.emask, "min", init=_INT_MAX
    )
    found = first != _INT_MAX
    row_validity = _and(r.validity, k.validity)
    errors = _or(r.errors, k.errors)
    if strict:
        miss = ~found if row_validity is None else (~found & row_validity)
        errors = _or(errors, miss)
        return _elem_result(
            ctx, vals, first, jnp.ones_like(found), row_validity, errors
        )
    return _elem_result(ctx, vals, first, found, row_validity, errors)


def _subscript(ctx, expr: Call):
    if expr.args[0].dtype.kind == TypeKind.MAP:
        return _map_lookup(ctx, expr, strict=True)
    return _array_index(ctx, expr, strict=True)


def _element_at(ctx, expr: Call):
    if expr.args[0].dtype.kind == TypeKind.MAP:
        return _map_lookup(ctx, expr, strict=False)
    return _array_index(ctx, expr, strict=False)


def _contains(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    x = ctx.evaluate(expr.args[1])
    norm = r.values.normalized()
    elems = norm.children[0]
    x_pool, x_val = _broadcast_rows(x.values, x.validity, norm.rowid)
    ev = elems.validity
    match = norm.emask & (elems.values == x_pool)
    if ev is not None:
        match = match & ev
    if x_val is not None:
        match = match & x_val
    args5 = (norm.starts, norm.sizes, norm.rowid, norm.emask)
    has = segment_any(match, *args5)
    has_null = (
        segment_any(norm.emask & ~ev, *args5)
        if ev is not None
        else jnp.zeros_like(has)
    )
    # Presto: TRUE on match; NULL if no match but a null element exists
    validity = has | ~has_null
    validity = _and(validity, _and(r.validity, x.validity))
    return _result(ctx, has, validity, _or(r.errors, x.errors))


def _array_position(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    x = ctx.evaluate(expr.args[1])
    norm = r.values.normalized()
    elems = norm.children[0]
    x_pool, x_val = _broadcast_rows(x.values, x.validity, norm.rowid)
    match = norm.emask & (elems.values == x_pool)
    if elems.validity is not None:
        match = match & elems.validity
    if x_val is not None:
        match = match & x_val
    pool_cap = elems.pool_cap
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    offset = pos - jnp.take(norm.starts, norm.rowid, mode="clip") + 1
    cand = jnp.where(match, offset, _INT_MAX)
    first = segment_reduce(
        cand, norm.starts, norm.sizes, norm.rowid, norm.emask, "min", init=_INT_MAX
    )
    out = jnp.where(first == _INT_MAX, 0, first).astype(jnp.int64)
    validity = _and(r.validity, x.validity)
    return _result(ctx, out, validity, _or(r.errors, x.errors))


def _array_minmax(op: str):
    def fn(ctx, expr: Call):
        r = _seg_arg(ctx, expr.args[0])
        norm = r.values.normalized()
        elems = norm.children[0]
        args5 = (norm.starts, norm.sizes, norm.rowid, norm.emask)
        out = segment_reduce(elems.values, *args5, op)
        nonempty = norm.sizes > 0
        validity = nonempty
        if elems.validity is not None:
            # Presto: NULL if the array contains a null element
            has_null = segment_any(norm.emask & ~elems.validity, *args5)
            validity = validity & ~has_null
        validity = _and(validity, r.validity)
        return _result(ctx, out, validity, r.errors)

    return fn


def _array_sum(ctx, expr: Call):
    """Per-row sum of elements, null elements skipped (Spark semantics)."""
    r = _seg_arg(ctx, expr.args[0])
    norm = r.values.normalized()
    elems = norm.children[0]
    v = elems.values
    if jnp.issubdtype(v.dtype, jnp.integer):
        v = v.astype(jnp.int64)
    out = segment_reduce(
        v,
        norm.starts,
        norm.sizes,
        norm.rowid,
        norm.emask,
        "sum",
        value_mask=elems.validity,
    )
    return _result(ctx, out, r.validity, r.errors)


def _array_sort(ctx, expr: Call, desc: bool = False):
    r = _seg_arg(ctx, expr.args[0])
    norm = r.values.normalized()
    elems = norm.children[0]
    pool_cap = elems.pool_cap
    row_key = jnp.where(norm.emask, norm.rowid, jnp.int32(_INT_MAX))
    null_key = (
        (~elems.validity).astype(jnp.int32)
        if elems.validity is not None
        else jnp.zeros((pool_cap,), jnp.int32)
    )
    order = _order_key(elems, norm)
    if desc:
        # order-preserving int64 encoding, then bitwise NOT (exec/sort.py);
        # nulls stay last (Presto array_sort_desc keeps nulls last too)
        if jnp.issubdtype(order.dtype, jnp.floating):
            from ...exec.sort import float_to_ordered_i64

            order = float_to_ordered_i64(order)
        order = ~order.astype(jnp.int64)
    ops = [row_key, null_key, order, elems.values]
    if elems.validity is not None:
        ops.append(elems.validity)
    sorted_ops = jax.lax.sort(ops, num_keys=3)
    values = sorted_ops[3]
    validity = sorted_ops[4] if elems.validity is not None else None
    out = SegValue(
        norm.starts,
        norm.sizes,
        (Elems(values, validity, elems.dtype, elems.strings),),
        r.values.dtype,
    )
    return _result(ctx, out, r.validity, r.errors)


def _order_key(elems: Elems, norm) -> jax.Array:
    """Device ordering key for pool elements (strings order by code rank)."""
    v = elems.values
    if elems.dtype.is_string and elems.strings is not None:
        import numpy as np

        ranks = jnp.asarray(
            np.asarray(elems.strings.sort_permutation(), np.int32)
        )
        return jnp.take(ranks, v.astype(jnp.int32), mode="clip")
    return v


def _array_sort_desc(ctx, expr: Call):
    return _array_sort(ctx, expr, desc=True)


def _array_union(ctx, expr: Call):
    """array_union(x, y) = array_distinct(concat(x, y)) — the reference's
    ArrayUnionFunction builds the same dedup-of-concat (ArraySetOps)."""
    inner = Call(expr.dtype, "concat", (expr.args[0], expr.args[1]))
    return _array_distinct(ctx, Call(expr.dtype, "array_distinct", (inner,)))


def _array_normalize(ctx, expr: Call):
    """array_normalize(x, p): divide by the p-norm; zero norm returns the
    input unchanged (reference: ArrayNormalizeFunction.h)."""
    r = _seg_arg(ctx, expr.args[0])
    pr = ctx.evaluate(expr.args[1])
    p = pr.values.astype(jnp.float64)
    norm_ = r.values.normalized()
    elems = norm_.children[0]
    v = elems.values.astype(jnp.float64)
    live = norm_.emask
    if elems.validity is not None:
        live = live & elems.validity
    # per-row segment sums without scatter: the normalized pool is row-
    # contiguous, so sums are cumsum differences at [start, start+size)
    p_elem = jnp.take(p, jnp.clip(norm_.rowid, 0, ctx.capacity - 1), mode="clip")
    av = jnp.where(live, jnp.abs(v) ** p_elem, 0.0)
    c = jnp.cumsum(av)
    starts, sizes = norm_.starts, norm_.sizes
    end = jnp.clip(starts + sizes - 1, 0, av.shape[0] - 1)
    upper = jnp.take(c, end, mode="clip")
    lower = jnp.where(
        starts > 0, jnp.take(c, jnp.clip(starts - 1, 0, None), mode="clip"), 0.0
    )
    total = jnp.where(sizes > 0, upper - lower, 0.0)
    norm_val = total ** (1.0 / jnp.maximum(p, 1e-300))
    scale = jnp.where(norm_val > 0, 1.0 / norm_val, 1.0)
    out_v = v * jnp.take(scale, jnp.clip(norm_.rowid, 0, ctx.capacity - 1))
    out = SegValue(
        starts,
        sizes,
        (Elems(out_v, elems.validity, DOUBLE, None),),
        expr.dtype,
    )
    return _result(
        ctx, out, _and(r.validity, pr.validity), _or(r.errors, pr.errors)
    )


def _array_distinct(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    norm = r.values.normalized()
    elems = norm.children[0]
    pool_cap = elems.pool_cap
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    row_key = jnp.where(norm.emask, norm.rowid, jnp.int32(_INT_MAX))
    null_key = (
        (~elems.validity).astype(jnp.int32)
        if elems.validity is not None
        else jnp.zeros((pool_cap,), jnp.int32)
    )
    # sort by (row, null?, value) carrying position; first of each equal run
    # wins, then restore original order and compact
    rk, nk, vv, ps = jax.lax.sort(
        [row_key, null_key, elems.values, pos], num_keys=3
    )
    same = (
        (rk == jnp.roll(rk, 1))
        & (nk == jnp.roll(nk, 1))
        & (vv == jnp.roll(vv, 1))
    )
    same = same.at[0].set(False)
    keep_sorted = ~same
    # route keep flags back to original positions by sorting on position
    _, keep = jax.lax.sort([ps, keep_sorted.astype(jnp.int32)], num_keys=1)
    keep = keep.astype(jnp.bool_) & norm.emask
    pools = [elems.values]
    if elems.validity is not None:
        pools.append(elems.validity)
    starts, sizes, new_pools, rowid, emask = compact_pool(
        keep, norm.starts, norm.sizes, norm.rowid, norm.emask, tuple(pools)
    )
    validity = new_pools[1] if elems.validity is not None else None
    out = SegValue(
        starts,
        sizes,
        (Elems(new_pools[0], validity, elems.dtype, elems.strings),),
        r.values.dtype,
    )
    return _result(ctx, out, r.validity, r.errors)


def _slice(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    seg: SegValue = r.values
    s = ctx.evaluate(expr.args[1])
    n = ctx.evaluate(expr.args[2])
    start1 = s.values.astype(jnp.int32)
    length = jnp.maximum(n.values.astype(jnp.int32), 0)
    sizes = seg.sizes.astype(jnp.int32)
    eff = jnp.where(start1 < 0, sizes + start1, start1 - 1)
    errors = (start1 == 0) | (n.values.astype(jnp.int32) < 0)
    eff_c = jnp.clip(eff, 0, sizes)
    new_sizes = jnp.clip(length, 0, sizes - eff_c)
    new_starts = seg.starts.astype(jnp.int32) + eff_c
    row_validity = _and(_and(r.validity, s.validity), n.validity)
    if row_validity is not None:
        errors = errors & row_validity
    out = SegValue(new_starts, new_sizes, seg.children, seg.dtype)
    return _result(
        ctx, out, row_validity, _or(_or(r.errors, s.errors), _or(n.errors, errors))
    )


def _reverse(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    norm = r.values.normalized()
    starts_p = jnp.take(norm.starts, norm.rowid, mode="clip")
    sizes_p = jnp.take(norm.sizes, norm.rowid, mode="clip")
    pos = jnp.arange(norm.children[0].pool_cap, dtype=jnp.int32)
    src = starts_p + sizes_p - 1 - (pos - starts_p)
    src = jnp.where(norm.emask, src, pos)
    new_children = tuple(ch.take(src) for ch in norm.children)
    out = SegValue(norm.starts, norm.sizes, new_children, r.values.dtype)
    return _result(ctx, out, r.validity, r.errors)


def _concat_arrays(ctx, expr: Call):
    results = [_seg_arg(ctx, a) for a in expr.args]
    segs = [r.values for r in results]
    elem_t = segs[0].dtype.element
    if elem_t.is_complex:
        raise NotImplementedError("concat of nested arrays")
    tables = {id(s.children[0].strings) for s in segs if s.children[0].strings}
    if len(tables) > 1:
        raise TypeError("concat: VARCHAR arrays must share one dictionary")
    sizes_list = [s.sizes.astype(jnp.int32) for s in segs]
    out_sizes = sum(sizes_list[1:], sizes_list[0])
    out_starts = dense_starts(out_sizes)
    pool_cap = sum(s.pool_cap for s in segs)
    total = out_starts[-1] + out_sizes[-1]
    rowid = owner_rows(out_starts, total, pool_cap)
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    emask = pos < total
    offset = pos - jnp.take(out_starts, rowid, mode="clip")
    # which source array does this offset fall in, and at which index
    big_values = jnp.concatenate([s.children[0].values for s in segs])
    any_validity = any(s.children[0].validity is not None for s in segs)
    big_validity = (
        jnp.concatenate(
            [s.children[0].validity_or_true() for s in segs]
        )
        if any_validity
        else None
    )
    src = jnp.zeros((pool_cap,), jnp.int32)
    chosen = jnp.zeros((pool_cap,), jnp.bool_)
    prefix_sizes = jnp.zeros((pool_cap,), jnp.int32)
    base = 0
    for s in segs:
        sz = jnp.take(s.sizes.astype(jnp.int32), rowid, mode="clip")
        st = jnp.take(s.starts.astype(jnp.int32), rowid, mode="clip")
        local = offset - prefix_sizes
        here = (~chosen) & (local < sz)
        src = jnp.where(here, base + st + local, src)
        chosen = chosen | here
        prefix_sizes = prefix_sizes + sz
        base += s.pool_cap
    values = jnp.take(big_values, src, mode="clip")
    validity = (
        None if big_validity is None else jnp.take(big_validity, src, mode="clip")
    )
    strings = next((s.children[0].strings for s in segs if s.children[0].strings), None)
    row_validity = None
    errors = None
    for r in results:
        row_validity = _and(row_validity, r.validity)
        errors = _or(errors, r.errors)
    out = SegValue(
        out_starts,
        out_sizes,
        (Elems(values, validity, elem_t, strings),),
        segs[0].dtype,
    )
    return _result(ctx, out, row_validity, errors)


def _flatten(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    outer = r.values.normalized()
    inner_elems = outer.children[0]
    assert isinstance(inner_elems.values, SegValue)
    inner: SegValue = inner_elems.values
    inner_norm = inner.normalized()  # dense by outer pool slot == by row
    out_sizes = segment_reduce(
        inner.sizes.astype(jnp.int32),
        outer.starts,
        outer.sizes,
        outer.rowid,
        outer.emask,
        "sum",
        init=0,
    )
    out = SegValue(
        dense_starts(out_sizes), out_sizes, inner_norm.children, expr.dtype
    )
    return _result(ctx, out, r.validity, r.errors)


def _array_constructor(ctx, expr: Call):
    k = len(expr.args)
    cap = ctx.capacity
    if k == 0:
        out = SegValue(
            jnp.zeros((cap,), jnp.int32),
            jnp.zeros((cap,), jnp.int32),
            (Elems(jnp.zeros((8,), expr.dtype.element.device_dtype), None, expr.dtype.element),),
            expr.dtype,
        )
        return _result(ctx, out)
    results = [ctx.evaluate(a) for a in expr.args]
    errors = None
    for r in results:
        errors = _or(errors, r.errors)
    if expr.dtype.element.is_complex:
        return _array_constructor_nested(ctx, expr, results, errors)
    values = jnp.stack([r.values for r in results], axis=1).reshape(cap * k)
    any_validity = any(r.validity is not None for r in results)
    validity = None
    if any_validity:
        validity = jnp.stack(
            [r.validity_or_true(cap) for r in results], axis=1
        ).reshape(cap * k)
    strings = None
    for a in expr.args:
        if a.dtype.is_string:
            from ...expr.compiler import _strings_of

            strings = _strings_of(a, ctx.batch)
            break
    sizes = jnp.full((cap,), k, jnp.int32)
    starts = jnp.arange(cap, dtype=jnp.int32) * k
    out = SegValue(
        starts,
        sizes,
        (Elems(values, validity, expr.dtype.element, strings),),
        expr.dtype,
    )
    return _result(ctx, out, None, errors)


def _array_constructor_nested(ctx, expr: Call, results, errors):
    """ARRAY[a, b, ...] where elements are themselves ARRAY/MAP values.

    Outer rows get k elements; the outer element pool interleaves the k
    arguments' spans, rebased onto one concatenated inner pool.
    """
    k = len(results)
    cap = ctx.capacity
    segs: List[SegValue] = [r.values for r in results]
    inner0 = segs[0].children
    for s in segs[1:]:
        for a, b in zip(inner0, s.children):
            if isinstance(a.values, SegValue) or isinstance(b.values, SegValue):
                raise NotImplementedError("ARRAY[...] nesting beyond two levels")
            if a.strings is not b.strings:
                raise TypeError("ARRAY[...]: element dictionaries must match")
    bases = []
    off = 0
    for s in segs:
        bases.append(off)
        off += s.pool_cap
    nested_starts = jnp.stack(
        [s.starts.astype(jnp.int32) + b for s, b in zip(segs, bases)], axis=1
    ).reshape(cap * k)
    nested_sizes = jnp.stack(
        [s.sizes.astype(jnp.int32) for s in segs], axis=1
    ).reshape(cap * k)
    elem_validity = None
    if any(r.validity is not None for r in results):
        elem_validity = jnp.stack(
            [r.validity_or_true(cap) for r in results], axis=1
        ).reshape(cap * k)
    new_children = []
    for ci in range(len(inner0)):
        values = jnp.concatenate([s.children[ci].values for s in segs])
        any_v = any(s.children[ci].validity is not None for s in segs)
        validity = (
            jnp.concatenate([s.children[ci].validity_or_true() for s in segs])
            if any_v
            else None
        )
        new_children.append(
            Elems(values, validity, inner0[ci].dtype, inner0[ci].strings)
        )
    inner_seg = SegValue(
        nested_starts, nested_sizes, tuple(new_children), expr.dtype.element
    )
    out = SegValue(
        jnp.arange(cap, dtype=jnp.int32) * k,
        jnp.full((cap,), k, jnp.int32),
        (Elems(inner_seg, elem_validity, expr.dtype.element),),
        expr.dtype,
    )
    return _result(ctx, out, None, errors)


def _repeat(ctx, expr: Call):
    from ...expr.ir import Constant

    count = expr.args[1]
    if not isinstance(count, Constant):
        raise NotImplementedError("repeat(x, n) needs a constant n")
    k = max(int(count.value or 0), 0)
    return _array_constructor(
        ctx, Call(expr.dtype, "array_constructor", (expr.args[0],) * k)
    )


def _aligned_values(elems_list):
    """Comparable device values across pools: strings from different
    dictionaries remap into one combined dictionary (tables are static at
    trace time, so the remap is a host array + one device gather)."""
    import numpy as np

    if not elems_list[0].dtype.is_string:
        return [e.values for e in elems_list], elems_list[0].strings
    tables = [e.strings for e in elems_list]
    if all(t is tables[0] for t in tables):
        return [e.values for e in elems_list], tables[0]
    from ...vector.string_table import StringTable

    combined = StringTable()
    out = []
    for e, t in zip(elems_list, tables):
        values = t.values() if t is not None else [""]
        remap = jnp.asarray(
            np.asarray([combined.intern(v) for v in values], np.int32)
        )
        out.append(jnp.take(remap, e.values.astype(jnp.int32), mode="clip"))
    return out, combined


def _membership(ra, rb):
    """For each element of a's pool: does b's same-row segment contain it?

    One combined sort by (row, null?, value, source) with b's elements first,
    then an inclusive segmented max of "saw b" over equal-value runs — a's
    duplicates and nulls all resolve in the same pass.  Returns
    (na, match_a[bool over a's pool]).
    """
    from ...ops.segmented import segmented_scan

    na = ra.values.normalized()
    nb = rb.values.normalized()
    ea, eb = na.children[0], nb.children[0]
    Pa, Pb = ea.pool_cap, eb.pool_cap
    big = jnp.int32(_INT_MAX)
    rid = jnp.concatenate(
        [
            jnp.where(na.emask, na.rowid, big),
            jnp.where(nb.emask, nb.rowid, big),
        ]
    )
    nullk = jnp.concatenate(
        [(~ea.validity_or_true()), (~eb.validity_or_true())]
    ).astype(jnp.int32)
    (av, bv), _ = _aligned_values([ea, eb])
    val = jnp.concatenate([av, bv.astype(av.dtype)])
    src = jnp.concatenate(
        [jnp.ones((Pa,), jnp.int32), jnp.zeros((Pb,), jnp.int32)]
    )  # b sorts first at equal keys
    pos = jnp.concatenate(
        [jnp.arange(Pa, dtype=jnp.int32), jnp.arange(Pb, dtype=jnp.int32)]
    )
    rs, ns, vs, ss, ps = jax.lax.sort([rid, nullk, val, src, pos], num_keys=4)
    prev_same = (
        (rs == jnp.roll(rs, 1))
        & (ns == jnp.roll(ns, 1))
        & (vs == jnp.roll(vs, 1))
    )
    boundary = ~prev_same
    boundary = boundary.at[0].set(True)
    from_b = (ss == 0).astype(jnp.int32)
    saw_b = segmented_scan(from_b, boundary, "max")
    # route back to a's pool positions (a slots have src=1)
    _, _, back = jax.lax.sort([1 - ss, ps, saw_b], num_keys=2)
    match_a = back[:Pa] > 0
    return na, match_a


def _first_occurrence(norm, elems):
    """keep-first dedup flags over a normalized pool (array_distinct core)."""
    pool_cap = elems.pool_cap
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    row_key = jnp.where(norm.emask, norm.rowid, jnp.int32(_INT_MAX))
    null_key = (
        (~elems.validity).astype(jnp.int32)
        if elems.validity is not None
        else jnp.zeros((pool_cap,), jnp.int32)
    )
    rk, nk, vv, ps = jax.lax.sort(
        [row_key, null_key, elems.values, pos], num_keys=3
    )
    same = (
        (rk == jnp.roll(rk, 1))
        & (nk == jnp.roll(nk, 1))
        & (vv == jnp.roll(vv, 1))
    )
    same = same.at[0].set(False)
    _, keep = jax.lax.sort([ps, (~same).astype(jnp.int32)], num_keys=1)
    return keep.astype(jnp.bool_)


def _array_setop(which: str):
    def fn(ctx, expr: Call):
        ra = _seg_arg(ctx, expr.args[0])
        rb = _seg_arg(ctx, expr.args[1])
        na, match_a = _membership(ra, rb)
        elems = na.children[0]
        row_validity = _and(ra.validity, rb.validity)
        errors = _or(ra.errors, rb.errors)
        if which == "overlap":
            args5 = (na.starts, na.sizes, na.rowid, na.emask)
            ev = elems.validity
            valid_match = match_a
            if ev is not None:
                valid_match = match_a & ev
            has = segment_any(valid_match & na.emask, *args5)
            # NULL if no definite match but a null element exists on either side
            has_null = (
                segment_any(na.emask & ~ev, *args5)
                if ev is not None
                else jnp.zeros_like(has)
            )
            validity = _and(has | ~has_null, row_validity)
            return _result(ctx, has, validity, errors)
        keep = _first_occurrence(na, elems)
        keep = keep & (match_a if which == "intersect" else ~match_a)
        pools = [elems.values]
        if elems.validity is not None:
            pools.append(elems.validity)
        starts, sizes, new_pools, rowid, emask = compact_pool(
            keep, na.starts, na.sizes, na.rowid, na.emask, tuple(pools)
        )
        validity = new_pools[1] if elems.validity is not None else None
        out = SegValue(
            starts,
            sizes,
            (Elems(new_pools[0], validity, elems.dtype, elems.strings),),
            expr.dtype,
        )
        return _result(ctx, out, row_validity, errors)

    return fn


def _row_sums(values: jax.Array, live: jax.Array, starts, sizes) -> jax.Array:
    """Per-row segment sums over a row-contiguous pool — scatter-free
    cumsum differences at [start, start+size)."""
    masked = jnp.where(live, values, 0.0)
    c = jnp.cumsum(masked)
    end = jnp.clip(starts + sizes - 1, 0, masked.shape[0] - 1)
    upper = jnp.take(c, end, mode="clip")
    lower = jnp.where(
        starts > 0, jnp.take(c, jnp.clip(starts - 1, 0, None), mode="clip"), 0.0
    )
    return jnp.where(sizes > 0, upper - lower, 0.0)


def _cosine_similarity(ctx, expr: Call):
    """cosine_similarity(map(K, double), map(K, double)) — dot product over
    matching keys / (norm_a * norm_b).  Reference: prestosql
    ArrayFunctions cosine_similarity over sparse vectors as maps.

    Matching exploits map key uniqueness: one combined sort by (row, key,
    source) places b's entry DIRECTLY before a's entry of the same key, so
    the matched value is a shift-by-one compare — no scatter, no hash.
    """
    ra = _seg_arg(ctx, expr.args[0])
    rb = _seg_arg(ctx, expr.args[1])
    na = ra.values.normalized()
    nb = rb.values.normalized()
    ka, va = na.children[0], na.children[1]
    kb, vb = nb.children[0], nb.children[1]
    Pa, Pb = ka.pool_cap, kb.pool_cap
    big = jnp.int32(_INT_MAX)
    rid = jnp.concatenate(
        [
            jnp.where(na.emask, na.rowid, big),
            jnp.where(nb.emask, nb.rowid, big),
        ]
    )
    (kav, kbv), _ = _aligned_values([ka, kb])
    key = jnp.concatenate([kav.astype(jnp.int64), kbv.astype(jnp.int64)])
    src = jnp.concatenate(
        [jnp.ones((Pa,), jnp.int32), jnp.zeros((Pb,), jnp.int32)]
    )
    val = jnp.concatenate(
        [va.values.astype(jnp.float64), vb.values.astype(jnp.float64)]
    )
    # b's pool positions sort below a's so a post-sort slice [Pb:] is a-aligned
    gpos = jnp.concatenate(
        [
            jnp.arange(Pa, dtype=jnp.int32) + Pb,
            jnp.arange(Pb, dtype=jnp.int32),
        ]
    )
    s_rid, s_key, s_src, s_val, s_pos = jax.lax.sort(
        [rid, key, src, val, gpos], num_keys=3
    )
    prev_match = (
        (s_src == 1)
        & (jnp.roll(s_src, 1) == 0)
        & (s_rid == jnp.roll(s_rid, 1))
        & (s_key == jnp.roll(s_key, 1))
    )
    prev_match = prev_match.at[0].set(False)
    prod = jnp.where(prev_match, s_val * jnp.roll(s_val, 1), 0.0)
    # route products back to a-pool order
    _, prod_by_pos = jax.lax.sort([s_pos, prod], num_keys=1)
    prod_a = prod_by_pos[Pb:]
    dot = _row_sums(prod_a, na.emask, na.starts, na.sizes)
    va_live = na.emask & va.validity_or_true()
    vb_live = nb.emask & vb.validity_or_true()
    norm_a = jnp.sqrt(
        _row_sums(va.values.astype(jnp.float64) ** 2, va_live, na.starts, na.sizes)
    )
    norm_b = jnp.sqrt(
        _row_sums(vb.values.astype(jnp.float64) ** 2, vb_live, nb.starts, nb.sizes)
    )
    out = dot / (norm_a * norm_b)
    return _result(ctx, out, _and(ra.validity, rb.validity), _or(ra.errors, rb.errors))


def _map_concat(ctx, expr: Call):
    """map_concat(m1, m2): union of entries; later maps win on key clashes
    (reference: MapConcat.cpp)."""
    from ...ops.segmented import rank_in_segments

    results = [_seg_arg(ctx, a) for a in expr.args]
    norms = [r.values.normalized() for r in results]
    cap = ctx.capacity
    big = jnp.int32(_INT_MAX)
    rid = jnp.concatenate(
        [jnp.where(n.emask, n.rowid, big) for n in norms]
    )
    key_aligned, key_table = _aligned_values([n.children[0] for n in norms])
    val_aligned, val_table = _aligned_values([n.children[1] for n in norms])
    keyv = jnp.concatenate([k.astype(jnp.int64) for k in key_aligned])
    # later maps sort first at equal keys so their entry survives the dedup
    src = jnp.concatenate(
        [
            jnp.full((n.children[0].pool_cap,), len(norms) - i, jnp.int32)
            for i, n in enumerate(norms)
        ]
    )
    vals = jnp.concatenate(
        [v.astype(val_aligned[0].dtype) for v in val_aligned]
    )
    vvalid = jnp.concatenate(
        [n.children[1].validity_or_true() for n in norms]
    )
    ops = [rid, keyv, src, vals, vvalid.astype(jnp.int8)]
    rs, ks, ss, vs, vv = jax.lax.sort(ops, num_keys=3)
    dup = (rs == jnp.roll(rs, 1)) & (ks == jnp.roll(ks, 1))
    dup = dup.at[0].set(False)
    keep = ~dup & (rs != big)
    # stable partition keeps (row, key) order; pool is then normalized
    perm = jnp.argsort(~keep, stable=True).astype(jnp.int32)
    total = jnp.sum(keep.astype(jnp.int32))
    kk = jnp.take(ks, perm, mode="clip")
    kv = jnp.take(vs, perm, mode="clip")
    kvv = jnp.take(vv, perm, mode="clip").astype(jnp.bool_)
    kr = jnp.take(rs, perm, mode="clip")
    # dropped slots (beyond the kept prefix) must not count toward any row
    pool_total = kr.shape[0]
    kr = jnp.where(
        jnp.arange(pool_total, dtype=jnp.int32) < total, kr, big
    )
    # per-row sizes: kept entries with row <= r, differenced
    upto = rank_in_segments(
        jnp.zeros((pool_total,), jnp.int64),
        kr.astype(jnp.int64),
        jnp.zeros((cap,), jnp.int64),
        jnp.arange(cap, dtype=jnp.int64),
        inclusive=True,
    )
    prev = jnp.concatenate([jnp.zeros((1,), upto.dtype), upto[:-1]])
    sizes = (upto - prev).astype(jnp.int32)
    key_t = expr.dtype.key_type
    val_t = expr.dtype.value_type
    row_validity = None
    errors = None
    for r in results:
        row_validity = _and(row_validity, r.validity)
        errors = _or(errors, r.errors)
    out = SegValue(
        dense_starts(sizes),
        sizes,
        (
            Elems(kk.astype(key_t.device_dtype), None, key_t, key_table),
            Elems(kv, kvv, val_t, val_table),
        ),
        expr.dtype,
    )
    return _result(ctx, out, row_validity, errors)


def _split(ctx, expr: Call):
    """split(s, delim) -> array(varchar) (reference: SplitFunctions.cpp).

    The string dictionary is static at trace time: each distinct value splits
    once on the host into a shared parts pool; per-row spans then expand into
    a dense pool sized capacity x longest-split (static)."""
    import numpy as np

    from ...expr.compiler import _strings_of
    from ...expr.ir import Constant
    from ...vector.string_table import StringTable

    s = ctx.evaluate(expr.args[0])
    delim_e = expr.args[1]
    if not isinstance(delim_e, Constant) or not isinstance(delim_e.value, str):
        raise TypeError("split() needs a literal delimiter")
    table = _strings_of(expr.args[0], ctx.batch)
    if table is None:
        raise TypeError("split() requires a dictionary-backed string input")
    # reuse the bind-time parts dictionary when present (expr.ir.StringsCall)
    # so static provenance and the traced program agree on codes; intern() is
    # deterministic, so re-filling it here yields identical codes
    out_table = getattr(expr, "strings", None) or StringTable()
    code_starts, code_sizes, pool_codes = [], [], []
    for v in table.values():
        parts = v.split(delim_e.value) if v else []
        code_starts.append(len(pool_codes))
        code_sizes.append(len(parts))
        pool_codes.extend(out_table.intern(p) for p in parts)
    max_parts = max(code_sizes, default=0)
    cap = ctx.capacity
    if cap * max(max_parts, 1) > (1 << 26):
        raise NotImplementedError(
            "split(): dictionary has very long splits; output pool too large"
        )
    cs = jnp.asarray(np.asarray(code_starts, np.int32))
    cz = jnp.asarray(np.asarray(code_sizes, np.int32))
    pool = jnp.asarray(np.asarray(pool_codes or [0], np.int32))
    codes = s.values.astype(jnp.int32)
    sizes = jnp.take(cz, codes, mode="clip")
    if s.validity is not None:
        sizes = jnp.where(s.validity, sizes, 0)
    out_starts = dense_starts(sizes)
    pool_cap = max(_next_pow2(cap * max(max_parts, 1)), 8)
    total = out_starts[-1] + sizes[-1]
    rowid = owner_rows(out_starts, total, pool_cap)
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    emask = pos < total
    offset = pos - jnp.take(out_starts, rowid, mode="clip")
    src = jnp.take(cs, jnp.take(codes, rowid, mode="clip"), mode="clip") + offset
    values = jnp.take(pool, jnp.clip(src, 0, pool.shape[0] - 1), mode="clip")
    out = SegValue(
        out_starts,
        sizes,
        (Elems(values, None, expr.dtype.element, out_table),),
        expr.dtype,
    )
    return _result(ctx, out, s.validity, s.errors)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _sequence(ctx, expr: Call):
    """sequence(lo, hi) with literal bounds -> per-row constant array."""
    from ...expr.ir import Constant

    lo_e, hi_e = expr.args[0], expr.args[1]
    if not (isinstance(lo_e, Constant) and isinstance(hi_e, Constant)):
        raise NotImplementedError("sequence() needs literal bounds here")
    lo, hi = int(lo_e.value), int(hi_e.value)
    step = 1 if hi >= lo else -1
    values = list(range(lo, hi + step, step))
    if len(values) > 10000:
        raise ValueError("sequence exceeds 10000 entries (Presto's cap)")
    elems = tuple(Constant(lo_e.dtype, v) for v in values)
    return _array_constructor(
        ctx, Call(expr.dtype, "array_constructor", elems)
    )


def _array_join_gate(ctx, expr: Call):
    """array_join is lowered by the string-construction plan rewrite
    (exec/strcast.py) when it is a top-level projected output; any other
    position needs the joined string's VALUE on device, which has no
    dictionary form.  Reference: ArrayJoin in
    velox/functions/prestosql/ArrayFunctions."""
    raise NotImplementedError(
        "array_join builds a data-dependent string; supported only as a "
        "top-level projected output column (rendered at materialization) — "
        "ROADMAP.md"
    )


def _row_constructor(ctx, expr: Call):
    """row(a, b, ...) -> ROW value (reference: RowConstructor.cpp)."""
    from ...expr.seg import StructValue

    results = [ctx.evaluate(a) for a in expr.args]
    errors = None
    fields = []
    for a, r in zip(expr.args, results):
        errors = _or(errors, r.errors)
        strings = None
        if a.dtype.is_string:
            from ...expr.compiler import _strings_of

            strings = _strings_of(a, ctx.batch)
        fields.append(Elems(r.values, r.validity, a.dtype, strings))
    return _result(ctx, StructValue(tuple(fields), expr.dtype), None, errors)


def _row_field(ctx, expr: Call):
    """r.name / subscript(ROW, 'name') field access (reference:
    FieldReference.cpp dereference on ROW inputs)."""
    from ...expr.ir import Constant

    r = ctx.evaluate(expr.args[0])
    assert isinstance(expr.args[1], Constant)
    el = r.values.field(expr.args[1].value)
    validity = _and(el.validity, r.validity)
    return _result(ctx, el.values, validity, r.errors, strings=el.strings)


def _map_zip_with(ctx, expr: Call):
    """map_zip_with(m1, m2, (k, v1, v2) -> e): union of keys; absent side's
    value is NULL (reference: MapZipWithFunction.cpp)."""
    from ...ops.segmented import rank_in_segments

    r1 = _seg_arg(ctx, expr.args[0])
    r2 = _seg_arg(ctx, expr.args[1])
    lam: Lambda = expr.args[2]
    norms = [r1.values.normalized(), r2.values.normalized()]
    cap = ctx.capacity
    big = jnp.int32(_INT_MAX)
    rid = jnp.concatenate([jnp.where(n.emask, n.rowid, big) for n in norms])
    key_aligned, key_table = _aligned_values([n.children[0] for n in norms])
    keyv = jnp.concatenate([k.astype(jnp.int64) for k in key_aligned])
    src = jnp.concatenate(
        [
            jnp.zeros((norms[0].children[0].pool_cap,), jnp.int32),
            jnp.ones((norms[1].children[0].pool_cap,), jnp.int32),
        ]
    )
    v1_all = jnp.concatenate(
        [
            norms[0].children[1].values,
            jnp.zeros(
                (norms[1].children[1].pool_cap,),
                norms[0].children[1].values.dtype,
            ),
        ]
    )
    v2_all = jnp.concatenate(
        [
            jnp.zeros(
                (norms[0].children[1].pool_cap,),
                norms[1].children[1].values.dtype,
            ),
            norms[1].children[1].values,
        ]
    )
    val1_ok = jnp.concatenate(
        [
            norms[0].children[1].validity_or_true(),
            jnp.zeros((norms[1].children[1].pool_cap,), jnp.bool_),
        ]
    )
    val2_ok = jnp.concatenate(
        [
            jnp.zeros((norms[0].children[1].pool_cap,), jnp.bool_),
            norms[1].children[1].validity_or_true(),
        ]
    )
    rs, ks, ss, w1, w2, o1, o2 = jax.lax.sort(
        [rid, keyv, src, v1_all, v2_all, val1_ok.astype(jnp.int8),
         val2_ok.astype(jnp.int8)],
        num_keys=3,
    )
    # a (row, key) run has at most 2 entries (keys unique per map; m1 first)
    nxt_same = (
        (rs == jnp.roll(rs, -1)) & (ks == jnp.roll(ks, -1))
    )
    nxt_same = nxt_same.at[-1].set(False)
    dup = (rs == jnp.roll(rs, 1)) & (ks == jnp.roll(ks, 1))
    dup = dup.at[0].set(False)
    keep = ~dup & (rs != big)
    v1 = jnp.where(ss == 0, w1, 0)
    v1ok = jnp.where(ss == 0, o1.astype(jnp.bool_), False)
    v2 = jnp.where(
        ss == 1, w2, jnp.where(nxt_same, jnp.roll(w2, -1), 0)
    )
    v2ok = jnp.where(
        ss == 1,
        o2.astype(jnp.bool_),
        jnp.where(nxt_same, jnp.roll(o2, -1).astype(jnp.bool_), False),
    )
    # compact kept entries to a dense row-ordered pool
    perm = jnp.argsort(~keep, stable=True).astype(jnp.int32)
    total = jnp.sum(keep.astype(jnp.int32))
    pool_total = rs.shape[0]
    take = lambda a: jnp.take(a, perm, mode="clip")  # noqa: E731
    kk, kr = take(ks), take(rs)
    kv1, kv1ok, kv2, kv2ok = take(v1), take(v1ok), take(v2), take(v2ok)
    kr = jnp.where(jnp.arange(pool_total, dtype=jnp.int32) < total, kr, big)
    upto = rank_in_segments(
        jnp.zeros((pool_total,), jnp.int64),
        kr.astype(jnp.int64),
        jnp.zeros((cap,), jnp.int64),
        jnp.arange(cap, dtype=jnp.int64),
        inclusive=True,
    )
    prev = jnp.concatenate([jnp.zeros((1,), upto.dtype), upto[:-1]])
    sizes = (upto - prev).astype(jnp.int32)
    starts = dense_starts(sizes)
    rowid = jnp.where(kr == big, cap, kr).astype(jnp.int32)
    key_t = expr.dtype.key_type
    k_el = Elems(
        kk.astype(key_t.device_dtype), None, key_t, key_table
    )
    v1t = expr.args[0].dtype.value_type
    v2t = expr.args[1].dtype.value_type
    body = _eval_lambda(
        ctx,
        lam,
        [
            k_el,
            Elems(kv1.astype(v1t.device_dtype), kv1ok, v1t,
                  norms[0].children[1].strings),
            Elems(kv2.astype(v2t.device_dtype), kv2ok, v2t,
                  norms[1].children[1].strings),
        ],
        pool_total,
        jnp.clip(rowid, 0, cap - 1),
    )
    row_validity = _and(r1.validity, r2.validity)
    errors = _or(r1.errors, r2.errors)
    emask = jnp.arange(pool_total, dtype=jnp.int32) < total
    if body.errors is not None:
        err_rows = segment_reduce(
            (body.errors & emask).astype(jnp.int32),
            starts, sizes,
            jnp.clip(rowid, 0, cap - 1),
            emask, "sum", init=0,
        )
        errors = _or(errors, err_rows > 0)
    out = SegValue(
        starts,
        sizes,
        (
            k_el,
            Elems(body.values, body.validity, lam.dtype, _body_strings(ctx, lam)),
        ),
        expr.dtype,
    )
    return _result(ctx, out, row_validity, errors)


def _spark_size(ctx, expr: Call):
    """Spark legacy size(): -1 for NULL input (sparksql/Size.cpp)."""
    r = ctx.evaluate(expr.args[0])
    seg = r.values
    sizes = seg.sizes.astype(jnp.int64)
    if r.validity is not None:
        sizes = jnp.where(r.validity, sizes, jnp.int64(-1))
    return _result(ctx, sizes, None, r.errors)


def _map_keys(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    seg = r.values
    out = SegValue(seg.starts, seg.sizes, (seg.children[0],), expr.dtype)
    return _result(ctx, out, r.validity, r.errors)


def _map_values(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    seg = r.values
    out = SegValue(seg.starts, seg.sizes, (seg.children[1],), expr.dtype)
    return _result(ctx, out, r.validity, r.errors)


def _map_constructor(ctx, expr: Call):
    ka = _seg_arg(ctx, expr.args[0])
    va = _seg_arg(ctx, expr.args[1])
    kn = ka.values.normalized()
    vn = va.values.normalized()
    mismatch = kn.sizes != vn.sizes
    row_validity = _and(ka.validity, va.validity)
    if row_validity is not None:
        mismatch = mismatch & row_validity
    errors = _or(_or(ka.errors, va.errors), mismatch)
    kp = kn.children[0].pool_cap
    vp = vn.children[0].pool_cap
    if kp != vp:
        # align pool capacities by padding the smaller one
        k_el, v_el = kn.children[0], vn.children[0]
        width = max(kp, vp)
        k_el = _pad_elems(k_el, width)
        v_el = _pad_elems(v_el, width)
    else:
        k_el, v_el = kn.children[0], vn.children[0]
    out = SegValue(kn.starts, kn.sizes, (k_el, v_el), expr.dtype)
    return _result(ctx, out, row_validity, errors)


def _pad_elems(el: Elems, width: int) -> Elems:
    cur = el.pool_cap
    if cur >= width:
        return el
    pad = width - cur
    values = jnp.concatenate([el.values, jnp.zeros((pad,), el.values.dtype)])
    validity = (
        None
        if el.validity is None
        else jnp.concatenate([el.validity, jnp.zeros((pad,), jnp.bool_)])
    )
    return Elems(values, validity, el.dtype, el.strings)


# ---------------------------------------------------------------------------
# higher-order (lambda) functions


def _transform(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    lam: Lambda = expr.args[1]
    norm = r.values.normalized()
    elems = norm.children[0]
    body = _eval_lambda(ctx, lam, [elems], elems.pool_cap, norm.rowid)
    errors = r.errors
    if body.errors is not None:
        row_err = segment_any(
            body.errors & norm.emask, norm.starts, norm.sizes, norm.rowid, norm.emask
        )
        errors = _or(errors, row_err)
    out = SegValue(
        norm.starts,
        norm.sizes,
        (Elems(body.values, body.validity, lam.dtype, _body_strings(ctx, lam)),),
        expr.dtype,
    )
    return _result(ctx, out, r.validity, errors)


def _body_strings(ctx, lam: Lambda):
    if not lam.dtype.is_string:
        return None
    from ...expr.compiler import _strings_of

    return _strings_of(lam.body, ctx.batch)


def _filter(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    lam: Lambda = expr.args[1]
    norm = r.values.normalized()
    elems = norm.children[0]
    body = _eval_lambda(ctx, lam, [elems], elems.pool_cap, norm.rowid)
    keep = body.values.astype(jnp.bool_)
    if body.validity is not None:
        keep = keep & body.validity
    errors = r.errors
    if body.errors is not None:
        row_err = segment_any(
            body.errors & norm.emask, norm.starts, norm.sizes, norm.rowid, norm.emask
        )
        errors = _or(errors, row_err)
    pools = [elems.values]
    if elems.validity is not None:
        pools.append(elems.validity)
    starts, sizes, new_pools, rowid, emask = compact_pool(
        keep, norm.starts, norm.sizes, norm.rowid, norm.emask, tuple(pools)
    )
    validity = new_pools[1] if elems.validity is not None else None
    out = SegValue(
        starts,
        sizes,
        (Elems(new_pools[0], validity, elems.dtype, elems.strings),),
        expr.dtype,
    )
    return _result(ctx, out, r.validity, errors)


def _match(kind: str):
    def fn(ctx, expr: Call):
        r = _seg_arg(ctx, expr.args[0])
        lam: Lambda = expr.args[1]
        norm = r.values.normalized()
        elems = norm.children[0]
        body = _eval_lambda(ctx, lam, [elems], elems.pool_cap, norm.rowid)
        v = body.values.astype(jnp.bool_)
        valid = (
            body.validity
            if body.validity is not None
            else jnp.ones_like(v)
        )
        args5 = (norm.starts, norm.sizes, norm.rowid, norm.emask)
        exists_true = segment_any(v & valid, *args5)
        exists_false = segment_any(~v & valid, *args5)
        has_null = segment_any(~valid & norm.emask, *args5)
        # Kleene over the element set: a deciding element wins; otherwise a
        # null lambda result makes the answer NULL
        if kind == "any":
            hit, decided = exists_true, exists_true
        elif kind == "all":
            hit, decided = ~exists_false, exists_false
        else:  # none
            hit, decided = ~exists_true, exists_true
        validity = decided | ~has_null
        validity = _and(validity, r.validity)
        errors = r.errors
        if body.errors is not None:
            errors = _or(
                errors, segment_any(body.errors & norm.emask, *args5)
            )
        return _result(ctx, hit, validity, errors)

    return fn


def _reduce(ctx, expr: Call):
    """reduce(array(T), S, (S, T) -> S, S -> R): while_loop over offsets."""
    r = _seg_arg(ctx, expr.args[0])
    init = ctx.evaluate(expr.args[1])
    merge: Lambda = expr.args[2]
    final: Optional[Lambda] = expr.args[3] if len(expr.args) > 3 else None
    seg: SegValue = r.values
    elems = seg.children[0]
    cap = ctx.capacity
    starts = seg.starts.astype(jnp.int32)
    sizes = seg.sizes.astype(jnp.int32)
    max_size = jnp.max(sizes)
    state_t = expr.args[1].dtype

    init_validity = init.validity_or_true(cap)
    err0 = jnp.zeros((cap,), jnp.bool_)

    def cond(carry):
        j = carry[0]
        return j < max_size

    def body(carry):
        j, state, state_valid, err = carry
        idx = jnp.clip(starts + j, 0, elems.pool_cap - 1)
        ev = jnp.take(elems.values, idx, axis=0, mode="clip")
        evalid = elems.validity_or_true()
        e_val = jnp.take(evalid, idx, mode="clip")
        active = j < sizes
        out = _eval_lambda(
            ctx,
            merge,
            [
                Elems(state, state_valid, state_t),
                Elems(ev, e_val, elems.dtype, elems.strings),
            ],
            cap,
            None,
        )
        new_state = jnp.where(active, out.values, state)
        nv = out.validity_or_true(cap)
        new_valid = jnp.where(active, nv, state_valid)
        if out.errors is not None:
            err = err | (out.errors & active)
        return (j + 1, new_state, new_valid, err)

    _, state, state_valid, err = jax.lax.while_loop(
        cond, body, (jnp.int32(0), init.values, init_validity, err0)
    )
    errors = _or(_or(r.errors, init.errors), err)
    if final is not None:
        out = _eval_lambda(
            ctx, final, [Elems(state, state_valid, state_t)], cap, None
        )
        state, state_valid = out.values, out.validity_or_true(cap)
        if out.errors is not None:
            errors = _or(errors, out.errors)
    validity = _and(state_valid, r.validity)
    return _result(ctx, state, validity, errors)


def _zip_with(ctx, expr: Call):
    ra = _seg_arg(ctx, expr.args[0])
    rb = _seg_arg(ctx, expr.args[1])
    lam: Lambda = expr.args[2]
    a: SegValue = ra.values
    b: SegValue = rb.values
    sa = a.sizes.astype(jnp.int32)
    sb = b.sizes.astype(jnp.int32)
    out_sizes = jnp.maximum(sa, sb)
    out_starts = dense_starts(out_sizes)
    pool_cap = a.pool_cap + b.pool_cap
    total = out_starts[-1] + out_sizes[-1]
    rowid = owner_rows(out_starts, total, pool_cap)
    pos = jnp.arange(pool_cap, dtype=jnp.int32)
    emask = pos < total
    offset = pos - jnp.take(out_starts, rowid, mode="clip")

    def pick(seg: SegValue, sz):
        st = jnp.take(seg.starts.astype(jnp.int32), rowid, mode="clip")
        within = offset < jnp.take(sz, rowid, mode="clip")
        idx = jnp.clip(st + offset, 0, seg.pool_cap - 1)
        el = seg.children[0]
        v = jnp.take(el.values, idx, axis=0, mode="clip")
        valid = jnp.take(el.validity_or_true(), idx, mode="clip") & within
        return Elems(v, valid, el.dtype, el.strings)

    ea = pick(a, sa)
    eb = pick(b, sb)
    body = _eval_lambda(ctx, lam, [ea, eb], pool_cap, rowid)
    errors = _or(ra.errors, rb.errors)
    if body.errors is not None:
        err_rows = segment_reduce(
            (body.errors & emask).astype(jnp.int32),
            out_starts,
            out_sizes,
            rowid,
            emask,
            "sum",
            init=0,
        )
        errors = _or(errors, err_rows > 0)
    out = SegValue(
        out_starts,
        out_sizes,
        (Elems(body.values, body.validity, lam.dtype, _body_strings(ctx, lam)),),
        expr.dtype,
    )
    return _result(ctx, out, _and(ra.validity, rb.validity), errors)


def _map_filter(ctx, expr: Call):
    r = _seg_arg(ctx, expr.args[0])
    lam: Lambda = expr.args[1]
    norm = r.values.normalized()
    keys, vals = norm.children
    body = _eval_lambda(ctx, lam, [keys, vals], keys.pool_cap, norm.rowid)
    keep = body.values.astype(jnp.bool_)
    if body.validity is not None:
        keep = keep & body.validity
    pools = [keys.values, vals.values, keys.validity_or_true(), vals.validity_or_true()]
    starts, sizes, new_pools, rowid, emask = compact_pool(
        keep, norm.starts, norm.sizes, norm.rowid, norm.emask, tuple(pools)
    )
    errors = r.errors
    if body.errors is not None:
        errors = _or(
            errors,
            segment_any(
                body.errors & norm.emask,
                norm.starts,
                norm.sizes,
                norm.rowid,
                norm.emask,
            ),
        )
    out = SegValue(
        starts,
        sizes,
        (
            Elems(new_pools[0], new_pools[2], keys.dtype, keys.strings),
            Elems(new_pools[1], new_pools[3], vals.dtype, vals.strings),
        ),
        expr.dtype,
    )
    return _result(ctx, out, r.validity, errors)


def _transform_map(which: str):
    def fn(ctx, expr: Call):
        r = _seg_arg(ctx, expr.args[0])
        lam: Lambda = expr.args[1]
        norm = r.values.normalized()
        keys, vals = norm.children
        body = _eval_lambda(ctx, lam, [keys, vals], keys.pool_cap, norm.rowid)
        new_el = Elems(
            body.values, body.validity, lam.dtype, _body_strings(ctx, lam)
        )
        children = (
            (new_el, vals) if which == "keys" else (keys, new_el)
        )
        errors = r.errors
        if body.errors is not None:
            errors = _or(
                errors,
                segment_any(
                    body.errors & norm.emask,
                    norm.starts,
                    norm.sizes,
                    norm.rowid,
                    norm.emask,
                ),
            )
        out = SegValue(norm.starts, norm.sizes, children, expr.dtype)
        return _result(ctx, out, r.validity, errors)

    return fn


# ---------------------------------------------------------------------------
# dispatch table + type-resolution signatures

COMPLEX_FNS: Dict[str, Callable] = {
    "cardinality": _cardinality,
    "subscript": _subscript,
    "element_at": _element_at,
    "contains": _contains,
    "array_position": _array_position,
    "array_min": _array_minmax("min"),
    "array_max": _array_minmax("max"),
    "array_sum": _array_sum,
    "array_sort": _array_sort,
    "array_sort_desc": _array_sort_desc,
    "array_distinct": _array_distinct,
    "array_union": _array_union,
    "array_normalize": _array_normalize,
    "slice": _slice,
    "reverse": _reverse,
    "concat": _concat_arrays,
    "flatten": _flatten,
    "array_constructor": _array_constructor,
    "repeat": _repeat,
    "map_keys": _map_keys,
    "map_values": _map_values,
    "map": _map_constructor,
    "transform": _transform,
    "filter": _filter,
    "any_match": _match("any"),
    "all_match": _match("all"),
    "none_match": _match("none"),
    "reduce": _reduce,
    "zip_with": _zip_with,
    "map_filter": _map_filter,
    "map_zip_with": _map_zip_with,
    "transform_keys": _transform_map("keys"),
    "transform_values": _transform_map("values"),
    "array_intersect": _array_setop("intersect"),
    "array_except": _array_setop("except"),
    "arrays_overlap": _array_setop("overlap"),
    "map_concat": _map_concat,
    "cosine_similarity": _cosine_similarity,
    "array_join": _array_join_gate,
    "row": _row_constructor,
    "row_field": _row_field,
    "split": _split,
    "sequence": _sequence,
    # Spark package (velox/functions/sparksql): aliases + legacy size()
    "size": _spark_size,
    "array_contains": _contains,
    "sort_array": _array_sort,
    "array": _array_constructor,        # Spark's call-form constructor
    "aggregate": _reduce,               # Spark name for reduce()
    "map_from_arrays": _map_constructor,  # same shape as Presto map(k, v)
}


def is_complex_call(name: str, args) -> bool:
    if name not in COMPLEX_FNS:
        return False
    if name in ("array_constructor", "array", "row", "split", "sequence"):
        return True
    return any(
        a.dtype.is_complex or isinstance(a, Lambda) for a in args
    )


# ---- registry entries (type resolution only) ------------------------------

_A = TypeKind.ARRAY
_M = TypeKind.MAP


def _stub(*_a, **_k):  # pragma: no cover
    raise RuntimeError("complex functions are dispatched by the compiler")


def _elem_type(ts):
    return ts[0].element


def _value_type(ts):
    return ts[0].value_type


def _register_all():
    reg = DEFAULT_REGISTRY
    reg.register("cardinality", [_A], BIGINT, _stub)
    reg.register("cardinality", [_M], BIGINT, _stub)
    reg.register("subscript", [_A, INT_M], _elem_type, _stub)
    reg.register("subscript", [_M, ANY], _value_type, _stub)
    reg.register("element_at", [_A, INT_M], _elem_type, _stub)
    reg.register("element_at", [_M, ANY], _value_type, _stub)
    reg.register("contains", [_A, ANY], BOOLEAN, _stub)
    reg.register("array_position", [_A, ANY], BIGINT, _stub)
    reg.register("array_min", [_A], _elem_type, _stub)
    reg.register("array_max", [_A], _elem_type, _stub)
    reg.register(
        "array_sum",
        [_A],
        lambda ts: BIGINT if ts[0].element.is_integer else ts[0].element,
        _stub,
    )
    reg.register("array_sort", [_A], lambda ts: ts[0], _stub)
    reg.register("array_sort_desc", [_A], lambda ts: ts[0], _stub)
    reg.register("array_distinct", [_A], lambda ts: ts[0], _stub)
    reg.register("array_union", [_A, _A], lambda ts: ts[0], _stub)
    reg.register(
        "array_normalize", [_A, NUMERIC], lambda ts: array_t(DOUBLE), _stub
    )
    reg.register("slice", [_A, INT_M, INT_M], lambda ts: ts[0], _stub)
    reg.register("reverse", [_A], lambda ts: ts[0], _stub)
    reg.register("concat", [_A, _A], lambda ts: ts[0], _stub, variadic=True)
    reg.register("flatten", [_A], lambda ts: ts[0].element, _stub)
    reg.register("repeat", [ANY, INT_M], lambda ts: array_t(ts[0]), _stub)
    reg.register("map_keys", [_M], lambda ts: array_t(ts[0].key_type), _stub)
    reg.register("map_values", [_M], lambda ts: array_t(ts[0].value_type), _stub)
    reg.register(
        "map",
        [_A, _A],
        lambda ts: map_t(ts[0].element, ts[1].element),
        _stub,
    )
    reg.register("cosine_similarity", [_M, _M], DOUBLE, _stub)
    from ...dtypes import VARCHAR as _VC_

    reg.register("array_join", [_A, TypeKind.VARCHAR], _VC_, _stub)
    reg.register(
        "array_join", [_A, TypeKind.VARCHAR, TypeKind.VARCHAR], _VC_, _stub
    )
    # lambda-taking functions: the lambda arg matches ANY (its dtype is the
    # body's result type)
    reg.register(
        "transform", [_A, ANY], lambda ts: array_t(ts[1]), _stub
    )
    reg.register("filter", [_A, ANY], lambda ts: ts[0], _stub)
    reg.register("any_match", [_A, ANY], BOOLEAN, _stub)
    reg.register("all_match", [_A, ANY], BOOLEAN, _stub)
    reg.register("none_match", [_A, ANY], BOOLEAN, _stub)
    reg.register("reduce", [_A, ANY, ANY], lambda ts: ts[1], _stub)
    reg.register("reduce", [_A, ANY, ANY, ANY], lambda ts: ts[3], _stub)
    # Spark names (sparksql/Register.cpp): array(...), aggregate, map_from_arrays
    reg.register(
        "array", [ANY], lambda ts: array_t(ts[0] if ts else BIGINT), _stub,
        variadic=True,
    )
    reg.register("aggregate", [_A, ANY, ANY], lambda ts: ts[1], _stub)
    reg.register("aggregate", [_A, ANY, ANY, ANY], lambda ts: ts[3], _stub)
    reg.register(
        "map_from_arrays",
        [_A, _A],
        lambda ts: map_t(ts[0].element, ts[1].element),
        _stub,
    )
    reg.register(
        "zip_with", [_A, _A, ANY], lambda ts: array_t(ts[2]), _stub
    )
    reg.register("map_filter", [_M, ANY], lambda ts: ts[0], _stub)
    reg.register(
        "map_zip_with",
        [_M, _M, ANY],
        lambda ts: map_t(ts[0].key_type, ts[2]),
        _stub,
    )
    reg.register(
        "transform_keys",
        [_M, ANY],
        lambda ts: map_t(ts[1], ts[0].value_type),
        _stub,
    )
    reg.register(
        "transform_values",
        [_M, ANY],
        lambda ts: map_t(ts[0].key_type, ts[1]),
        _stub,
    )
    reg.register("array_intersect", [_A, _A], lambda ts: ts[0], _stub)
    reg.register("array_except", [_A, _A], lambda ts: ts[0], _stub)
    reg.register("arrays_overlap", [_A, _A], BOOLEAN, _stub)
    reg.register("map_concat", [_M, _M], lambda ts: ts[0], _stub, variadic=True)
    from ...dtypes import VARCHAR as _VC, row as row_t
    from ...expr.registry import INTEGER as _INT, STRINGY as _STR

    reg.register("split", [_STR, _STR], array_t(_VC), _stub)
    reg.register(
        "sequence", [_INT, _INT], lambda ts: array_t(ts[0]), _stub
    )
    reg.register(
        "row",
        [ANY],
        lambda ts: row_t([f"f{i}" for i in range(len(ts))], list(ts)),
        _stub,
        variadic=True,
    )
    # Spark package
    reg.register("size", [_A], BIGINT, _stub)
    reg.register("size", [_M], BIGINT, _stub)
    reg.register("array_contains", [_A, ANY], BOOLEAN, _stub)
    reg.register("sort_array", [_A], lambda ts: ts[0], _stub)


_register_all()
