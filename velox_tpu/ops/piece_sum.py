"""Exact grouped sums of products of narrow integer columns, in int32.

The array-mode aggregation update of Q1-shaped plans (exec/runner.py
``try_enable_piece_path``): every aggregate is sum/avg/count over a product
of affine transforms of scan columns with proven bounds.  Each product is
split into int32 "pieces" (``plan_spec``): a piece stays below 2^17, so a
512-row block's masked partial per (group, piece) is below 2^26 and exact in
int32; the small (blocks, groups) partials are then summed in int64 and the
pieces shifted back together.  All per-element arithmetic is int32 over the
raw bounds-narrowed device columns (io/table.py Table.tile ships
int8/16/32), and the whole update is ONE variadic XLA reduce.

Reference counterpart: single-pass accumulator updates over group pointers,
velox/exec/GroupingSet.cpp:294.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PIECE_MAX = (1 << 17) - 1  # a 512-row block partial stays < 2^26
_I32_MAX = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class Factor:
    """One affine factor scale*col + offset with proven value bounds."""

    col: int  # index into the column operands
    scale: int
    offset: int
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class SpecPlan:
    """Piece decomposition of sum(prod of factors) for one accumulator.

    The first ``n_prefix`` factors multiply into an int32 prefix (every
    cumulative bound < 2^31); the rest multiply into an int32 ``rest``
    term.  If the full product exceeds PIECE_MAX the prefix is split into
    ``n_chunks`` chunks of ``chunk_w`` bits, each multiplied by ``rest``.
    An empty factor list is the count spec (piece = 1 per live row)."""

    factors: Tuple[Factor, ...]
    n_prefix: int
    chunk_w: int
    n_chunks: int


def plan_spec(factors: Sequence[Factor]) -> Optional[SpecPlan]:
    """Decompose one sum spec; None when the bounds cannot prove an exact
    int32 lowering (negative values, > 2^31 partials, chunk width < 1)."""
    if not factors:
        return SpecPlan((), 0, 0, 1)
    for f in factors:
        if f.lo < 0 or f.hi < 0 or f.hi > _I32_MAX:
            return None
    prefix_bound, k = 1, 0
    for f in factors:
        nxt = prefix_bound * max(f.hi, 1)
        if nxt > _I32_MAX and k > 0:
            break
        if nxt > _I32_MAX:
            return None  # a single factor overflowing int32
        prefix_bound, k = nxt, k + 1
    rest_bound = 1
    for f in factors[k:]:
        rest_bound *= max(f.hi, 1)
        if rest_bound > _I32_MAX:
            return None
    if prefix_bound * rest_bound <= PIECE_MAX:
        return SpecPlan(tuple(factors), k, 0, 1)
    w = int(np.floor(np.log2(PIECE_MAX / max(rest_bound, 1))))
    if w < 1:
        return None
    n_chunks = (int(prefix_bound).bit_length() + w - 1) // w
    return SpecPlan(tuple(factors), k, w, n_chunks)


def _pieces_per_spec(plan: SpecPlan) -> int:
    return plan.n_chunks


def _pieces_2d(xs, plan: SpecPlan):
    """Int32 piece arrays for one spec over 2-D (nb, block) int32 columns.
    Returns [(array, shift)] — sum(spec) = sum over pieces of S(piece)<<shift."""
    if not plan.factors:
        return [(None, 0)]  # ones
    f0 = plan.factors[0]
    prefix = xs[f0.col] * jnp.int32(f0.scale) + jnp.int32(f0.offset)
    for f in plan.factors[1 : plan.n_prefix]:
        prefix = prefix * (xs[f.col] * jnp.int32(f.scale) + jnp.int32(f.offset))
    rest = None
    for f in plan.factors[plan.n_prefix :]:
        rv = xs[f.col] * jnp.int32(f.scale) + jnp.int32(f.offset)
        rest = rv if rest is None else rest * rv
    if plan.n_chunks == 1:
        piece = prefix if rest is None else prefix * rest
        return [(piece, 0)]
    m = jnp.int32((1 << plan.chunk_w) - 1)
    out = []
    for c in range(plan.n_chunks):
        chunk = (prefix >> jnp.int32(plan.chunk_w * c)) & m
        if rest is not None:
            chunk = chunk * rest
        out.append((chunk, plan.chunk_w * c))
    return out


@functools.partial(
    jax.jit, static_argnames=("plans", "num_groups", "block")
)
def grouped_piece_sums_xla(
    cols: Tuple[jax.Array, ...],
    gid_live: jax.Array,
    plans: Tuple[SpecPlan, ...],
    num_groups: int,
    block: int = 512,
) -> List[jax.Array]:
    """Per-group int64 sums for every spec in ``plans``, as ONE variadic
    int32 XLA reduce.

    cols: narrow integer columns (int8/16/32), shape (N,), N a multiple of
    ``block``.  gid_live: group id per row, -1 for dead rows (mask folded
    in).  Two-level: per block, per (group, piece) an int32 masked partial
    (piece <= 2^17-1, block partial <= 2^26 — no overflow); the small
    (nb, G) partials then sum in int64.  Returns one (num_groups,) int64
    array per spec."""
    n = gid_live.shape[0]
    assert n % block == 0, (n, block)
    nb = n // block
    xs = [c.astype(jnp.int32).reshape(nb, block) for c in cols]
    gid = gid_live.astype(jnp.int32).reshape(nb, block)
    garange = jnp.arange(num_groups, dtype=jnp.int32)
    onehot = gid[:, :, None] == garange[None, None, :]  # (nb, block, G) virtual
    operands, shifts = [], []
    for plan in plans:
        for piece, shift in _pieces_2d(xs, plan):
            if piece is None:
                contrib = onehot.astype(jnp.int32)
            else:
                contrib = jnp.where(onehot, piece[:, :, None], jnp.int32(0))
            operands.append(contrib)
            shifts.append(shift)
    zero = jnp.int32(0)

    def comb(accs, vals):
        return tuple(a + v for a, v in zip(accs, vals))

    outs = jax.lax.reduce(
        tuple(operands), tuple(zero for _ in operands), comb, dimensions=(1,)
    )  # each (nb, G) int32
    results = []
    pos = 0
    for plan in plans:
        npieces = _pieces_per_spec(plan)
        total = jnp.zeros((num_groups,), jnp.int64)
        for c in range(npieces):
            s64 = jnp.sum(outs[pos + c].astype(jnp.int64), axis=0)
            total = total + (s64 << shifts[pos + c])
        pos += npieces
        results.append(total)
    return results
