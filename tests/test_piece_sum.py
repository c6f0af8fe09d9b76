"""Exactness of the int32 grouped piece-sum lowering (ops/piece_sum.py)
against numpy."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from velox_tpu.ops.piece_sum import (
    Factor,
    SpecPlan,
    grouped_piece_sums_xla,
    plan_spec,
)

BLOCK = 1024


def _np_oracle(cols, gid, plans, G):
    out = []
    for plan in plans:
        v = np.ones(len(gid), dtype=np.int64)
        for f in plan.factors:
            v = v * (f.scale * cols[f.col].astype(np.int64) + f.offset)
        s = np.zeros(G, np.int64)
        live = gid >= 0
        np.add.at(s, gid[live], v[live])
        out.append(s)
    return out


def test_q1_shaped_specs_exact():
    rng = np.random.default_rng(0)
    n = 4 * BLOCK
    G = 6
    ep = rng.integers(90000, 10500000, n).astype(np.int32)  # l_extendedprice
    qty = rng.integers(100, 5001, n).astype(np.int16)
    d = rng.integers(0, 11, n).astype(np.int8)  # l_discount
    t = rng.integers(0, 9, n).astype(np.int8)  # l_tax
    gid = rng.integers(0, G, n).astype(np.int8)
    gid[rng.random(n) < 0.1] = -1  # dead rows

    f_ep = Factor(0, 1, 0, 90000, 10500000)
    f_qty = Factor(1, 1, 0, 100, 5000)
    f_d = Factor(2, 1, 0, 0, 10)
    f_1md = Factor(2, -1, 100, 90, 100)
    f_1pt = Factor(3, 1, 100, 100, 108)
    specs = [
        [f_qty],  # sum(l_quantity)
        [f_ep],  # sum(l_extendedprice) — needs chunking
        [f_ep, f_1md],  # sum(disc_price)
        [f_ep, f_1md, f_1pt],  # sum(charge) — prefix + rest
        [f_d],  # sum(l_discount)
        [],  # count
    ]
    plans = tuple(plan_spec(s) for s in specs)
    assert all(p is not None for p in plans)
    assert plans[1].n_chunks > 1  # ep alone must chunk
    assert plans[3].n_prefix == 2 and plans[3].n_chunks > 1

    cols = tuple(jnp.asarray(c) for c in (ep, qty, d, t))
    got = grouped_piece_sums_xla(cols, jnp.asarray(gid), plans, G)
    exp = _np_oracle([ep, qty, d, t], gid, plans, G)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(g), e)


def test_planner_gates():
    # negative bounds -> refused
    assert plan_spec([Factor(0, 1, 0, -5, 10)]) is None
    # single factor beyond int32 -> refused
    assert plan_spec([Factor(0, 1, 0, 0, 1 << 32)]) is None
    # small products stay single-piece
    p = plan_spec([Factor(0, 1, 0, 0, 100), Factor(1, 1, 0, 0, 100)])
    assert p.n_chunks == 1


def test_large_group_pad_and_min_values():
    rng = np.random.default_rng(1)
    n = 2 * BLOCK
    G = 13  # not a power of two
    x = rng.integers(0, 1000, n).astype(np.int16)
    gid = rng.integers(0, G, n).astype(np.int8)
    plans = (
        plan_spec([Factor(0, 1, 0, 0, 999)]),
        plan_spec([]),
    )
    got = grouped_piece_sums_xla((jnp.asarray(x),), jnp.asarray(gid), plans, G)
    exp = _np_oracle([x], gid, plans, G)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(g), e)


def test_xla_form_matches():
    rng = np.random.default_rng(2)
    n = 2 * BLOCK
    G = 6
    ep = rng.integers(90000, 10500000, n).astype(np.int32)
    d = rng.integers(0, 11, n).astype(np.int8)
    t = rng.integers(0, 9, n).astype(np.int8)
    gid = rng.integers(0, G, n).astype(np.int8)
    gid[rng.random(n) < 0.1] = -1
    f_ep = Factor(0, 1, 0, 90000, 10500000)
    f_1md = Factor(1, -1, 100, 90, 100)
    f_1pt = Factor(2, 1, 100, 100, 108)
    plans = (
        plan_spec([f_ep]),
        plan_spec([f_ep, f_1md]),
        plan_spec([f_ep, f_1md, f_1pt]),
        plan_spec([]),
    )
    got = grouped_piece_sums_xla(
        tuple(jnp.asarray(c) for c in (ep, d, t)), jnp.asarray(gid), plans, G
    )
    exp = _np_oracle([ep, d, t], gid, plans, G)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(g), e)


def test_executor_piece_gates():
    """try_enable_piece_path: activates for Q1-shaped plans, refuses
    nullable inputs and non-sum aggregates (exec/runner.py)."""
    import velox_tpu as vt
    from velox_tpu.io.table import Table
    from velox_tpu.plan.builder import PlanBuilder
    from velox_tpu.exec.runner import LocalExecutor
    from velox_tpu.dtypes import RowType

    rng = np.random.default_rng(0)
    n = 4096
    k = rng.integers(0, 4, n).astype(np.int64)
    a = rng.integers(0, 1000, n).astype(np.int64)
    b = rng.integers(0, 50, n).astype(np.int64)

    def mk(validities=None):
        t = Table(
            RowType(["k", "a", "b"], [vt.BIGINT] * 3),
            {"k": k, "a": a, "b": b},
        )
        if validities:
            t.validities.update(validities)
        return t

    # enough aggregates to pass the G x slots >= 16 cost gate
    aggs = ["sum(a)", "sum(a * b)", "avg(a)", "avg(b)", "count(*)"]
    plan = (
        PlanBuilder().table_scan(mk()).aggregation(["k"], aggs).build()
    )
    ex = LocalExecutor(plan)
    assert getattr(ex.agg_exec, "_piece_plan", None) is not None
    out = ex.run().to_pandas().sort_values("k")
    import pandas as pd

    df = pd.DataFrame({"k": k, "a": a, "b": b})
    exp = df.groupby("k").apply(
        lambda g: pd.Series(
            {
                "s": g.a.sum(),
                "sab": (g.a * g.b).sum(),
                "cnt": len(g),
            }
        ),
        include_groups=False,
    )
    names = list(out.columns)
    got_s = dict(zip(out["k"], out[names[1]]))
    got_sab = dict(zip(out["k"], out[names[2]]))
    got_c = dict(zip(out["k"], out[names[5]]))
    for kk in exp.index:
        assert got_s[kk] == exp.loc[kk, "s"]
        assert got_sab[kk] == exp.loc[kk, "sab"]
        assert got_c[kk] == exp.loc[kk, "cnt"]

    # nullable input -> refused (counts would diverge)
    val = np.ones(n, bool)
    val[::7] = False
    plan2 = (
        PlanBuilder()
        .table_scan(mk({"a": val}))
        .aggregation(["k"], aggs)
        .build()
    )
    ex2 = LocalExecutor(plan2)
    assert getattr(ex2.agg_exec, "_piece_plan", None) is None

    # min() in the mix -> refused
    plan3 = (
        PlanBuilder()
        .table_scan(mk())
        .aggregation(["k"], aggs + ["min(a)"])
        .build()
    )
    ex3 = LocalExecutor(plan3)
    assert getattr(ex3.agg_exec, "_piece_plan", None) is None
