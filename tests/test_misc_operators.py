"""Tests for RowNumber/TopNRowNumber/MarkDistinct/EnforceSingleRow + stats/trace."""

import numpy as np
import pandas as pd
import pytest

import velox_tpu as vt
from velox_tpu.dtypes import RowType
from velox_tpu.io.table import Table
from velox_tpu.plan import PlanBuilder
from velox_tpu.exec import QueryError, run_plan


def make_table(**cols):
    names = list(cols)
    return Table(
        RowType(names, [vt.BIGINT] * len(names)),
        {k: np.asarray(v) for k, v in cols.items()},
    )


def test_row_number_with_limit():
    t = make_table(g=[1, 1, 1, 2, 2, 3], v=[10, 20, 30, 40, 50, 60])
    plan = PlanBuilder().table_scan(t).row_number(["g"], limit=2).build()
    out = run_plan(plan).to_pandas()
    assert out.groupby("g")["row_number"].max().max() <= 2
    assert len(out) == 5  # 2 + 2 + 1


def test_topn_row_number():
    t = make_table(g=[1, 1, 1, 2, 2], v=[30, 10, 20, 5, 50])
    plan = (
        PlanBuilder().table_scan(t)
        .topn_row_number(["g"], ["v desc"], 1)
        .orderby(["g"]).build()
    )
    out = run_plan(plan).to_pandas()
    np.testing.assert_array_equal(out["v"], [30, 50])


def test_mark_distinct():
    t = make_table(k=[7, 7, 8, 9, 8], v=[1, 2, 3, 4, 5])
    plan = PlanBuilder().table_scan(t).mark_distinct("is_first", ["k"]).orderby(["v"]).build()
    out = run_plan(plan).to_pandas()
    np.testing.assert_array_equal(out["is_first"], [True, False, True, True, False])


def test_enforce_single_row():
    t = make_table(v=[1, 2, 3])
    ok = (
        PlanBuilder().table_scan(t).filter("v = 2").enforce_single_row().build()
    )
    assert len(run_plan(ok).to_pandas()) == 1
    bad = PlanBuilder().table_scan(t).enforce_single_row().build()
    with pytest.raises(QueryError, match="expected <= 1"):
        run_plan(bad)


def test_print_plan_and_stats():
    from velox_tpu.utils.stats import collect_operator_stats, print_plan

    t = make_table(v=list(range(100)))
    plan = PlanBuilder().table_scan(t).filter("v % 2 = 0").project(["v * 2 as w"]).build()
    text = print_plan(plan)
    assert "Project" in text and "Filter" in text and "TableScan" in text
    stats = collect_operator_stats(plan)
    text2 = print_plan(plan, stats)
    assert "rows" in text2
    by_node = stats.by_node()
    assert by_node[plan.id].output_rows == 50


def test_trace_context():
    from velox_tpu.utils.trace import status, trace_context

    with trace_context("TableScan"):
        with trace_context("Exchange"):
            s = status()
            assert "TableScan: live=1" in s and "Exchange: live=1" in s
    assert status() == "(no outstanding operations)"


def test_testvalue_injection_points():
    """Reference: common/testutil/TestValue.h — hooks fire at exact internal
    states; here: the device-merge overflow fallback."""
    import numpy as np

    from velox_tpu.dtypes import BIGINT, RowType
    from velox_tpu.exec.runner import LocalExecutor
    from velox_tpu.io.table import Table
    from velox_tpu.plan import PlanBuilder
    from velox_tpu.utils import testvalue

    rng = np.random.default_rng(0)
    n, nkeys = 8000, 5000
    keys = rng.permutation(np.repeat(np.arange(nkeys), 2))[:n]
    t = Table(
        RowType(["k", "v"], [BIGINT, BIGINT]),
        {"k": keys, "v": rng.integers(0, 5, n)},
    )
    plan = (
        PlanBuilder().table_scan(t)
        .aggregation(["k"], ["sum(v) as s"]).orderby(["k"]).build()
    )
    fired = []
    with testvalue.scoped(
        "AggExecutor::carryOverflowFallback", lambda st: fired.append(st)
    ):
        # 1024-slot carry with ~5000 distinct keys overflows the device merge
        out = LocalExecutor(plan, tile_rows=1024).run().to_pandas()
    assert fired, "overflow fallback injection point did not fire"
    assert len(out) == len(np.unique(keys))


def test_data_cache_hits(tmp_path):
    import numpy as np

    from velox_tpu.dtypes import BIGINT, RowType
    from velox_tpu.io.cache import DataCache
    from velox_tpu.io.table import Table

    t = Table(RowType(["x"], [BIGINT]), {"x": np.arange(10, dtype=np.int64)})
    path = str(tmp_path / "t.parquet")
    t.save_parquet(path)
    cache = DataCache(max_bytes=1 << 20)
    a = cache.get_or_load(path)
    b = cache.get_or_load(path)
    assert a is b and cache.hits == 1 and cache.misses == 1
    np.testing.assert_array_equal(a.columns["x"], t.columns["x"])


def test_data_cache_async_prefetch(tmp_path):
    """prefetch() loads asynchronously on the I/O executor; a subsequent
    get_or_load JOINS the in-flight future (no double read, no deadlock)
    and counts as a hit (reference: CachedBufferedInput prefetch)."""
    import numpy as np

    from velox_tpu.dtypes import BIGINT, RowType
    from velox_tpu.io.cache import DataCache
    from velox_tpu.io.table import Table

    p = str(tmp_path / "t.parquet")
    Table(
        RowType(["x"], [BIGINT]), {"x": np.arange(1000, dtype=np.int64)}
    ).save_parquet(p)

    c = DataCache(max_bytes=1 << 20)
    c.prefetch(p, ["x"])
    t = c.get_or_load(p, ["x"])  # joins the in-flight load
    assert t.num_rows == 1000
    assert c.hits == 1 and c.misses == 0
    t2 = c.get_or_load(p, ["x"])  # now a plain cache hit
    assert t2 is not None and c.hits == 2
