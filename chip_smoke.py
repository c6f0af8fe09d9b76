#!/usr/bin/env python
"""Prove on an NVIDIA GPU that the engine's main path runs and is right.

One process, one card.  Phases, each printing one line before the last:

1. device      fail unless JAX's first device is a GPU; print its kind, the
               JAX versions, `nvidia-smi`'s name and power limit, and
               whether the host C++ helpers built;
2. quickstart  the README's PlanBuilder and run_sql examples;
3. double      DOUBLE at 10^7 rows: the f64 codec bit for bit, ORDER BY,
               GROUP BY, count(distinct), a join carrying DOUBLE payloads,
               a window and approx_distinct, each against numpy;
4. tpch        Q6, Q1, Q3 and Q13 at SF10 through LocalExecutor, each row
               for row against the numpy oracle;
5. tests       the `gpu`-marked pytest tests, in this process.

The last line is {"ok": true, "device": {...}} and is printed only when
every phase passed; a failed phase raises and the exit code is nonzero.

`--devices 4` runs only the distributed phase on four cards: Q1, Q3 (also
with the shuffle join forced) and Q13 at SF10 through DistributedExecutor,
each against the numpy oracle and LocalExecutor, and the
distributed_grouped_sum check.

Usage:  python chip_smoke.py [--seed 0] [--sf 10] [--devices 1|4]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TPCH_QUERIES = (6, 1, 3, 13)
FLOAT_RTOL = 2e-8  # summation order differs from numpy's; n*eps at 6e7 rows
DOUBLE_ROWS = 10**7


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


# ---- phase 1 ---------------------------------------------------------------


def phase_device(n_devices: int) -> dict:
    import jax
    import jaxlib

    from velox_tpu import native

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devices[0].platform!r}"
        )
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    say(
        "device",
        kind=devices[0].device_kind,
        count=len(devices),
        jax=jax.__version__,
        jaxlib=jaxlib.__version__,
        nvidia_smi=smi.splitlines(),
        native_helpers=native.available(),
    )
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": n_devices,
    }


# ---- host views of results -------------------------------------------------


def host_columns(table) -> dict:
    """{name: numpy array} of a result Table: strings decoded, decimals kept
    unscaled int64 (the engine's representation, so they compare exactly)."""
    out = {}
    for name in table.schema.names:
        arr = np.asarray(table.columns[name])
        if name in table.string_tables:
            arr = table.string_tables[name].decode(arr)
        validity = table.validities.get(name)
        if validity is not None and not validity.all():
            raise AssertionError(f"unexpected NULLs in {name}")
        out[name] = arr
    return out


def compare_columns(got: dict, want: dict, what: str) -> list:
    """Row-exact comparison; float64 columns at FLOAT_RTOL.  Returns the
    names of the columns that took the tolerance."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: columns {sorted(got)} != {sorted(want)}")
    tolerant = []
    for name, w in want.items():
        g = got[name]
        if len(g) != len(w):
            raise AssertionError(f"{what}.{name}: {len(g)} rows, want {len(w)}")
        if np.asarray(w).dtype.kind == "f":
            np.testing.assert_allclose(
                g.astype(np.float64), w, rtol=FLOAT_RTOL, err_msg=f"{what}.{name}"
            )
            tolerant.append(name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")
    return tolerant


# ---- phase 2 ---------------------------------------------------------------


def phase_quickstart() -> None:
    from velox_tpu.dtypes import BIGINT, DOUBLE, RowType
    from velox_tpu.exec import run_plan
    from velox_tpu.io.table import Table
    from velox_tpu.plan import PlanBuilder
    from velox_tpu.sql import run_sql

    k, v = np.arange(8) % 3, np.linspace(0, 1, 8)
    t = Table(RowType(["k", "v"], [BIGINT, DOUBLE]), {"k": k, "v": v})
    plan = (
        PlanBuilder()
        .table_scan(t, filter="v > 0.25")
        .aggregation(["k"], ["sum(v) as s", "count(*) as c"])
        .orderby(["k"])
        .build()
    )
    keep = v > 0.25
    want_s = np.asarray([v[keep & (k == g)].sum() for g in range(3)])
    want_c = np.asarray([(keep & (k == g)).sum() for g in range(3)])
    got = host_columns(run_plan(plan))
    np.testing.assert_array_equal(got["k"], [0, 1, 2])
    np.testing.assert_allclose(got["s"], want_s, rtol=1e-15)
    np.testing.assert_array_equal(got["c"], want_c)
    got = host_columns(
        run_sql(
            "select k, sum(v) as s from t where v > 0.25 group by k order by k",
            {"t": t},
        )
    )
    np.testing.assert_array_equal(got["k"], [0, 1, 2])
    np.testing.assert_allclose(got["s"], want_s, rtol=1e-15)
    say("quickstart", plan_builder="ok", run_sql="ok")


# ---- phase 3 ---------------------------------------------------------------

SPECIALS = np.array(
    [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 5e-324, -5e-324,
     2.2250738585072014e-308, 1.7976931348623157e308, -1.7976931348623157e308],
    dtype=np.float64,
)


def make_doubles(n: int, seed: int) -> np.ndarray:
    """n doubles: uniform bit patterns (every binade, subnormals, NaN
    payloads), wide magnitudes, np.nextafter pairs, a repeated pool (so
    GROUP BY has real groups) and the specials, shuffled."""
    rng = np.random.default_rng(seed)
    q = n // 4
    bits = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, q)
    wide = rng.standard_normal(q) * 10.0 ** rng.integers(-300, 300, q)
    base = rng.standard_normal(q // 2) * 10.0 ** rng.integers(-20, 20, q // 2)
    pairs = np.concatenate([base, np.nextafter(base, np.inf)])
    pool = np.concatenate([rng.standard_normal(1000), SPECIALS])
    rest = n - 2 * q - len(pairs)
    repeated = pool[rng.integers(0, len(pool), rest - len(SPECIALS))]
    v = np.concatenate([bits.view(np.float64), wide, pairs, repeated, SPECIALS])
    return v[rng.permutation(len(v))]


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64).view(np.int64)


def phase_double(n: int, seed: int, tile_rows: int) -> None:
    import jax
    import jax.numpy as jnp

    from velox_tpu.dtypes import BIGINT, DOUBLE, RowType
    from velox_tpu.exec.runner import LocalExecutor
    from velox_tpu.io.table import Table
    from velox_tpu.ops import f64bits
    from velox_tpu.plan import PlanBuilder
    from velox_tpu.sql import run_sql

    t0 = time.perf_counter()
    v = make_doubles(n, seed)
    rng = np.random.default_rng(seed + 1)
    k = rng.integers(0, 7, n)
    # multiples of 2^-10 below 2^20: every sum of 10^7 of them is exact
    w = rng.integers(-(1 << 30), 1 << 30, n) / 1024.0
    nan = np.isnan(v)
    sub = (v != 0) & (np.abs(v) < np.finfo(np.float64).tiny)

    # the codec, bit for bit
    xd = jnp.asarray(v)
    word = np.asarray(jax.jit(f64bits.f64_to_word)(xd))
    np.testing.assert_array_equal(word, _bits(v))
    back = np.asarray(jax.jit(f64bits.word_to_f64)(jnp.asarray(word)))
    np.testing.assert_array_equal(_bits(back), _bits(v))
    srt = np.sort(v)  # NaN last
    key = np.asarray(jax.jit(f64bits.f64_to_ordered)(jnp.asarray(srt)))
    dk = np.diff(key)
    assert (dk >= 0).all(), "f64_to_ordered is not monotone"
    same = srt[1:] == srt[:-1]
    same |= np.isnan(srt[1:]) & np.isnan(srt[:-1])
    np.testing.assert_array_equal(dk == 0, same)  # equal keys iff equal values
    inf_key = np.asarray(f64bits.f64_to_ordered(jnp.asarray([np.inf, 0.0, -0.0])))
    assert key[-1] > inf_key[0] and nan.any(), "NaN must sort above +inf"
    assert inf_key[1] == inf_key[2], "-0.0 and +0.0 must share one code"
    del xd

    table = Table(
        RowType(["id", "k", "v", "w"], [BIGINT, BIGINT, DOUBLE, DOUBLE]),
        {"id": np.arange(n, dtype=np.int64), "k": k, "v": v, "w": w},
    )

    def run(plan):
        return host_columns(LocalExecutor(plan, tile_rows=tile_rows).run())

    # ORDER BY v equals np.sort (NaN last, -0.0 == 0.0)
    got = run(PlanBuilder().table_scan(table).project(["v"]).orderby(["v"]).build())
    np.testing.assert_array_equal(got["v"], srt)

    # GROUP BY a DOUBLE key
    got = run(
        PlanBuilder()
        .table_scan(table)
        .aggregation(["v"], ["count(*) as c"])
        .orderby(["v"])
        .build()
    )
    uniq, counts = np.unique(v, return_counts=True)  # one NaN group, +-0 one
    np.testing.assert_array_equal(got["v"], uniq)
    np.testing.assert_array_equal(got["c"], counts)

    # count(distinct v)
    got = host_columns(run_sql("select count(distinct v) as d from t", {"t": table}, tile_rows))
    assert int(got["d"][0]) == len(uniq), (int(got["d"][0]), len(uniq))

    # a join whose build and probe sides carry DOUBLE payloads, row for row
    dim_r = np.array([1.5, -0.0, np.nan, 5e-324, np.nextafter(1.5, 2), -np.inf, 0.1])
    dim = Table(
        RowType(["k2", "r"], [BIGINT, DOUBLE]),
        {"k2": np.arange(7, dtype=np.int64), "r": dim_r},
    )
    got = run(
        PlanBuilder()
        .table_scan(table)
        .hash_join(
            PlanBuilder().table_scan(dim).build(),
            left_keys=["k"],
            right_keys=["k2"],
            output=["id", "v", "r"],
        )
        .build()
    )
    order = np.argsort(got["id"])
    np.testing.assert_array_equal(got["id"][order], np.arange(n))
    np.testing.assert_array_equal(_bits(got["v"][order]), _bits(v))
    np.testing.assert_array_equal(_bits(got["r"][order]), _bits(dim_r[k]))

    # window: row_number over DOUBLE order, sum over exact DOUBLE values
    got = host_columns(
        run_sql(
            "select k, v, row_number() over (partition by k order by v desc) as rn,"
            " sum(w) over (partition by k) as sw from t",
            {"t": table},
            tile_rows,
        )
    )
    order = np.lexsort((got["rn"], got["k"]))
    gk, gv, gsw = got["k"][order], got["v"][order], got["sw"][order]
    for part in range(7):
        m = gk == part
        np.testing.assert_array_equal(gv[m], np.sort(v[k == part])[::-1])
        np.testing.assert_array_equal(gsw[m], np.full(m.sum(), w[k == part].sum()))

    # approx_distinct hashes DOUBLE words on the device
    got = host_columns(run_sql("select approx_distinct(v) as d from t", {"t": table}, tile_rows))
    est = int(got["d"][0])
    assert abs(est - len(uniq)) / len(uniq) < 0.1, (est, len(uniq))

    # what the backend's float64 arithmetic does with subnormals
    s = jnp.asarray(np.array([5e-324, -1e-310]))
    times_one = np.asarray(jax.jit(lambda a, b: a * b)(s, jnp.ones(2)))
    say(
        "double",
        rows=n,
        nan=int(nan.sum()),
        subnormal=int(sub.sum()),
        codec="bit-exact",
        order_by="exact",
        group_by=f"exact, {len(uniq)} groups",
        count_distinct="exact",
        join_payload_bits="exact",
        window="exact",
        approx_distinct=[est, len(uniq)],
        subnormal_times_one_kept=bool((times_one != 0).all()),
        seconds=round(time.perf_counter() - t0, 3),
    )


# ---- phase 4 ---------------------------------------------------------------


def tile_rows_for(rows: int) -> int:
    """bench.py's tile choice: one tile per scan up to 2^24 rows."""
    from velox_tpu.utils.transfer import bucket_of

    return min(1 << 24, bucket_of(max(rows, 1)))


def generate_query_tables(num: int, sf: float) -> tuple:
    from velox_tpu.connectors.tpch import generate_table
    from velox_tpu.connectors.tpch.queries import QUERY_COLUMNS

    tables, seconds = {}, {}
    for name, cols in QUERY_COLUMNS[num].items():
        t0 = time.perf_counter()
        tables[name] = generate_table(name, sf, cols)
        seconds[name] = round(time.perf_counter() - t0, 3)
    return tables, seconds


def best_of(fn, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_tpch(sf: float, queries=TPCH_QUERIES) -> None:
    import jax

    from velox_tpu.connectors.tpch import plans as tp
    from velox_tpu.exec.runner import LocalExecutor
    from velox_tpu.utils import devtime

    dev = jax.devices()[0]
    for num in queries:
        tables, gen_s = generate_query_tables(num, sf)
        plan = tp.build_query(num, tables)
        rows = max(t.num_rows for t in tables.values())
        tile_rows = tile_rows_for(rows)
        t0 = time.perf_counter()
        ex = LocalExecutor(plan, tile_rows=tile_rows)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiles = ex.device_tiles()
        jax.block_until_ready([t.columns for t in tiles])
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = ex.run(prefetched_tiles=tiles)
        first_s = time.perf_counter() - t0
        tolerant = compare_columns(
            host_columns(result), tp.oracle_columns(num, tables), f"q{num}"
        )
        warm_s = best_of(lambda: ex.run(prefetched_tiles=tiles))
        with devtime.capture() as records:
            ex.run(prefetched_tiles=tiles)
            n_dispatches = len(records)
        stats = dev.memory_stats() or {}
        say(
            "tpch",
            query=num,
            sf=sf,
            rows=rows,
            tile_rows=tile_rows,
            result_rows=result.num_rows,
            oracle="equal",
            float_columns_at_rtol=tolerant,
            generation_seconds=gen_s,
            build_seconds=round(build_s, 3),
            ingest_seconds=round(ingest_s, 3),
            first_run_seconds=round(first_s, 3),
            warm_seconds=round(warm_s, 4),
            n_dispatches=n_dispatches,
            peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        )
        del ex, tiles, result, tables


# ---- phase 5 ---------------------------------------------------------------


def phase_tests() -> None:
    import pytest

    os.environ["VELOX_TESTS_ON_CARD"] = "1"
    rc = pytest.main(
        [
            "-q", os.path.join(REPO, "tests", "test_on_card.py"),
            "-m", "gpu", "-p", "no:xdist", "-p", "no:cacheprovider",
            "-p", "no:randomly",
        ]
    )
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests failed: pytest exit code {rc}")
    say("tests", gpu_marked="passed")


# ---- four cards ------------------------------------------------------------


def _device_arrays(obj, depth: int = 0):
    import jax

    if isinstance(obj, jax.Array):
        yield obj
    elif depth < 3 and isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _device_arrays(x, depth + 1)
    elif depth < 3 and isinstance(obj, dict):
        for x in obj.values():
            yield from _device_arrays(x, depth + 1)
    elif depth < 3 and hasattr(obj, "__dict__"):
        for x in vars(obj).values():
            yield from _device_arrays(x, depth + 1)


def check_spread(arrays, n: int, what: str) -> int:
    """No array may sit wholly on one device; row arrays must be split."""
    import jax

    count = 0
    for x in arrays:
        devices = {s.device for s in x.addressable_shards}
        if len(devices) != n:
            raise AssertionError(f"{what}: an array lives on {devices} only")
        if not x.sharding.is_fully_replicated:
            shard_rows = x.sharding.shard_shape(x.shape)[0]
            if shard_rows * n != x.shape[0]:
                raise AssertionError(f"{what}: shard of {shard_rows} rows of {x.shape}")
        count += 1
    if not count:
        raise AssertionError(f"{what}: no device arrays to check")
    jax.block_until_ready(list(arrays))
    return count


def phase_grouped_sum(n: int, rows_per_device: int = 1 << 20) -> None:
    """parallel.distributed_grouped_sum against numpy (the multi-device
    step of __graft_entry__.dryrun_multichip)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from velox_tpu.dtypes import DATE, RowType, decimal
    from velox_tpu.expr.parser import parse_expr
    from velox_tpu.parallel.distributed import distributed_grouped_sum, make_mesh

    mesh = make_mesh(n)
    rows = n * rows_per_device
    dec = decimal(12, 2)
    schema = RowType(
        ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"],
        [dec, dec, dec, DATE],
    )
    rng = np.random.default_rng(0)
    host = [
        rng.integers(100, 5100, rows).astype(np.int64),
        rng.integers(100000, 999999, rows).astype(np.int64),
        rng.integers(0, 11, rows).astype(np.int64),
        rng.integers(8700, 9100, rows).astype(np.int32),
    ]
    host_keys = rng.integers(0, 64, rows).astype(np.int64)
    sharding = NamedSharding(mesh, P("data"))
    cols = [jax.device_put(jnp.asarray(c), sharding) for c in host]
    keys = jax.device_put(jnp.asarray(host_keys), sharding)
    check_spread(cols + [keys], n, "grouped_sum inputs")
    step = distributed_grouped_sum(
        mesh,
        parse_expr("l_discount between 0.05 and 0.07 and l_quantity < 24", schema),
        parse_expr("l_extendedprice * l_discount", schema),
        schema,
        num_groups=64,
    )
    out = np.asarray(step(cols, keys))
    mask = (host[2] >= 5) & (host[2] <= 7) & (host[0] < 2400)
    want = np.zeros(64, dtype=np.int64)
    np.add.at(want, host_keys[mask], (host[1] * host[2])[mask])
    np.testing.assert_array_equal(out.sum(axis=0), want)
    say("distributed_grouped_sum", devices=n, rows=rows, oracle="equal")


def phase_distributed(sf: float, n: int) -> None:
    import jax

    from velox_tpu.config import QueryConfig
    from velox_tpu.connectors.tpch import plans as tp
    from velox_tpu.exec.runner import LocalExecutor
    from velox_tpu.parallel.runner import DistributedExecutor, make_mesh

    mesh = make_mesh(n)
    runs = [(1, None), (3, None), (3, QueryConfig(broadcast_join_max_rows=0)), (13, None)]
    tables = None
    for num, config in runs:
        if tables is None or tables[0] != num:
            tables = (num, *generate_query_tables(num, sf))
            local = None
        _, tabs, gen_s = tables
        plan = tp.build_query(num, tabs)
        rows = max(t.num_rows for t in tabs.values())
        tile_rows = tile_rows_for(rows)
        oracle = tp.oracle_columns(num, tabs)
        if local is None:
            t0 = time.perf_counter()
            local = host_columns(LocalExecutor(plan, tile_rows=tile_rows).run())
            local_s = time.perf_counter() - t0
            compare_columns(local, oracle, f"q{num} local")
        ex = DistributedExecutor(
            plan, mesh, per_device_rows=max(tile_rows // n, 1), config=config
        )
        if config is not None and not ex._segments:
            raise AssertionError(f"q{num}: expected a shuffle-join segment")
        tiles = ex.device_tiles()
        spread = check_spread(
            [a for t in tiles for a in _device_arrays(t.columns)], n, f"q{num} tiles"
        )
        for _, state in getattr(ex, "_segments", ()):
            spread += check_spread(list(_device_arrays(state)), n, f"q{num} build")
        t0 = time.perf_counter()
        got = host_columns(ex.run(prefetched_tiles=tiles))
        first_s = time.perf_counter() - t0
        tolerant = compare_columns(got, oracle, f"q{num} distributed")
        compare_columns(got, local, f"q{num} distributed vs local")
        warm_s = best_of(lambda: ex.run(prefetched_tiles=tiles))
        say(
            "distributed",
            query=num,
            sf=sf,
            devices=n,
            join="shuffle" if config is not None else "default",
            shuffle_segments=len(ex._segments),
            sharded_arrays_checked=spread,
            oracle="equal",
            local="equal",
            float_columns_at_rtol=tolerant,
            generation_seconds=gen_s,
            local_seconds=round(local_s, 3),
            first_run_seconds=round(first_s, 3),
            warm_seconds=round(warm_s, 4),
            peak_bytes_in_use=[
                (d.memory_stats() or {}).get("peak_bytes_in_use")
                for d in jax.devices()[:n]
            ],
        )
        del ex, tiles


# ---- main ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    device = phase_device(args.devices)
    if args.devices == 1:
        phase_quickstart()
        phase_double(DOUBLE_ROWS, args.seed, tile_rows_for(DOUBLE_ROWS))
        phase_tpch(args.sf)
        phase_tests()
    else:
        phase_distributed(args.sf, args.devices)
        phase_grouped_sum(args.devices)
    say("done", seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
