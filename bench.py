#!/usr/bin/env python
"""TPC-H benchmark harness (reference: velox/benchmarks/tpch/TpchBenchmark.cpp:218).

Runs the benchmark matrix (Q1/Q3/Q6/Q13 by default) on the default JAX backend,
verifies row-exact parity against the exact oracle per query, and prints ONE
JSON line:

    {"metric": ..., "value": rows_per_sec, "unit": "rows/s",
     "vs_baseline": R, "device": {...}, "matrix": {...}}

A query that fails (wrong result or error) ends the run with a nonzero exit
code and no JSON line.

``vs_baseline`` is engine rows/s divided by the *same-host numpy oracle* rows/s
on identical data — a reference-engine proxy, since the reference's dbgen/DuckDB
stack is not runnable in this environment (see BASELINE.md).

Roofline accounting: the harness first measures achievable device-memory
bandwidth with a streaming reduction (refused when it exceeds the device's
published peak, PEAK_MEMORY_BYTES_PER_S), models each query's minimum bytes
(one pass over every scanned column after pruning — what a perfect engine must
read), and reports pct_roofline = speed-of-light time / measured wall time per
query.

Tables are HBM-resident before timing (the engine's steady-state regime);
host->device ingest time is reported separately on stderr.

Usage: python bench.py [--sf 1.0] [--queries 1,3,6,13] [--all] [--quick]
                       [--tile 0 (auto)] [--no-roofline]
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def time_best(fn, repeats):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


# Published peak device-memory bandwidth per device kind, in bytes/s.  Source:
# NVIDIA H100 Tensor Core GPU data sheet (H100 SXM: 80 GB HBM3, 3.35 TB/s).
# A measured bandwidth above the peak means the timing did not block on
# device work.  A device missing from the table is an error, not a default.
PEAK_MEMORY_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_memory_bytes_per_s(device) -> float:
    try:
        return PEAK_MEMORY_BYTES_PER_S[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no published memory bandwidth for {device.device_kind!r}; add it "
            "to PEAK_MEMORY_BYTES_PER_S with its source, or pass --no-roofline"
        ) from None


def device_info() -> dict:
    """platform, device_kind, device count and the card's power limit."""
    import jax

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    if dev.platform == "gpu":
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    return info


def measure_hbm_bandwidth():
    """Achievable device-memory read bandwidth (GB/s).

    Runs K dependent full passes over a buffer far beyond any cache tier
    INSIDE one dispatched program — each iteration's reduction feeds the
    next, so XLA cannot skip work — then divides the K-vs-1 time difference
    by K-1, which subtracts the dispatch and fetch floor.
    """
    import velox_tpu  # noqa: F401  (enables jax_enable_x64 — real float64)
    import jax
    import jax.numpy as jnp

    n = 1 << 26  # 64M float64 = 512 MiB
    x = jnp.ones((n,), jnp.float64)
    K = 17

    def chain(a, k):
        def body(_, acc):
            # full pass over `a`; depends on acc so passes cannot collapse
            return jnp.sum(a + acc) * 1e-12

        return jax.lax.fori_loop(0, k, body, 0.0)

    f1 = jax.jit(lambda a: chain(a, 1))
    fk = jax.jit(lambda a: chain(a, K))
    float(f1(x))  # compile + warm
    float(fk(x))
    t1 = time_best(lambda: float(f1(x)), 3)
    tk = time_best(lambda: float(fk(x)), 3)
    per_pass = max((tk - t1) / (K - 1), 1e-9)
    gbps = (n * 8) / per_pass / 1e9
    peak = peak_memory_bytes_per_s(jax.devices()[0]) / 1e9
    if gbps > peak:
        raise RuntimeError(
            f"measured {gbps:.0f} GB/s is above the device's {peak:.0f} GB/s "
            "peak: the timing did not block on device work"
        )
    return gbps


def measure_device_seconds(executor, tiles, repeats=3, k=9):
    """Steady-state device compute per query run.

    engine_seconds includes dispatch and the result fetch.  This chains K
    data-DEPENDENT executions of the per-tile program inside ONE dispatched
    program (every leaf of iteration i's result folds into a scalar that
    perturbs iteration i+1's input by a provably-zero amount, so XLA cannot
    hoist or skip work), times K-vs-1 with a forced scalar fetch, and
    divides.  Same methodology as measure_hbm_bandwidth.  Reference discipline:
    per-operator CPU timing in the Driver loop (velox/exec/Driver.cpp:538).

    Returns seconds per run, or None when the plan shape is unsupported
    (multi-tile, or a host-orchestrated executor kind).
    """
    import jax
    import jax.numpy as jnp

    if len(tiles) != 1:
        return None
    if getattr(executor, "_split_mode", False):
        # split-dispatch pipelines run as SEVERAL programs with host-level
        # sort dispatch between them (config.split_sort_programs); tracing
        # them into one chained program would inline the sorts and recreate
        # the per-program compile cost this mode exists to avoid
        return None
    tile = tiles[0]
    kind = executor.kind

    def fold(x):
        acc = jnp.zeros((), jnp.int64)
        for leaf in jax.tree_util.tree_leaves(x):
            if not hasattr(leaf, "dtype"):
                continue
            if jnp.issubdtype(leaf.dtype, jnp.floating):
                acc = acc + jnp.nan_to_num(jnp.sum(leaf)).astype(jnp.int64)
            else:
                acc = acc + jnp.sum(leaf.astype(jnp.int64))
        return acc

    def perturb(t, acc):
        leaves, treedef = jax.tree_util.tree_flatten(t)
        for i, leaf in enumerate(leaves):
            if (
                hasattr(leaf, "ndim")
                and leaf.ndim == 1
                and leaf.shape[0] == t.capacity
                and jnp.issubdtype(leaf.dtype, jnp.number)
            ):
                # the tuple barrier makes the zero BOTH opaque to the
                # simplifier and data-dependent on acc; barrier(acc & 0)
                # is not enough — the simplifier folds the operand to a
                # constant first, drops the dependency, and the loop body
                # hoists (measured: K=9 ran at K=1's time)
                _, zero = jax.lax.optimization_barrier(
                    (acc, jnp.zeros((), jnp.int64))
                )
                # perturb EVERY candidate leaf: perturbing only the first
                # left programs that never read that column loop-invariant,
                # and the whole body hoisted (measured: q6's device time
                # collapsed to ~0 and its roofline read 2e7%)
                leaves[i] = leaf + zero.astype(leaf.dtype)
        return jax.tree_util.tree_unflatten(treedef, leaves)

    if kind == "direct_agg":
        ex = executor.agg_exec
        init = (ex.init_carry(), jnp.zeros((), jnp.int64))

        def once(t):
            return fold(executor._tile_step(init, t))

    elif kind == "sort_agg_device":

        def once(t):
            return fold(executor._sort_tile_partial_jit(t))

    else:
        return None

    @jax.jit
    def chained(t, kk):
        def body(_, acc):
            return acc + once(perturb(t, acc))

        return jax.lax.fori_loop(0, kk, body, jnp.zeros((), jnp.int64))

    int(chained(tile, 1))  # compile + warm (ONE program: kk is dynamic)
    t1 = time_best(lambda: int(chained(tile, 1)), repeats)
    tk = time_best(lambda: int(chained(tile, k)), repeats)
    per_run = (tk - t1) / (k - 1)
    if per_run < 2e-6:
        # K runs took no longer than 1: the loop body was hoisted despite
        # the perturbation — the measurement is invalid, refuse to report it
        log("device-loop measurement hoisted (K==1 time); dropping it")
        return None
    return per_run


def measure_device_programs(executor, tiles, repeats=3, hbm_gbps=None):
    """Per-PROGRAM device-time attribution (the per-operator timing of
    velox/exec/Driver.cpp:538-542): capture the dispatch stream of one run,
    then time each unique program honestly (chained-K for sort-free programs,
    self-feeding for canonical sorts — utils/devtime.py).

    Returns (device_seconds_total_or_None, programs list, n_dispatches)."""
    from velox_tpu.utils import devtime

    with devtime.capture() as records:
        executor.run(prefetched_tiles=tiles)
    programs = devtime.measure(records, repeats=repeats)
    for p in programs:
        if p["seconds"] and hbm_gbps:
            # achieved bandwidth share: bandwidth-bound programs read+write
            # roughly their operand bytes once each
            gbps = 2.0 * p["arg_bytes"] / p["seconds"] / 1e9
            p["achieved_gbps"] = round(gbps, 1)
            p["pct_hbm"] = round(100.0 * gbps / hbm_gbps, 1)
    measured = [p for p in programs if p["seconds"] is not None]
    unmeasured = sum(p.get("unmeasured_calls", 0) for p in programs)
    total = sum(p["seconds"] for p in measured) if measured else None
    if total is not None and unmeasured:
        # some dispatches could not be timed: the sum is a lower bound
        total = None
    return total, programs, len(records)


def query_min_bytes(plan, tables) -> int:
    """Minimum bytes a perfect engine must touch: ONE pass over every scanned
    column that survives pruning (the roofline numerator).  Walks the plan for
    TableScan nodes and sums rows * itemsize over their output columns."""
    from velox_tpu.plan.nodes import TableScanNode

    total = 0
    seen = set()

    def walk(node):
        nonlocal total
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, TableScanNode):
            t = node.table
            for name in node.output_schema.names:
                arr = t.columns.get(name)
                if arr is None or not hasattr(arr, "nbytes"):
                    continue
                nbytes = arr.nbytes
                if np.asarray(arr).dtype == np.int64:
                    # narrow-on-the-wire columns (Table.tile) scan as int32
                    b = t.column_bounds(name)
                    if b is not None and b[0] >= -(2**31) and b[1] < 2**31:
                        nbytes //= 2
                total += nbytes
        for s in getattr(node, "sources", ()):
            walk(s)

    walk(plan)
    return total


def bench_query(num, sf, tile_rows, repeats=3, hbm_gbps=None):
    import pandas as pd

    from velox_tpu.connectors.tpch import plans as tp
    from velox_tpu.exec.runner import LocalExecutor

    tables = tp.load_query_tables(num, sf)
    plan = tp.build_query(num, tables)
    input_rows = max(t.num_rows for t in tables.values())

    if tile_rows <= 0:
        # auto: one tile covering the largest scan when it fits — each extra
        # tile costs a dispatch and a carry merge
        from velox_tpu.utils.transfer import bucket_of

        tile_rows = min(1 << 24, bucket_of(max(input_rows, 1)))

    # build = join-bridge construction + jit wrapper setup
    t0 = time.perf_counter()
    executor = LocalExecutor(plan, tile_rows=tile_rows)
    build_s = time.perf_counter() - t0

    # Source-scan tiles HBM-resident up front (steady-state regime).
    t0 = time.perf_counter()
    tiles = executor.device_tiles()
    import jax

    jax.block_until_ready([t.columns for t in tiles])
    ingest_s = time.perf_counter() - t0

    # Warm-up (compile) + parity check.
    t0 = time.perf_counter()
    result = executor.run(prefetched_tiles=tiles).to_pandas()
    first_run_s = time.perf_counter() - t0
    result_rows = len(result)
    if num in tp.ENGINE_OUTPUT_ORDER:
        result = result[tp.ENGINE_OUTPUT_ORDER[num]]
    oracle = tp.oracle_result(num, tables)
    pd.testing.assert_frame_equal(
        result.reset_index(drop=True), oracle, check_dtype=False
    )
    log(f"q{num}: parity OK ({len(result)} result rows)")

    engine_s = time_best(lambda: executor.run(prefetched_tiles=tiles), repeats)
    oracle_s = time_best(lambda: tp.oracle_result(num, tables), repeats)
    device_s = measure_device_seconds(executor, tiles, repeats)
    prog_total, programs, n_dispatches = measure_device_programs(
        executor, tiles, repeats, hbm_gbps
    )
    if device_s is None:
        device_s = prog_total
    row = {
        "query": num,
        "sf": sf,
        "input_rows": input_rows,
        "engine_seconds": round(engine_s, 6),
        "oracle_seconds": round(oracle_s, 6),
        "ingest_seconds": round(ingest_s, 6),
        "build_seconds": round(build_s, 6),
        "compile_seconds": round(max(first_run_s - engine_s, 0.0), 6),
        "cold_to_first_result_seconds": round(
            build_s + ingest_s + first_run_s, 6
        ),
        "rows_per_sec": round(input_rows / engine_s, 1),
        "vs_oracle": round(oracle_s / engine_s, 3),
    }
    if device_s is not None:
        row["device_seconds"] = round(device_s, 6)
    if n_dispatches is not None:
        row["n_dispatches"] = n_dispatches
    if programs:
        row["programs"] = programs
    if hbm_gbps:
        min_bytes = query_min_bytes(plan, tables)
        sol_s = min_bytes / (hbm_gbps * 1e9)
        row["min_bytes"] = min_bytes
        row["sol_seconds"] = round(sol_s, 6)
        row["pct_roofline"] = round(100.0 * sol_s / engine_s, 2)
        if device_s is not None:
            # device compute vs speed-of-light, dispatch and fetch excluded
            row["pct_roofline_device"] = round(100.0 * sol_s / device_s, 2)
    log(
        f"q{num} sf{sf:g}: engine {engine_s*1e3:.1f} ms, oracle(numpy) "
        f"{oracle_s*1e3:.1f} ms, ingest {ingest_s*1e3:.1f} ms, "
        f"build {build_s*1e3:.0f} ms, compile "
        f"{row['compile_seconds']*1e3:.0f} ms, rows {input_rows}"
        + (
            f", device {device_s*1e3:.2f} ms" if device_s is not None else ""
        )
        + (
            f", bytes {row['min_bytes']/1e6:.0f} MB, "
            f"SoL {row['sol_seconds']*1e3:.2f} ms, "
            f"{row['pct_roofline']:.1f}% roofline"
            + (
                f" ({row['pct_roofline_device']:.1f}% device)"
                if device_s is not None
                else ""
            )
            if hbm_gbps
            else ""
        )
    )
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument(
        "--queries", type=str, default="6,1,3,13",
        help="comma-separated query numbers (first = headline)",
    )
    ap.add_argument("--all", action="store_true", help="run all 22 TPC-H queries")
    ap.add_argument("--quick", action="store_true", help="SF0.01 smoke run")
    ap.add_argument(
        "--tile", type=int, default=0,
        help="rows per device tile; 0 = auto (one tile per scan when it fits)",
    )
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-roofline", action="store_true")
    args = ap.parse_args()
    if args.quick:
        args.sf = 0.01

    import jax

    device = device_info()
    log(f"backend: {jax.default_backend()}, devices: {jax.devices()}")

    hbm_gbps = None
    if not args.no_roofline:
        hbm_gbps = measure_hbm_bandwidth()
        log(f"measured memory read bandwidth: {hbm_gbps:.0f} GB/s")

    if args.all:
        from velox_tpu.connectors.tpch.plans import implemented_queries

        queries = implemented_queries()
    else:
        queries = [int(q) for q in args.queries.split(",")]
    matrix = {}
    for num in queries:
        matrix[f"q{num}"] = bench_query(
            num, args.sf, args.tile, args.repeats, hbm_gbps
        )

    # SF10 pass: the SF1 compute is small, so scaling behavior — multiple
    # tiles, real carry merges, GB-class ingest — is only exercised here.
    if args.sf == 1.0 and not args.all and not args.quick:
        for num in queries:
            matrix[f"q{num}_sf10"] = bench_query(
                num, 10.0, args.tile, args.repeats, hbm_gbps
            )
    head = next(iter(matrix.values()))
    print(
        json.dumps(
            {
                "metric": f"tpch_sf{head['sf']:g}_q{head['query']}_rows_per_sec",
                "value": head["rows_per_sec"],
                "unit": "rows/s",
                "vs_baseline": head["vs_oracle"],
                "hbm_gbps": round(hbm_gbps, 1) if hbm_gbps else None,
                "device": device,
                "matrix": matrix,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
