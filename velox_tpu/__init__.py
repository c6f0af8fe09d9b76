"""velox_tpu — a vectorized query-execution engine on JAX/XLA.

A ground-up JAX/XLA re-design with the capabilities of the reference engine
(Velox, a C++ vectorized execution library; see SURVEY.md).  Not a port: pipelines
compile to shape-stable XLA programs over HBM-resident column vectors; distribution
is a device mesh with collective exchange instead of serialized shuffles.

Layering (mirrors SURVEY.md §1, re-expressed for an accelerator):

  dtypes         logical types -> fixed-width device representations
  vector         fixed-capacity columnar batches (flat/dict/const + validity + masks)
  expr           typed expression IR compiled into jaxprs
  functions      Presto-semantic scalar/aggregate function packages
  plan           plan nodes + PlanBuilder (fully-specified physical plans, no SQL)
  exec           plan -> pipelines -> jitted tile programs; Task orchestration
  ops            compute kernels (masked reductions, sort, hash, partition)
  parallel       device mesh, distributed exchange via collectives
  io / connectors  host-side ingestion (Arrow/Parquet), TPC-H generator
  serde          row/page wire formats for external interchange
"""

import os

import jax

# DOUBLE/BIGINT columns need real float64/int64 end-to-end; without x64 JAX silently
# downcasts, which breaks row-exact parity with the reference.
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache.  JAX_COMPILATION_CACHE_DIR, when set,
# is read by JAX itself and wins; otherwise the cache sits at one fixed path
# inside the checkout: a directory that moves between processes never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
try:
    # honor a pre-import jax.config.update("jax_platforms", "cpu") too —
    # the env var alone misses it
    _platforms = jax.config.jax_platforms or os.environ.get(
        "JAX_PLATFORMS", ""
    )
except Exception:
    _platforms = os.environ.get("JAX_PLATFORMS", "")
# not for processes pinned to the CPU: CPU executables are specific to the
# host CPU's feature set and can fault when a cache is shared across hosts
if "cpu" not in _platforms.split(",")[:1]:
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # cache every program: a query builds dozens of small ones, and at the
    # default 1 s threshold each process would compile them all again
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.05)

from . import dtypes  # noqa: E402
from .dtypes import (  # noqa: E402,F401
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    REAL,
    SMALLINT,
    TIMESTAMP,
    TINYINT,
    UNKNOWN,
    VARBINARY,
    VARCHAR,
    DataType,
    RowType,
    TypeKind,
    decimal,
)
from .vector import Batch, Column, Encoding, StringTable  # noqa: E402,F401
from .functions import presto as _presto_functions  # noqa: E402,F401  (registers fns)
from .functions import spark as _spark_functions  # noqa: E402,F401  (registers fns)


def run_sql(sql, catalog, tile_rows=None):
    """Plan + execute a SQL SELECT over host Tables (sql/planner.py)."""
    from .sql import run_sql as _run

    return _run(sql, catalog, tile_rows)


def run_plan(plan, tile_rows=1 << 20):
    """Execute a PlanNode on the default backend (exec/runner.py)."""
    from .exec.runner import run_plan as _run

    return _run(plan, tile_rows)


__version__ = "0.1.0"
