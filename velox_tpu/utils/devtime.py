"""Per-program device-time attribution — the OperatorStats analog.

The reference wraps every Operator::addInput/getOutput call with CPU+wall
timers in the Driver loop (velox/exec/Driver.cpp:538-542, Operator.h:83) and
re-attributes them to plan nodes (PlanNodeStats.h:38).  Here the execution
unit is a dispatched XLA program, so attribution happens per PROGRAM: every
device dispatch site routes through :func:`tjit` (or the shared-sort
recorders), a :func:`capture` context collects the dispatch stream of one
query run, and :func:`measure` times each unique program honestly.

Timing that cannot be elided (a wall-clock time around one dispatch can
measure the enqueue rather than the work):

* generic (sort-free) programs: K data-DEPENDENT executions chained inside
  ONE dispatched program — every output folds into an int64 scalar that
  perturbs the next iteration's inputs by a provably-zero amount — timed
  K-vs-1 with a forced scalar fetch, then divided.  Same methodology as
  bench.py's whole-query device loop.
* canonical sort programs (ops/shared_sort.py): re-tracing them inside a
  chained wrapper would recompile the sort, so they are timed by
  SELF-FEEDING instead: dispatch the same compiled program M times, each
  feeding its own output back as input (a real data dependency), and fetch
  one scalar of the final output.  After the first pass the input is
  already sorted; on a GPU, sorting sorted input is not known to cost the
  same as sorting the original, so these times are an estimate (a profiler
  trace is the better source, ROADMAP.md).

Overhead when no capture is active: one list check per dispatch.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_ACTIVE: Optional[list] = None


class Record:
    """One device dispatch: the raw python callable, its concrete args, and
    how to re-execute it for timing ('generic' chained-K or 'selffeed')."""

    __slots__ = ("label", "fn", "args", "kind", "feed")

    def __init__(self, label, fn, args, kind="generic", feed=None):
        self.label = label
        self.fn = fn
        self.args = args
        self.kind = kind
        self.feed = feed  # selffeed: (out, args) -> next args


@contextlib.contextmanager
def capture():
    """Collect every instrumented dispatch under this context into a list."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = []
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def recording() -> bool:
    return _ACTIVE is not None


def record(label, fn, args, kind="generic", feed=None) -> None:
    if _ACTIVE is not None:
        _ACTIVE.append(Record(label, fn, args, kind, feed))


def tjit(fn: Callable = None, *, label: str = None, **jitkw):
    """``jax.jit`` plus dispatch capture.

    Keeps the raw python callable for later chained-K measurement.  Donated
    jits get a non-donating twin used only while a capture is active (a
    donated dispatch would delete the very buffers the record holds)."""
    if fn is None:
        return lambda f: tjit(f, label=label, **jitkw)
    jitted = jax.jit(fn, **jitkw)
    plain = jax.jit(fn) if "donate_argnums" in jitkw else jitted
    lbl = label or getattr(fn, "__name__", "program")

    @functools.wraps(fn)
    def wrapper(*args):
        if _ACTIVE is not None:
            _ACTIVE.append(Record(lbl, fn, args, "generic"))
            return plain(*args)
        return jitted(*args)

    wrapper._raw_fn = fn
    return wrapper


# ---------------------------------------------------------------------------
# measurement


def _fold(out) -> jax.Array:
    """Fold every array leaf of ``out`` into one int64 scalar (a data
    dependency on ALL results, so no part of the program can be elided)."""
    acc = jnp.zeros((), jnp.int64)
    for leaf in jax.tree_util.tree_leaves(out):
        if not hasattr(leaf, "dtype"):
            continue
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            acc = acc + jnp.nan_to_num(jnp.sum(leaf)).astype(jnp.int64)
        elif leaf.dtype == jnp.bool_:
            acc = acc + jnp.sum(leaf.astype(jnp.int64))
        else:
            acc = acc + jnp.sum(leaf.astype(jnp.int64))
    return acc


def _is_device_leaf(leaf) -> bool:
    return isinstance(leaf, jax.Array) and leaf.ndim >= 1


def _perturb(leaves, acc):
    """Add a REAL acc-dependent bit to every numeric array leaf.  A
    provably-zero perturbation gets hoisted by the simplifier (it then
    reports an "effective bandwidth" above the memory's) — measurement runs happen after the parity-checked run, so
    changing the values is fine."""
    bit = (acc & jnp.int64(1))
    out = []
    for leaf in leaves:
        if (
            hasattr(leaf, "ndim")
            and getattr(leaf, "ndim", 0) >= 1
            and hasattr(leaf, "dtype")
            and jnp.issubdtype(leaf.dtype, jnp.number)
        ):
            leaf = leaf + bit.astype(leaf.dtype)
        out.append(leaf)
    return out


def _time_best(fn, repeats):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _sig(rec: Record):
    """Dedup key: same raw fn + same arg structure/shapes = same program."""
    leaves, treedef = jax.tree_util.tree_flatten(rec.args)
    parts = []
    for leaf in leaves:
        if _is_device_leaf(leaf):
            parts.append((str(leaf.dtype), tuple(leaf.shape)))
        else:
            parts.append(repr(leaf)[:64])
    return (id(rec.fn), rec.kind, str(treedef), tuple(parts))


def _measure_generic(rec: Record, repeats: int, k: int) -> Optional[float]:
    fn = rec.fn
    leaves, treedef = jax.tree_util.tree_flatten(rec.args)
    dyn_idx = [i for i, l in enumerate(leaves) if _is_device_leaf(l)]
    dyn = [leaves[i] for i in dyn_idx]

    def rebuild(dyn_leaves):
        full = list(leaves)
        for i, l in zip(dyn_idx, dyn_leaves):
            full[i] = l
        return jax.tree_util.tree_unflatten(treedef, full)

    @jax.jit
    def chained(dyn_in, kk):
        def body(_, acc):
            args = rebuild(_perturb(dyn_in, acc))
            return acc + _fold(fn(*args))

        return jax.lax.fori_loop(0, kk, body, jnp.zeros((), jnp.int64))

    int(chained(dyn, 1))  # compile + warm (kk dynamic: ONE program)
    t1 = _time_best(lambda: int(chained(dyn, 1)), repeats)
    tk = _time_best(lambda: int(chained(dyn, k)), repeats)
    per = (tk - t1) / (k - 1)
    # sub-100ns per run means either a genuinely tiny (result-sized) program
    # or a hoisted body; the perturbation rules out hoisting, so report ~0
    return max(per, 0.0)


def _touch(out) -> None:
    """Force the dependency chain: fetch one scalar of the first array leaf."""
    for leaf in jax.tree_util.tree_leaves(out):
        if isinstance(leaf, jax.Array) and leaf.size:
            np.asarray(jax.jit(lambda a: a.reshape(-1)[0])(leaf))
            return


def _measure_selffeed(rec: Record, repeats: int, m: int) -> Optional[float]:
    fn, feed = rec.fn, rec.feed

    def run(mm):
        args = rec.args
        out = fn(*args)
        for _ in range(mm - 1):
            args = feed(out, args)
            out = fn(*args)
        _touch(out)

    run(1)  # warm
    t1 = _time_best(lambda: run(1), repeats)
    tm = _time_best(lambda: run(m), repeats)
    return max((tm - t1) / (m - 1), 0.0)


def measure(
    records: Sequence[Record], repeats: int = 3, k: int = 9
) -> List[dict]:
    """Time every captured dispatch; one measurement per unique program.

    Returns one dict per distinct label: {label, calls, seconds (total across
    calls), per_call} — unmeasurable programs report seconds=None."""
    cache: dict = {}
    by_label: dict = {}
    for rec in records:
        sig = _sig(rec)
        if sig in cache:
            per = cache[sig]
        else:
            try:
                if rec.kind == "selffeed":
                    per = _measure_selffeed(rec, repeats, k)
                elif rec.kind == "generic" and rec.fn is not None:
                    per = _measure_generic(rec, repeats, k)
                else:
                    per = None
            except Exception:
                per = None
            cache[sig] = per
        arg_bytes = sum(
            leaf.nbytes
            for leaf in jax.tree_util.tree_leaves(rec.args)
            if _is_device_leaf(leaf)
        )
        slot = by_label.setdefault(
            rec.label, {"label": rec.label, "calls": 0, "seconds": 0.0,
                        "arg_bytes": 0, "unmeasured_calls": 0}
        )
        slot["calls"] += 1
        slot["arg_bytes"] += arg_bytes
        if per is None:
            slot["unmeasured_calls"] += 1
        else:
            slot["seconds"] += per
    out = []
    for slot in by_label.values():
        if slot["calls"] == slot["unmeasured_calls"]:
            slot["seconds"] = None
        else:
            slot["seconds"] = round(slot["seconds"], 6)
        if not slot["unmeasured_calls"]:
            del slot["unmeasured_calls"]
        out.append(slot)
    return out
