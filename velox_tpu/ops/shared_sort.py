"""Canonical shared sort programs — the engine's answer to sort compile cost.

On the engine's first target a program containing ONE `jax.lax.sort` cost
tens of seconds to compile, while sort-free glue programs compiled in
seconds, so a query-specific fused program with sorts inside paid minutes
of cold compile.  Whether XLA's GPU compiler has the same cost is not
measured yet: `chip_smoke.py` prints each query's first-run (compile) and
warm seconds so the premise can be re-tested (config.split_sort_programs).

The fix is architectural: execution SPLITS at sort boundaries, and every
sort dispatches through this module's canonical jitted programs keyed by
(row count, payload bucket).  Payload operands are bitcast to int64 and
padded to bucket sizes {0, 1, 2, 4, 8}, so ALL queries with the same tile
bucket share a handful of compiled sorts — compiled once per machine
(persistent XLA cache) instead of once per query program.  Glue between
sorts stays fused and cheap.

Runtime cost of the canonicalization is small: payloads already ride
sorts as non-key operands instead of being gathered after the sort,
bitcasting is free, and a padded zero operand costs one operand's ride only
when the bucket rounds up.

Reference analog: the reference pays this cost at C++ compile time once per
BINARY (vectorized sort/probe templates, velox/exec/HashTable.cpp:360);
here the compiled-once artifact is the XLA executable in the persistent
cache.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

_LOG = os.environ.get("VELOX_TPU_LOG_COMPILES", "") not in ("", "0")


def _logged(fn, label):
    """Wrap a canonical program so its first (compiling) dispatch is timed
    when VELOX_TPU_LOG_COMPILES is set — compile-time visibility."""
    if not _LOG:
        return fn
    state = {"first": True}

    def wrapped(*a):
        if state["first"]:
            state["first"] = False
            t0 = time.perf_counter()
            out = fn(*a)
            jax.block_until_ready(out)
            print(
                f"[shared_sort] {label}: first dispatch "
                f"{time.perf_counter() - t0:.1f}s",
                file=sys.stderr,
                flush=True,
            )
            return out
        return fn(*a)

    return wrapped

# payload-count buckets: every canonical program sorts ONE int64 key operand
# plus `bucket` int64 payload operands
_BUCKETS = (0, 1, 2, 4, 8)

_PROGRAMS: Dict[Tuple[int, int], object] = {}


def payload_bucket(n_payloads: int) -> int:
    for b in _BUCKETS:
        if n_payloads <= b:
            return b
    raise ValueError(
        f"{n_payloads} sort payloads exceed the canonical maximum "
        f"({_BUCKETS[-1]}); fuse or split the payload set"
    )


def _program(n: int, bucket: int):
    key = (n, bucket)
    fn = _PROGRAMS.get(key)
    if fn is None:

        @jax.jit
        def _sort(word, payloads):
            out = jax.lax.sort([word] + list(payloads), num_keys=1)
            return out[0], tuple(out[1:])

        fn = _logged(_sort, f"word n={n} bucket={bucket}")
        _PROGRAMS[key] = fn
    return fn


def _to_i64(a: jax.Array) -> jax.Array:
    """Invertible int64 encoding for a payload operand (values must survive
    the ride exactly; ORDER comes from the key word, never from payloads)."""
    from .f64bits import f32_to_bits64, f64_to_word, u64_to_i64

    if a.dtype == jnp.int64:
        return a
    if a.dtype == jnp.float64:
        return f64_to_word(a)  # the IEEE bits (ops/f64bits.py)
    if a.dtype == jnp.float32:
        # 32-bit bitcast, sign-extended (a plain astype would TRUNCATE the
        # fraction — round-4 advisor finding)
        return f32_to_bits64(a)
    if a.dtype == jnp.uint64:
        return u64_to_i64(a)
    # bool / small ints: widen
    return a.astype(jnp.int64)


def _from_i64(a: jax.Array, dtype) -> jax.Array:
    from .f64bits import bits64_to_f32, i64_to_u64, word_to_f64

    if dtype == jnp.int64:
        return a
    if dtype == jnp.float64:
        return word_to_f64(a)
    if dtype == jnp.float32:
        return bits64_to_f32(a)
    if dtype == jnp.uint64:
        return i64_to_u64(a)
    return a.astype(dtype)


def shared_sort_word(
    word: jax.Array, payloads: Sequence[jax.Array] = ()
) -> Tuple[jax.Array, List[jax.Array]]:
    """Sort by one fully-packed int64 key word; payloads ride as non-key
    operands.  Dispatches the canonical cached program for this
    (length, payload-bucket) — callers MUST invoke this at host level (not
    inside jit; tracing it would inline the sort back into the caller's
    program and re-create the per-program compile cost)."""
    from ..utils import devtime

    n = word.shape[0]
    dtypes = [p.dtype for p in payloads]
    ps = [_to_i64(p) for p in payloads]
    bucket = payload_bucket(len(ps))
    while len(ps) < bucket:
        ps.append(jnp.zeros((n,), jnp.int64))
    prog = _program(n, bucket)
    devtime.record(
        f"sort:word[n={n},b={bucket}]", prog, (word, tuple(ps)),
        kind="selffeed", feed=lambda o, a: (o[0], o[1]),
    )
    s_word, s_ps = prog(word, tuple(ps))
    return s_word, [
        _from_i64(p, dt) for p, dt in zip(s_ps[: len(dtypes)], dtypes)
    ]


_MULTI_PROGRAMS: Dict[Tuple[int, int, int], object] = {}


def _multi_program(n: int, n_keys: int, bucket: int):
    key = (n, n_keys, bucket)
    fn = _MULTI_PROGRAMS.get(key)
    if fn is None:

        @jax.jit
        def _sort(keys, payloads):
            out = jax.lax.sort(
                list(keys) + list(payloads), num_keys=len(keys)
            )
            return tuple(out[: len(keys)]), tuple(out[len(keys):])

        fn = _logged(_sort, f"multi n={n} keys={n_keys} bucket={bucket}")
        _MULTI_PROGRAMS[key] = fn
    return fn


def shared_sort_ops(
    key_ops: Sequence[jax.Array], payload_ops: Sequence[jax.Array]
) -> Tuple[List[jax.Array], List[jax.Array]]:
    """Multi-key canonical sort: every operand is carried as int64 (order of
    int64-converted bool/int keys matches the original order).  Same host-
    level dispatch contract as shared_sort_word."""
    n = key_ops[0].shape[0]
    kdt = [k.dtype for k in key_ops]
    pdt = [p.dtype for p in payload_ops]
    for k in key_ops:
        if k.dtype in (jnp.float64, jnp.uint64):
            raise TypeError(
                "shared_sort_ops keys must be order-preserving under int64 "
                "conversion (bool / signed ints)"
            )
    from ..utils import devtime

    ks = [k.astype(jnp.int64) for k in key_ops]
    ps = [_to_i64(p) for p in payload_ops]
    bucket = payload_bucket(len(ps))
    while len(ps) < bucket:
        ps.append(jnp.zeros((n,), jnp.int64))
    prog = _multi_program(n, len(ks), bucket)
    devtime.record(
        f"sort:multi[n={n},k={len(ks)},b={bucket}]", prog,
        (tuple(ks), tuple(ps)),
        kind="selffeed", feed=lambda o, a: (o[0], o[1]),
    )
    s_ks, s_ps = prog(tuple(ks), tuple(ps))
    return (
        [k.astype(dt) for k, dt in zip(s_ks, kdt)],
        [_from_i64(p, dt) for p, dt in zip(s_ps[: len(pdt)], pdt)],
    )


_STABLE_PROGRAMS: Dict[int, object] = {}


def _stable_program(n: int):
    """Canonical stable radix pass: gather the word into the running
    permutation's order INSIDE the program (one dispatch per pass, and the
    gather fuses with the sort's operand staging)."""
    fn = _STABLE_PROGRAMS.get(n)
    if fn is None:

        @jax.jit
        def _pass(word, perm):
            wp = jnp.take(word, perm.astype(jnp.int32), mode="clip")
            out = jax.lax.sort(
                [wp, perm.astype(jnp.int64)], num_keys=1, is_stable=True
            )
            return out[1]

        fn = _logged(_pass, f"stable n={n}")
        _STABLE_PROGRAMS[n] = fn
    return fn


def chained_lex_sort(words: Sequence[jax.Array]) -> jax.Array:
    """Lexicographic sort permutation over int64 key words, as LSD-radix
    passes of ONE canonical stable single-key program, compiled once and
    shared by every multi-key consumer at this shape (a fused multi-operand
    sort compiled for tens of minutes on the engine's first target).

    Each pass stably sorts the running permutation by its word (gathered to
    the current order inside the canonical program), so after processing
    words last-to-first the permutation is ordered by (words[0], words[1],
    ..., input position).  Returns perm (int32): perm[i] = input row in
    output slot i."""
    from ..utils import devtime

    n = words[0].shape[0]
    perm = jnp.arange(n, dtype=jnp.int32)
    prog = _stable_program(n)
    for w in reversed(list(words)):
        devtime.record(
            f"sort:radix_pass[n={n}]", prog, (w, perm),
            kind="selffeed",
            feed=lambda o, a: (a[0], o.astype(jnp.int32)),
        )
        perm = prog(w, perm).astype(jnp.int32)
    return perm


def warm(n: int, buckets: Sequence[int] = (0, 1, 2)) -> None:
    """Precompile canonical programs for a row count (cache warming)."""
    word = jnp.zeros((n,), jnp.int64)
    for b in buckets:
        _program(n, b)(word, tuple(jnp.zeros((n,), jnp.int64) for _ in range(b)))
