"""Spark-semantic scalar functions.

Reference: velox/functions/sparksql/ (Register.cpp — 62 registrations;
Hash.cpp murmur3/xxhash64, Arithmetic.h pmod, DateTimeFunctions.h, legacy
size()).  Device-native where the math is lane-wise (hash, pmod, shifts,
date arithmetic); dictionary-rewrite binders for the string family, like the
Presto package.

Spark vs Presto semantic differences carried faithfully:
* ``pmod`` returns a non-negative remainder and NULL on zero divisor;
* ``size(NULL)`` is -1 (legacy spark.sql.legacy.sizeOfNull=true, the default
  the reference implements);
* ``hash``/``xxhash64`` are Spark's exact Murmur3_x86_32 / XXH64 with seed 42
  so shuffles can interoperate with Spark partitioning (Gluten's use case);
* ``date_add(date, n)`` / ``datediff(end, start)`` use Spark's argument
  shapes (the Presto package's date_add('unit', n, date) coexists — the
  registry disambiguates by signature).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ...dtypes import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    DataType,
    TypeKind,
)
from ...expr.registry import (
    ANY,
    DEFAULT_REGISTRY,
    INTEGER as INT_M,
    NUMERIC,
    STRINGY,
)

_reg = DEFAULT_REGISTRY
_DATE = DATE
_VARCHAR = DataType(TypeKind.VARCHAR)


# ---------------------------------------------------------------------------
# Spark Murmur3_x86_32 (reference: velox/functions/sparksql/Hash.cpp)

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl32(x, r):
    return (x << r) | (x >> (32 - r))


def _mix_k1(k1):
    k1 = k1 * _C1
    k1 = _rotl32(k1, 15)
    return k1 * _C2


def _mix_h1(h1, k1):
    h1 = h1 ^ k1
    h1 = _rotl32(h1, 13)
    return h1 * jnp.uint32(5) + jnp.uint32(0xE6546B64)


def _fmix(h1, length):
    h1 = h1 ^ jnp.uint32(length)
    h1 = h1 ^ (h1 >> 16)
    h1 = h1 * jnp.uint32(0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = h1 * jnp.uint32(0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _murmur3_int(v32, seed):
    return _fmix(_mix_h1(seed, _mix_k1(v32)), 4)


def _murmur3_long(v64, seed):
    u = v64.astype(jnp.uint64)
    low = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    high = (u >> 32).astype(jnp.uint32)
    h1 = _mix_h1(seed, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _fmix(h1, 8)


def _spark_hash_one(values, dtype: DataType, seed):
    kind = dtype.kind
    if kind in (TypeKind.INTEGER, TypeKind.DATE, TypeKind.SMALLINT, TypeKind.TINYINT):
        return _murmur3_int(values.astype(jnp.int32).view(jnp.uint32), seed)
    if kind == TypeKind.BOOLEAN:
        return _murmur3_int(values.astype(jnp.uint32), seed)
    if kind == TypeKind.REAL:
        return _murmur3_int(values.astype(jnp.float32).view(jnp.uint32), seed)
    if kind == TypeKind.DOUBLE:
        return _murmur3_long(values.astype(jnp.float64).view(jnp.int64), seed)
    # BIGINT / TIMESTAMP / short DECIMAL hash as long
    return _murmur3_long(values.astype(jnp.int64), seed)


def _spark_hash(ctx, result_dtype, arg_types, *packed):
    seed = jnp.uint32(42)
    h = jnp.full((ctx.capacity,), seed, jnp.uint32)
    for (values, validity), t in zip(packed, arg_types):
        nh = _spark_hash_one(values, t, h)
        h = nh if validity is None else jnp.where(validity, nh, h)
    return h.view(jnp.int32).astype(jnp.int32), None


# ---------------------------------------------------------------------------
# Spark XXH64 with seed 42 (reference: velox/functions/sparksql/Hash.cpp)

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)
_XXH_SEED = np.uint64(42)


def _rotl64(x, r):
    return (x << r) | (x >> (64 - r))


def _xxh64_long(v64, seed_u64):
    h = seed_u64 + _P5 + jnp.uint64(8)
    k1 = v64.astype(jnp.uint64) * _P2
    k1 = _rotl64(k1, 31)
    k1 = k1 * _P1
    h = h ^ k1
    h = _rotl64(h, 27) * _P1 + _P4
    h = h ^ (h >> 33)
    h = h * _P2
    h = h ^ (h >> 29)
    h = h * _P3
    return h ^ (h >> 32)


def _xxh64_int(v32, seed_u64):
    h = seed_u64 + _P5 + jnp.uint64(4)
    k = v32.astype(jnp.uint32).astype(jnp.uint64) * _P1
    h = h ^ _rotl64(k, 23) * _P2
    h = _rotl64(h, 23) * _P2 + _P3
    h = h ^ (h >> 33)
    h = h * _P2
    h = h ^ (h >> 29)
    h = h * _P3
    return h ^ (h >> 32)


def _spark_xxhash64(ctx, result_dtype, arg_types, *packed):
    h = jnp.full((ctx.capacity,), _XXH_SEED, jnp.uint64)
    for (values, validity), t in zip(packed, arg_types):
        kind = t.kind
        if kind in (
            TypeKind.INTEGER, TypeKind.DATE, TypeKind.SMALLINT, TypeKind.TINYINT
        ):
            nh = _xxh64_int(values.astype(jnp.int32).view(jnp.uint32), h)
        elif kind == TypeKind.BOOLEAN:
            nh = _xxh64_int(values.astype(jnp.uint32), h)
        elif kind == TypeKind.REAL:
            nh = _xxh64_int(values.astype(jnp.float32).view(jnp.uint32), h)
        elif kind == TypeKind.DOUBLE:
            nh = _xxh64_long(
                values.astype(jnp.float64).view(jnp.int64).astype(jnp.uint64), h
            )
        else:
            nh = _xxh64_long(values.astype(jnp.int64).astype(jnp.uint64), h)
        h = nh if validity is None else jnp.where(validity, nh, h)
    return h.view(jnp.int64), None


# ---------------------------------------------------------------------------
# arithmetic / conditional


def _pmod(ctx, result_dtype, arg_types, a, b):
    # ((a % b) + b) % b; NULL on zero divisor (Spark returns NULL, not error)
    av, avalid = a
    bv, bvalid = b
    zero = bv == 0
    safe = jnp.where(zero, jnp.ones_like(bv), bv)
    if jnp.issubdtype(av.dtype, jnp.integer):
        r = ((av % safe) + safe) % safe
    else:
        r = jnp.mod(jnp.mod(av, safe) + safe, safe)
    validity = ~zero
    if avalid is not None:
        validity = validity & avalid
    if bvalid is not None:
        validity = validity & bvalid
    return r, validity


def _nanvl(ctx, result_dtype, arg_types, a, b):
    av, avalid = a
    bv, bvalid = b
    take_b = jnp.isnan(av.astype(jnp.float64))
    values = jnp.where(take_b, bv, av)
    validity = None
    if avalid is not None or bvalid is not None:
        va = avalid if avalid is not None else jnp.ones_like(take_b)
        vb = bvalid if bvalid is not None else jnp.ones_like(take_b)
        validity = jnp.where(take_b, vb, va)
    return values, validity


def _nvl(ctx, result_dtype, arg_types, a, b):
    av, avalid = a
    bv, bvalid = b
    if avalid is None:
        return av, None
    values = jnp.where(avalid, av, bv)
    validity = avalid if bvalid is None else (avalid | bvalid)
    return values, validity


# ---------------------------------------------------------------------------
# date/time (Spark argument shapes)


def _date_add(ctx, result_dtype, arg_types, d, n):
    return (d.astype(jnp.int32) + n.astype(jnp.int32)).astype(jnp.int32)


def _date_sub(ctx, result_dtype, arg_types, d, n):
    return (d.astype(jnp.int32) - n.astype(jnp.int32)).astype(jnp.int32)


def _datediff(ctx, result_dtype, arg_types, end, start):
    return (end.astype(jnp.int64) - start.astype(jnp.int64)).astype(jnp.int32)


def _civil(days):
    """days-since-epoch -> (year, month, day) via the Howard Hinnant civil
    algorithm, branch-free (same derivation as the Presto date family)."""
    z = days.astype(jnp.int64) + 719468
    era = jnp.floor_divide(jnp.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = jnp.floor_divide(
        doe - jnp.floor_divide(doe, 1460) + jnp.floor_divide(doe, 36524)
        - jnp.floor_divide(doe, 146096),
        365,
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + jnp.floor_divide(yoe, 4) - jnp.floor_divide(yoe, 100))
    mp = jnp.floor_divide(5 * doy + 2, 153)
    d = doy - jnp.floor_divide(153 * mp + 2, 5) + 1
    m = jnp.where(mp < 10, mp + 3, mp - 9)
    y = jnp.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    y = jnp.where(m <= 2, y - 1, y)
    era = jnp.floor_divide(jnp.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = jnp.floor_divide(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + jnp.floor_divide(yoe, 4) - jnp.floor_divide(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_in_month(y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    lengths = jnp.asarray([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
    base = jnp.take(lengths, (m - 1).astype(jnp.int32), mode="clip")
    return jnp.where((m == 2) & leap, 29, base)


def _add_months(ctx, result_dtype, arg_types, d, n):
    y, m, day = _civil(d)
    months = (y * 12 + (m - 1)) + n.astype(jnp.int64)
    ny = jnp.floor_divide(months, 12)
    nm = months - ny * 12 + 1
    nd = jnp.minimum(day, _days_in_month(ny, nm))
    return _days_from_civil(ny, nm, nd).astype(jnp.int32)


def _months_between(ctx, result_dtype, arg_types, a, b):
    ya, ma, da = _civil(a)
    yb, mb, db = _civil(b)
    whole = (ya * 12 + ma) - (yb * 12 + mb)
    last_a = da == _days_in_month(ya, ma)
    last_b = db == _days_in_month(yb, mb)
    both_last = last_a & last_b
    frac = (da - db).astype(jnp.float64) / 31.0
    out = whole.astype(jnp.float64) + jnp.where(both_last, 0.0, frac)
    return jnp.round(out, 8)


def _unix_timestamp(ctx, result_dtype, arg_types, ts):
    return jnp.floor_divide(ts.astype(jnp.int64), 1_000_000)


def _from_unixtime_ts(ctx, result_dtype, arg_types, secs):
    return secs.astype(jnp.int64) * 1_000_000


def _unix_date(ctx, result_dtype, arg_types, d):
    return d.astype(jnp.int32)


# ---------------------------------------------------------------------------
# math


def _f64(v, t: DataType):
    """Decimal-aware float64 view (unscaled int -> real value)."""
    out = v.astype(jnp.float64)
    if t.kind == TypeKind.DECIMAL and t.scale:
        out = out / (10.0 ** t.scale)
    return out


def _hypot(ctx, result_dtype, arg_types, a, b):
    return jnp.hypot(_f64(a, arg_types[0]), _f64(b, arg_types[1]))


def _log1p(ctx, result_dtype, arg_types, a):
    return jnp.log1p(_f64(a, arg_types[0]))


def _expm1(ctx, result_dtype, arg_types, a):
    return jnp.expm1(_f64(a, arg_types[0]))


def _rint(ctx, result_dtype, arg_types, a):
    return jnp.rint(_f64(a, arg_types[0]))


def _shift(dir_):
    def impl(ctx, result_dtype, arg_types, a, n):
        av = a.astype(jnp.int64) if arg_types[0].kind == TypeKind.BIGINT else a.astype(jnp.int32)
        bits = 64 if arg_types[0].kind == TypeKind.BIGINT else 32
        nn = n.astype(av.dtype) & (bits - 1)  # Spark masks the shift amount
        return (av << nn) if dir_ == "left" else (av >> nn)

    return impl


# ---------------------------------------------------------------------------
# operator-name functions (Spark registers its operators as named functions so
# substrait/Gluten plans can call them by name: sparksql/RegisterArithmetic.cpp
# add/subtract/..., RegisterCompare.cpp equalto/...)


def _arith(op):
    def impl(ctx, result_dtype, arg_types, a, b):
        if op == "add":
            return a + b
        if op == "subtract":
            return a - b
        # remainder: Spark % — NULL on zero divisor, sign follows dividend
        zero = b == 0
        safe = jnp.where(zero, jnp.ones_like(b), b)
        if jnp.issubdtype(a.dtype, jnp.integer):
            r = a - jnp.trunc(
                a.astype(jnp.float64) / safe.astype(jnp.float64)
            ).astype(a.dtype) * safe
        else:
            r = a - jnp.trunc(a / safe) * safe
        return r, ~zero

    return impl


def _remainder(ctx, result_dtype, arg_types, a, b):
    av, avalid = a
    bv, bvalid = b
    zero = bv == 0
    safe = jnp.where(zero, jnp.ones_like(bv), bv)
    if jnp.issubdtype(av.dtype, jnp.integer):
        q = jnp.trunc(av.astype(jnp.float64) / safe.astype(jnp.float64))
        r = av - q.astype(av.dtype) * safe
    else:
        r = av - jnp.trunc(av / safe) * safe
    validity = ~zero
    if avalid is not None:
        validity = validity & avalid
    if bvalid is not None:
        validity = validity & bvalid
    return r, validity


def _unaryminus(ctx, result_dtype, arg_types, a):
    return -a


def _cmp(op):
    def impl(ctx, result_dtype, arg_types, a, b):
        if op == "eq":
            return a == b
        if op == "gt":
            return a > b
        if op == "ge":
            return a >= b
        if op == "lt":
            return a < b
        return a <= b

    return impl


def _equalnullsafe(ctx, result_dtype, arg_types, a, b):
    # <=> : TRUE when both NULL, FALSE when exactly one is; never NULL
    av, avalid = a
    bv, bvalid = b
    va = avalid if avalid is not None else jnp.ones(av.shape, jnp.bool_)
    vb = bvalid if bvalid is not None else jnp.ones(bv.shape, jnp.bool_)
    eq = (av == bv) & va & vb
    return eq | (~va & ~vb), None


def _isnull(ctx, result_dtype, arg_types, a):
    av, avalid = a
    if avalid is None:
        return jnp.zeros(av.shape, jnp.bool_), None
    return ~avalid, None


def _isnotnull(ctx, result_dtype, arg_types, a):
    av, avalid = a
    if avalid is None:
        return jnp.ones(av.shape, jnp.bool_), None
    return avalid, None


# ---------------------------------------------------------------------------
# math tail (sparksql/Arithmetic.h sec/csc/cot)


def _trig_recip(which):
    def impl(ctx, result_dtype, arg_types, a):
        x = _f64(a, arg_types[0])
        if which == "sec":
            return 1.0 / jnp.cos(x)
        if which == "csc":
            return 1.0 / jnp.sin(x)
        return jnp.cos(x) / jnp.sin(x)  # cot

    return impl


# ---------------------------------------------------------------------------
# date tail (sparksql/DateTimeFunctions.h)


def _dayofmonth(ctx, result_dtype, arg_types, d):
    _, _, day = _civil(d)
    return day.astype(jnp.int32)


def _dayofweek(ctx, result_dtype, arg_types, d):
    # Spark: 1 = Sunday .. 7 = Saturday (Presto dow is ISO 1=Mon..7=Sun).
    # 1970-01-01 was a Thursday (weekday index 4 with Sunday=0 ... Thursday=4).
    days = d.astype(jnp.int64)
    return (jnp.mod(days + 4, 7) + 1).astype(jnp.int32)


def _dayofyear(ctx, result_dtype, arg_types, d):
    y, _, _ = _civil(d)
    jan1 = _days_from_civil(y, jnp.ones_like(y), jnp.ones_like(y))
    return (d.astype(jnp.int64) - jan1 + 1).astype(jnp.int32)


def _last_day(ctx, result_dtype, arg_types, d):
    y, m, _ = _civil(d)
    return _days_from_civil(y, m, _days_in_month(y, m)).astype(jnp.int32)


def _make_date(ctx, result_dtype, arg_types, y, m, d):
    yv, yvalid = y
    mv, mvalid = m
    dv, dvalid = d
    yy = yv.astype(jnp.int64)
    mm = mv.astype(jnp.int64)
    dd = dv.astype(jnp.int64)
    ok = (mm >= 1) & (mm <= 12) & (dd >= 1)
    safe_m = jnp.clip(mm, 1, 12)
    ok = ok & (dd <= _days_in_month(yy, safe_m))
    for v in (yvalid, mvalid, dvalid):
        if v is not None:
            ok = ok & v
    out = _days_from_civil(yy, safe_m, jnp.clip(dd, 1, 31))
    return out.astype(jnp.int32), ok  # NULL on invalid (non-ANSI Spark)


def _to_unix_timestamp_date(ctx, result_dtype, arg_types, d):
    return d.astype(jnp.int64) * 86400


# ---------------------------------------------------------------------------
# rand (sparksql/Rand.h): per-row uniform [0,1).  Spark's rand(seed) streams
# xorshift per partition; exact stream parity is not meaningful across
# engines, so this uses a splitmix64 counter keyed by (seed, row index).
# Deviation (documented): rand() without a seed fixes its seed at plan-bind
# time (XLA programs are traced once; a fresh seed per ROW still holds, a
# fresh seed per QUERY RUN of the same compiled program does not).


def _rand_impl(seed_val):
    def impl(ctx, result_dtype, arg_types, *maybe_seed):
        idx = jnp.arange(ctx.capacity, dtype=jnp.uint64)
        if maybe_seed:
            s = maybe_seed[0].astype(jnp.int64).astype(jnp.uint64)
        else:
            s = jnp.uint64(seed_val & 0xFFFFFFFFFFFFFFFF)
        z = idx * jnp.uint64(0x9E3779B97F4A7C15) + s
        z = (z ^ (z >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> 27)) * jnp.uint64(0x94D049BB133111EB)
        z = z ^ (z >> 31)
        return (z >> 11).astype(jnp.float64) * (1.0 / (1 << 53))

    return impl


def _hash_with_seed(ctx, result_dtype, arg_types, seed, *packed):
    sv, _ = seed
    h = jnp.broadcast_to(
        sv.astype(jnp.int32).view(jnp.uint32), (ctx.capacity,)
    )
    for (values, validity), t in zip(packed, arg_types[1:]):
        nh = _spark_hash_one(values, t, h)
        h = nh if validity is None else jnp.where(validity, nh, h)
    return h.view(jnp.int32).astype(jnp.int32), None


def _xxhash64_with_seed(ctx, result_dtype, arg_types, seed, *packed):
    sv, _ = seed
    h = jnp.broadcast_to(
        sv.astype(jnp.int64).astype(jnp.uint64), (ctx.capacity,)
    )
    for (values, validity), t in zip(packed, arg_types[1:]):
        kind = t.kind
        if kind in (
            TypeKind.INTEGER, TypeKind.DATE, TypeKind.SMALLINT,
            TypeKind.TINYINT,
        ):
            nh = _xxh64_int(values.astype(jnp.int32).view(jnp.uint32), h)
        elif kind == TypeKind.BOOLEAN:
            nh = _xxh64_int(values.astype(jnp.uint32), h)
        elif kind == TypeKind.REAL:
            nh = _xxh64_int(values.astype(jnp.float32).view(jnp.uint32), h)
        elif kind == TypeKind.DOUBLE:
            nh = _xxh64_long(
                values.astype(jnp.float64).view(jnp.int64).astype(jnp.uint64),
                h,
            )
        else:
            nh = _xxh64_long(values.astype(jnp.int64).astype(jnp.uint64), h)
        h = nh if validity is None else jnp.where(validity, nh, h)
    return h.view(jnp.int64), None


# ---------------------------------------------------------------------------
# string tail: host-per-dictionary-entry helpers (sparksql/String.h family)


def _spark_left(v, _ci, n):
    n = int(n)
    return v[:n] if n > 0 else ""


def _overlay(v, _ci, repl, pos, length=None):
    pos = int(pos)
    ln = len(repl) if length is None else int(length)
    if pos < 1:
        pos = 1
    return v[: pos - 1] + repl + v[pos - 1 + max(ln, 0):]


def _substring_index(v, _ci, delim, count):
    count = int(count)
    if count == 0 or not delim:
        return ""
    parts = v.split(delim)
    if count > 0:
        return delim.join(parts[:count])
    return delim.join(parts[count:])


def _conv(v, _ci, from_base, to_base):
    from_base, to_base = int(from_base), int(to_base)
    if not (2 <= from_base <= 36) or not (2 <= abs(to_base) <= 36):
        return ""
    try:
        n = int(v.strip(), from_base)
    except ValueError:
        return "0"
    if n < 0 and to_base > 0:
        n &= (1 << 64) - 1  # Spark treats negatives as unsigned 64-bit
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    neg = n < 0
    n = abs(n)
    out = ""
    base = abs(to_base)
    while True:
        out = digits[n % base] + out
        n //= base
        if n == 0:
            break
    return ("-" + out) if neg else out


def _sha2(v, _ci, bits):
    import hashlib

    bits = int(bits)
    algo = {0: "sha256", 224: "sha224", 256: "sha256",
            384: "sha384", 512: "sha512"}.get(bits)
    if algo is None:
        return ""
    return getattr(hashlib, algo)(v.encode("utf-8")).hexdigest()


def register_all() -> None:
    """Idempotent registration into the default registry."""
    if getattr(register_all, "_done", False):
        return
    register_all._done = True

    def same(ts):
        return ts[0]

    _reg.register("pmod", [NUMERIC, NUMERIC], same, _pmod,
                  null_aware=True, coerce_common_numeric=True)
    _reg.register("nanvl", [NUMERIC, NUMERIC], same, _nanvl,
                  null_aware=True, coerce_common_numeric=True)
    for nm in ("nvl", "ifnull"):
        _reg.register(nm, [ANY, ANY], same, _nvl,
                      null_aware=True, coerce_common_numeric=True)
    _reg.register("hash", [ANY], INTEGER, _spark_hash,
                  null_aware=True, variadic=True)
    _reg.register("xxhash64", [ANY], BIGINT, _spark_xxhash64,
                  null_aware=True, variadic=True)
    _reg.register("shiftleft", [INT_M, INT_M], same, _shift("left"))
    _reg.register("shiftright", [INT_M, INT_M], same, _shift("right"))
    _reg.register("hypot", [NUMERIC, NUMERIC], DOUBLE, _hypot)
    _reg.register("log1p", [NUMERIC], DOUBLE, _log1p)
    _reg.register("expm1", [NUMERIC], DOUBLE, _expm1)
    _reg.register("rint", [NUMERIC], DOUBLE, _rint)

    _reg.register("date_add", [TypeKind.DATE, INT_M], _DATE, _date_add)
    _reg.register("date_sub", [TypeKind.DATE, INT_M], _DATE, _date_sub)
    _reg.register(
        "datediff", [TypeKind.DATE, TypeKind.DATE], INTEGER, (_datediff)
    )
    _reg.register("add_months", [TypeKind.DATE, INT_M], _DATE, (_add_months))
    _reg.register(
        "months_between",
        [TypeKind.DATE, TypeKind.DATE],
        DOUBLE,
        (_months_between),
    )
    _reg.register(
        "unix_timestamp", [TypeKind.TIMESTAMP], BIGINT, (_unix_timestamp)
    )
    _reg.register(
        "from_unixtime", [INT_M], DataType(TypeKind.TIMESTAMP),
        (_from_unixtime_ts),
    )
    _reg.register("unix_date", [TypeKind.DATE], INTEGER, (_unix_date))

    # string family: Spark-specific dictionary rewrites (binding.py)
    from ...expr import binding as _b

    _b._STRING_FN_BINDERS.update(
        {
            "ascii": _b._literal_args_fn(
                BIGINT, np.int64, lambda v, _ci: ord(v[0]) if v else -1
            ),
            "instr": _b._literal_args_fn(
                BIGINT, np.int64, lambda v, _ci, sub: v.find(sub) + 1
            ),
            "translate": _b._literal_args_fn(
                None,
                None,
                lambda v, _ci, src, dst: v.translate(
                    str.maketrans(src[: len(dst)], dst[: len(src)])
                ),
                makes_strings=True,
            ),
            "levenshtein": _b._literal_args_fn(
                BIGINT, np.int64, _levenshtein
            ),
            "soundex": _b._literal_args_fn(
                None, None, _soundex, makes_strings=True
            ),
            "crc32": _b._literal_args_fn(
                BIGINT,
                np.int64,
                lambda v, _ci: __import__("zlib").crc32(v.encode("utf-8")),
            ),
            "hash": _bind_string_hash("murmur3"),
            "xxhash64": _bind_string_hash("xxh64"),
            "startswith": _b._literal_args_fn(
                BOOLEAN, np.bool_, lambda v, _ci, p: v.startswith(p)
            ),
            "endswith": _b._literal_args_fn(
                BOOLEAN, np.bool_, lambda v, _ci, p: v.endswith(p)
            ),
            "left": _b._literal_args_fn(
                None, None, _spark_left, makes_strings=True
            ),
            "overlay": _b._literal_args_fn(
                None, None, _overlay, makes_strings=True
            ),
            "substring_index": _b._literal_args_fn(
                None, None, _substring_index, makes_strings=True
            ),
            "rlike": _b._literal_args_fn(
                BOOLEAN, np.bool_,
                lambda v, _ci, p: __import__("re").search(p, v) is not None,
            ),
            "get_json_object": _b._literal_args_fn(
                None, None, _b._json_extract, makes_strings=True
            ),
            "conv": _b._literal_args_fn(
                None, None, _conv, makes_strings=True
            ),
            "sha2": _b._literal_args_fn(
                None, None, _sha2, makes_strings=True
            ),
        }
    )
    for nm, matchers, rt in (
        ("ascii", [STRINGY], BIGINT),
        ("instr", [STRINGY, STRINGY], BIGINT),
        ("translate", [STRINGY, STRINGY, STRINGY], _VARCHAR),
        ("levenshtein", [STRINGY, STRINGY], BIGINT),
        ("soundex", [STRINGY], _VARCHAR),
        ("crc32", [STRINGY], BIGINT),
    ):
        _reg.register(nm, matchers, rt, _unbound(nm))
    for nm, matchers, rt in (
        ("startswith", [STRINGY, STRINGY], BOOLEAN),
        ("endswith", [STRINGY, STRINGY], BOOLEAN),
        ("left", [STRINGY, INT_M], _VARCHAR),
        ("overlay", [STRINGY, STRINGY, INT_M], _VARCHAR),
        ("overlay", [STRINGY, STRINGY, INT_M, INT_M], _VARCHAR),
        ("substring_index", [STRINGY, STRINGY, INT_M], _VARCHAR),
        ("rlike", [STRINGY, STRINGY], BOOLEAN),
        ("get_json_object", [STRINGY, STRINGY], _VARCHAR),
        ("conv", [STRINGY, INT_M, INT_M], _VARCHAR),
        ("sha2", [STRINGY, INT_M], _VARCHAR),
    ):
        _reg.register(nm, matchers, rt, _unbound(nm))
    _reg.register("hash", [STRINGY], INTEGER, _unbound("hash"))
    _reg.register("xxhash64", [STRINGY], BIGINT, _unbound("xxhash64"))

    # operator-name functions (RegisterArithmetic.cpp / RegisterCompare.cpp)
    _reg.register("add", [NUMERIC, NUMERIC], same, _arith("add"),
                  coerce_common_numeric=True)
    _reg.register("subtract", [NUMERIC, NUMERIC], same, _arith("subtract"),
                  coerce_common_numeric=True)
    _reg.register("remainder", [NUMERIC, NUMERIC], same, _remainder,
                  null_aware=True, coerce_common_numeric=True)
    _reg.register("unaryminus", [NUMERIC], same, _unaryminus)
    for nm, op in (
        ("equalto", "eq"), ("greaterthan", "gt"),
        ("greaterthanorequal", "ge"), ("lessthan", "lt"),
        ("lessthanorequal", "le"),
    ):
        _reg.register(nm, [NUMERIC, NUMERIC], BOOLEAN, _cmp(op),
                      coerce_common_numeric=True)
    _reg.register("equalnullsafe", [NUMERIC, NUMERIC], BOOLEAN,
                  _equalnullsafe, null_aware=True,
                  coerce_common_numeric=True)
    _reg.register("isnull", [ANY], BOOLEAN, _isnull, null_aware=True)
    _reg.register("isnotnull", [ANY], BOOLEAN, _isnotnull, null_aware=True)

    # math tail
    _reg.register("sec", [NUMERIC], DOUBLE, _trig_recip("sec"))
    _reg.register("csc", [NUMERIC], DOUBLE, _trig_recip("csc"))
    _reg.register("cot", [NUMERIC], DOUBLE, _trig_recip("cot"))

    # date tail
    _reg.register("dayofmonth", [TypeKind.DATE], INTEGER, _dayofmonth)
    _reg.register("dayofweek", [TypeKind.DATE], INTEGER, _dayofweek)
    _reg.register("dayofyear", [TypeKind.DATE], INTEGER, _dayofyear)
    _reg.register("last_day", [TypeKind.DATE], _DATE, _last_day)
    _reg.register("make_date", [INT_M, INT_M, INT_M], _DATE, _make_date,
                  null_aware=True)
    _reg.register("to_unix_timestamp", [TypeKind.TIMESTAMP], BIGINT,
                  _unix_timestamp)
    _reg.register("to_unix_timestamp", [TypeKind.DATE], BIGINT,
                  _to_unix_timestamp_date)

    # rand: seed fixed at bind time (see _rand_impl's deviation note)
    import random as _pyrandom

    _bind_seed = _pyrandom.getrandbits(63)
    for nm in ("rand", "random"):
        _reg.register(nm, [], DOUBLE, _rand_impl(_bind_seed))
        _reg.register(nm, [INT_M], DOUBLE, _rand_impl(_bind_seed))

    # seeded hash variants (Hash.cpp hashWithSeed)
    _reg.register("hash_with_seed", [INT_M, ANY], INTEGER, _hash_with_seed,
                  null_aware=True, variadic=True)
    _reg.register("xxhash64_with_seed", [INT_M, ANY], BIGINT,
                  _xxhash64_with_seed, null_aware=True, variadic=True)

    # bloom-filter probe (MightContain.h): needs VARBINARY literals carrying
    # Spark's serialized BloomFilter — the engine has no varbinary literal
    # form yet; registered so plans type-check with a clear gate at eval
    def _might_contain_gate(*_a, **_k):
        raise NotImplementedError(
            "might_contain: Spark-serialized bloom-filter literals "
            "(VARBINARY) are not representable yet; see ROADMAP.md"
        )

    _reg.register("might_contain", [STRINGY, ANY], BOOLEAN,
                  _might_contain_gate)

    # bin/chr build strings from device-resident numeric values — the
    # engine's string representation is host-side dictionaries, and there is
    # no numeric->string device path yet (same limitation as
    # cast(x as varchar); ROADMAP.md "data-dependent string
    # construction").  Registered so plans type-check with a clear gate.
    def _num_to_string_gate(name):
        def impl(*_a, **_k):
            raise NotImplementedError(
                f"{name}: numeric->string construction has no device "
                "dictionary form yet; see ROADMAP.md"
            )

        return impl

    _reg.register("bin", [INT_M], _VARCHAR, _num_to_string_gate("bin"))
    _reg.register("chr", [INT_M], _VARCHAR, _num_to_string_gate("chr"))


def _unbound(name):
    def impl(*_a, **_k):  # pragma: no cover
        raise RuntimeError(
            f"{name}() on strings is rewritten at bind time; "
            "run it through a plan so dictionaries are available"
        )

    return impl


def _levenshtein(a, _ci, b):
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


_SOUNDEX = {
    **dict.fromkeys("BFPV", "1"),
    **dict.fromkeys("CGJKQSXZ", "2"),
    **dict.fromkeys("DT", "3"),
    "L": "4",
    **dict.fromkeys("MN", "5"),
    "R": "6",
}


def _soundex(v, _ci):
    if not v or not v[0].isalpha():
        return v
    up = v.upper()
    out = [up[0]]
    prev = _SOUNDEX.get(up[0], "")
    for ch in up[1:]:
        code = _SOUNDEX.get(ch, "")
        if code and code != prev:
            out.append(code)
        if ch not in "HW":
            prev = code
    return ("".join(out) + "000")[:4]


def _murmur3_bytes_py(data: bytes, seed: int) -> int:
    """Spark Murmur3_x86_32 over bytes (python, host per-dictionary-entry)."""

    def mixk1(k1):
        k1 = (k1 * 0xCC9E2D51) & 0xFFFFFFFF
        k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
        return (k1 * 0x1B873593) & 0xFFFFFFFF

    def mixh1(h1, k1):
        h1 ^= k1
        h1 = ((h1 << 13) | (h1 >> 19)) & 0xFFFFFFFF
        return (h1 * 5 + 0xE6546B64) & 0xFFFFFFFF

    h1 = seed & 0xFFFFFFFF
    # Spark hashes bytes one at a time as SIGNED ints (hashUnsafeBytes2 uses
    # 4-byte blocks; UTF8 strings go through hashUnsafeBytes which is
    # block-wise).  Use the 4-byte-block + tail-byte scheme.
    n = len(data)
    for i in range(0, n - n % 4, 4):
        k1 = int.from_bytes(data[i : i + 4], "little")
        h1 = mixh1(h1, mixk1(k1))
    for i in range(n - n % 4, n):
        b = data[i]
        if b >= 128:
            b -= 256
        h1 = mixh1(h1, mixk1(b & 0xFFFFFFFF))
    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & 0xFFFFFFFF
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & 0xFFFFFFFF
    h1 ^= h1 >> 16
    if h1 >= 1 << 31:
        h1 -= 1 << 32
    return h1


def _xxh64_bytes_py(data: bytes, seed: int) -> int:
    """XXH64 over bytes (python, host per-dictionary-entry)."""
    P1 = 0x9E3779B185EBCA87
    P2 = 0xC2B2AE3D27D4EB4F
    P3 = 0x165667B19E3779F9
    P4 = 0x85EBCA77C2B2AE63
    P5 = 0x27D4EB2F165667C5
    M = 0xFFFFFFFFFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        while i + 32 <= n:
            for vi in range(4):
                lane = int.from_bytes(data[i : i + 8], "little")
                if vi == 0:
                    v1 = (rotl((v1 + lane * P2) & M, 31) * P1) & M
                elif vi == 1:
                    v2 = (rotl((v2 + lane * P2) & M, 31) * P1) & M
                elif vi == 2:
                    v3 = (rotl((v3 + lane * P2) & M, 31) * P1) & M
                else:
                    v4 = (rotl((v4 + lane * P2) & M, 31) * P1) & M
                i += 8
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
        for v in (v1, v2, v3, v4):
            h = ((h ^ ((rotl((v * P2) & M, 31) * P1) & M)) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 8 <= n:
        lane = int.from_bytes(data[i : i + 8], "little")
        h = ((rotl(h ^ ((rotl((lane * P2) & M, 31) * P1) & M), 27) * P1) + P4) & M
        i += 8
    if i + 4 <= n:
        lane = int.from_bytes(data[i : i + 4], "little")
        h = ((rotl(h ^ ((lane * P1) & M), 23) * P2) + P3) & M
        i += 4
    while i < n:
        h = (rotl(h ^ (data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    if h >= 1 << 63:
        h -= 1 << 64
    return h


def _bind_string_hash(which):
    from ...expr import binding as _b

    if which == "murmur3":
        return _b._literal_args_fn(
            INTEGER,
            np.int32,
            lambda v, _ci: _murmur3_bytes_py(v.encode("utf-8"), 42),
        )
    return _b._literal_args_fn(
        BIGINT,
        np.int64,
        lambda v, _ci: _xxh64_bytes_py(v.encode("utf-8"), 42),
    )
