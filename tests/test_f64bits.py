"""Tests for the float-bits codec (ops/f64bits.py).

The word is the IEEE bit pattern on every backend, so numpy's bit view is
the oracle.  The CPU tests run the codec on the CPU and check its CUDA
lowering as text; `chip_smoke.py` runs it on the card at 10^7 rows.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from velox_tpu.ops import f64bits


def _np_bits(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float64).view(np.int64)


def _fuzz_doubles(rng, n=4096) -> np.ndarray:
    # uniform over BIT PATTERNS: exercises every binade, subnormals, and
    # specials far better than uniform-over-values
    bits = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n)
    return bits.view(np.float64)


CASES = np.array(
    [0.0, -0.0, 1.0, -1.0, 0.5, 2.0, 1.5, np.pi, -np.pi, 1e300, -1e300,
     1e-300, 5e-324, 2.2250738585072014e-308,
     1.7976931348623157e308, np.inf, -np.inf],
    dtype=np.float64,
)


def test_cpu_word_is_ieee_bits():
    got = np.asarray(f64bits.f64_to_word(jnp.asarray(CASES)))
    np.testing.assert_array_equal(got, _np_bits(CASES))
    back = np.asarray(f64bits.word_to_f64(jnp.asarray(got)))
    np.testing.assert_array_equal(back, CASES)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_roundtrip(seed):
    rng = np.random.default_rng(seed)
    x = _fuzz_doubles(rng)
    got = np.asarray(f64bits.f64_to_word(jnp.asarray(x)))
    want = _np_bits(x)
    ok = ~np.isnan(x)
    np.testing.assert_array_equal(got[ok], want[ok])
    back = np.asarray(f64bits.word_to_f64(jnp.asarray(want)))
    np.testing.assert_array_equal(back[ok], x[ok])
    assert np.isnan(back[~ok]).all()


def test_ordered_key_matches_float_order():
    rng = np.random.default_rng(7)
    x = _fuzz_doubles(rng, 2000)
    x = x[np.isfinite(x)]
    x = np.concatenate([x, [0.0, -0.0, np.inf, -np.inf]])
    key = np.asarray(f64bits.f64_to_ordered(jnp.asarray(x)))
    order = np.argsort(x, kind="stable")
    xs, ks = x[order], key[order]
    assert (np.diff(ks) >= 0).all()
    tie = np.diff(ks) == 0
    assert (xs[1:][tie] == xs[:-1][tie]).all()


def test_nan_sorts_above_inf_and_is_canonical():
    x = jnp.asarray(np.array([np.nan, -np.nan, np.inf, 1e308], np.float64))
    k = np.asarray(f64bits.f64_to_ordered(x))
    assert k[0] == k[1]  # every NaN canonicalizes to one code
    assert k[0] > k[2] > k[3]


def test_adjacent_doubles_get_distinct_codes():
    # doubles one ulp apart must stay apart in both the word and the order
    # key; a float32-pair encoding collapses them
    base = np.array([1.2345678901234567, 1e-300, 3.0e300, -7.25, 1.0])
    up = np.nextafter(base, np.inf)
    x = jnp.asarray(np.concatenate([base, up]))
    w = np.asarray(f64bits.f64_to_word(x))
    k = np.asarray(f64bits.f64_to_ordered(x))
    n = len(base)
    assert (w[:n] != w[n:]).all()
    assert (k[:n] < k[n:]).all()
    back = np.asarray(f64bits.word_to_f64(jnp.asarray(w)))
    np.testing.assert_array_equal(back.view(np.int64), np.asarray(x).view(np.int64))


def test_signed_zeros_share_an_order_key_not_a_word():
    x = jnp.asarray(np.array([0.0, -0.0], np.float64))
    k = np.asarray(f64bits.f64_to_ordered(x))
    w = np.asarray(f64bits.f64_to_word(x))
    assert k[0] == k[1]
    assert w[0] != w[1]  # the word keeps the sign bit: it round-trips
    np.testing.assert_array_equal(w, np.array([0.0, -0.0]).view(np.int64))


def test_subnormals_keep_their_order():
    tiny = np.array([-5e-324, 0.0, -0.0, 5e-324, 1e-310, 2.2250738585072014e-308])
    k = np.asarray(f64bits.f64_to_ordered(jnp.asarray(tiny)))
    assert k[0] < k[1] == k[2] < k[3] < k[4] < k[5]


@pytest.mark.parametrize(
    "fn", [f64bits.f64_to_word, f64bits.f64_to_ordered, f64bits.word_to_f64]
)
def test_cuda_lowering_is_a_64bit_bitcast(fn):
    """The CUDA module holds the 64-bit bitcast and no float32 conversion
    (the codec is one lax program on every platform)."""
    dtype = jnp.int64 if fn is f64bits.word_to_f64 else jnp.float64
    x = jax.ShapeDtypeStruct((1024,), dtype)
    text = jax.jit(fn).trace(x).lower(lowering_platforms=("cuda",)).as_text()
    assert "bitcast_convert" in text
    assert "f64" in text and "i64" in text
    assert "f32" not in text


def test_f32_bits_roundtrip():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1000).astype(np.float32) * 1e5
    w = np.asarray(f64bits.f32_to_bits64(jnp.asarray(x)))
    assert w.dtype == np.int64
    back = np.asarray(f64bits.bits64_to_f32(jnp.asarray(w)))
    np.testing.assert_array_equal(back, x)


def test_u64_wrap_roundtrip():
    u = np.array([0, 7, 2**63 + 5, 2**64 - 1], dtype=np.uint64)
    w = np.asarray(f64bits.u64_to_i64(jnp.asarray(u)))
    np.testing.assert_array_equal(w, u.view(np.int64))
    back = np.asarray(f64bits.i64_to_u64(jnp.asarray(w)))
    np.testing.assert_array_equal(back, u)


def _double_table(v):
    from velox_tpu.dtypes import BIGINT, DOUBLE, RowType
    from velox_tpu.io.table import Table

    k = np.arange(len(v), dtype=np.int64) % 3
    return Table(RowType(["k", "v"], [BIGINT, DOUBLE]), {"k": k, "v": v})


SPECIAL_KEYS = np.array(
    [np.nan, -np.nan, 0.0, -0.0, 5e-324, -5e-324, np.inf, -np.inf, 1.5,
     np.nextafter(1.5, 2.0)] * 7
)


@pytest.mark.parametrize("tile_rows", [1 << 14, 16])
def test_group_by_double_keys_matches_numpy(tile_rows):
    """One NaN group, -0.0 with +0.0, subnormals and ulp neighbours apart —
    in one tile and across tiles (the carry merge)."""
    from velox_tpu.exec.runner import LocalExecutor
    from velox_tpu.plan import PlanBuilder

    bits = SPECIAL_KEYS.view(np.int64).copy()
    bits[1] ^= 0x5  # a second NaN payload
    v = bits.view(np.float64)
    plan = (
        PlanBuilder()
        .table_scan(_double_table(v))
        .aggregation(["v"], ["count(*) as c"])
        .orderby(["v"])
        .build()
    )
    out = LocalExecutor(plan, tile_rows=tile_rows).run()
    uniq, counts = np.unique(v, return_counts=True)
    np.testing.assert_array_equal(np.asarray(out.columns["v"]), uniq)
    np.testing.assert_array_equal(np.asarray(out.columns["c"]), counts)


def test_window_order_by_double_desc_puts_nan_first():
    from velox_tpu.sql import run_sql

    v = SPECIAL_KEYS
    out = run_sql(
        "select k, v, row_number() over (partition by k order by v desc) as rn"
        " from t",
        {"t": _double_table(v)},
    )
    k, got, rn = (np.asarray(out.columns[c]) for c in ("k", "v", "rn"))
    order = np.lexsort((rn, k))
    for part in range(3):
        m = k[order] == part
        want = np.sort(v[np.arange(len(v)) % 3 == part])[::-1]
        np.testing.assert_array_equal(got[order][m], want)
