"""Checks that only mean something on the card (marker ``gpu``).

They skip on the CPU (the ``on_card`` fixture in conftest.py) and run on an
NVIDIA GPU inside `python chip_smoke.py`.  This module imports nothing
beyond JAX, numpy and the engine, so it also runs where pandas is absent.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from velox_tpu.ops import f64bits

pytestmark = pytest.mark.gpu


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float64).view(np.int64)


def _doubles(n=1 << 16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n).view(
        np.float64
    )
    base = rng.standard_normal(64)
    specials = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, -5e-324]
    return np.concatenate([x, base, np.nextafter(base, np.inf), specials])


def test_codec_round_trips_bit_for_bit_on_card():
    x = _doubles()
    dev = jax.devices()[0]
    w = jax.jit(f64bits.f64_to_word)(jax.device_put(x, dev))
    assert w.devices() == {dev}
    np.testing.assert_array_equal(np.asarray(w), _bits(x))
    back = np.asarray(jax.jit(f64bits.word_to_f64)(w))
    np.testing.assert_array_equal(_bits(back), _bits(x))


def test_ordered_key_on_card_matches_numpy_order():
    x = np.sort(_doubles(seed=1))  # NaN last
    k = np.asarray(jax.jit(f64bits.f64_to_ordered)(jnp.asarray(x)))
    assert (np.diff(k) >= 0).all()
    same = (x[1:] == x[:-1]) | (np.isnan(x[1:]) & np.isnan(x[:-1]))
    np.testing.assert_array_equal(np.diff(k) == 0, same)


def test_adjacent_doubles_stay_apart_on_card():
    base = np.array([1.2345678901234567, 1e-300, 3.0e300, -7.25])
    x = jnp.asarray(np.concatenate([base, np.nextafter(base, np.inf)]))
    w = np.asarray(jax.jit(f64bits.f64_to_word)(x))
    k = np.asarray(jax.jit(f64bits.f64_to_ordered)(x))
    assert (w[:4] != w[4:]).all() and (k[:4] < k[4:]).all()


def test_double_order_by_on_card():
    from velox_tpu.dtypes import DOUBLE, RowType
    from velox_tpu.exec.runner import LocalExecutor
    from velox_tpu.io.table import Table
    from velox_tpu.plan import PlanBuilder

    v = _doubles(seed=2)
    t = Table(RowType(["v"], [DOUBLE]), {"v": v})
    asc = LocalExecutor(PlanBuilder().table_scan(t).orderby(["v"]).build()).run()
    np.testing.assert_array_equal(np.asarray(asc.columns["v"]), np.sort(v))
    desc = LocalExecutor(
        PlanBuilder().table_scan(t).orderby(["v desc"]).limit(100).build()
    ).run()
    np.testing.assert_array_equal(
        np.asarray(desc.columns["v"]), np.sort(v)[::-1][:100]
    )


def test_double_group_by_on_card():
    from velox_tpu.dtypes import DOUBLE, RowType
    from velox_tpu.exec.runner import LocalExecutor
    from velox_tpu.io.table import Table
    from velox_tpu.plan import PlanBuilder

    rng = np.random.default_rng(3)
    pool = np.concatenate([rng.standard_normal(50), [0.0, -0.0, np.nan, 5e-324]])
    v = pool[rng.integers(0, len(pool), 1 << 16)]
    t = Table(RowType(["v"], [DOUBLE]), {"v": v})
    plan = (
        PlanBuilder()
        .table_scan(t)
        .aggregation(["v"], ["count(*) as c"])
        .orderby(["v"])
        .build()
    )
    out = LocalExecutor(plan).run()
    uniq, counts = np.unique(v, return_counts=True)
    np.testing.assert_array_equal(np.asarray(out.columns["v"]), uniq)
    np.testing.assert_array_equal(np.asarray(out.columns["c"]), counts)


def test_float64_arithmetic_is_ieee_on_card():
    # the card computes in real float64: 1 + 2^-52 is not 1
    one = jnp.ones((8,), jnp.float64)
    eps = jnp.full((8,), 2.0**-52, jnp.float64)
    out = np.asarray(jax.jit(lambda a, b: (a + b) - a)(one, eps))
    np.testing.assert_array_equal(out, np.full(8, 2.0**-52))
