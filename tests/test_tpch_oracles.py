"""The numpy oracles of Q1, Q3, Q6 and Q13 (connectors/tpch/queries.py
NUMPY_ORACLES) against the pandas oracles, on the same generated data."""

import numpy as np
import pytest

from velox_tpu.connectors.tpch import generate_table
from velox_tpu.connectors.tpch import plans as tp
from velox_tpu.connectors.tpch.queries import QUERY_COLUMNS

SF = 0.01

# output scale of each decimal column (the numpy oracles keep them unscaled)
SCALES = {
    "sum_qty": 2,
    "sum_base_price": 2,
    "sum_disc_price": 4,
    "sum_charge": 6,
    "revenue": 4,
}


@pytest.mark.parametrize("num", [1, 3, 6, 13])
def test_numpy_oracle_matches_pandas_oracle(num):
    tables = {t: generate_table(t, SF, c) for t, c in QUERY_COLUMNS[num].items()}
    got = tp.oracle_columns(num, tables)
    want = tp.oracle_result(num, tables)
    assert sorted(got) == sorted(want.columns)
    for name in want.columns:
        g, w = got[name], want[name].to_numpy()
        assert len(g) == len(w), name
        if name in SCALES:
            assert g.dtype == np.int64, name
            np.testing.assert_array_equal(g / 10.0 ** SCALES[name], w, err_msg=name)
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
