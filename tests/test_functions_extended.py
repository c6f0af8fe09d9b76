"""Extended scalar functions: strings-on-dictionaries, bitwise, dates.

Reference coverage model: velox/functions/prestosql/tests — each function is
checked against a host-side oracle over a small table.
"""

import numpy as np
import pytest

from velox_tpu.dtypes import BIGINT, DATE, DOUBLE, RowType, VARCHAR
from velox_tpu.exec import run_plan
from velox_tpu.io.table import Table
from velox_tpu.plan import PlanBuilder
from velox_tpu.vector.string_table import StringTable


def make():
    st = StringTable()
    codes = st.intern_all(["hello world", "foo bar", "hello xla", ""])
    return Table(
        RowType(["s", "d", "n", "x"], [VARCHAR, DATE, BIGINT, DOUBLE]),
        {
            "s": codes,
            "d": np.array([8084, 8115, 8450, 10000], np.int32),
            "n": np.array([3, 5, 7, -2], np.int64),
            "x": np.array([1.5, -2.5, 0.0, 100.0]),
        },
        string_tables={"s": st},
    )


def project(exprs):
    return run_plan(
        PlanBuilder().table_scan(make()).project(exprs).build()
    ).to_pandas()


def test_string_functions():
    out = project(
        [
            "concat(s, '!') as c",
            "strpos(s, 'o') as sp",
            "starts_with(s, 'hello') as sw",
            "ends_with(s, 'bar') as ew",
            "replace(s, 'hello', 'hi') as rp",
            "split_part(s, ' ', 1) as fp",
            "lpad(s, 13, '*') as lp",
            "regexp_like(s, 'w.rld') as rl",
            "regexp_extract(s, '([a-z]+)$') as rx",
            "regexp_replace(s, '[aeiou]', '_') as rr",
            "codepoint(s) as cp",
        ]
    )
    assert out["c"].tolist() == ["hello world!", "foo bar!", "hello xla!", "!"]
    assert out["sp"].tolist() == [5, 2, 5, 0]
    assert out["sw"].tolist() == [True, False, True, False]
    assert out["ew"].tolist() == [False, True, False, False]
    assert out["rp"].tolist() == ["hi world", "foo bar", "hi xla", ""]
    assert out["fp"].tolist() == ["hello", "foo", "hello", ""]
    assert out["lp"].tolist() == ["**hello world", "******foo bar", "****hello xla", "*" * 13]
    assert out["rl"].tolist() == [True, False, False, False]
    assert out["rx"].tolist() == ["world", "bar", "xla", ""]
    assert out["rr"].tolist() == ["h_ll_ w_rld", "f__ b_r", "h_ll_ xl_", ""]
    assert out["cp"].tolist() == [ord("h"), ord("f"), ord("h"), 0]


def test_bitwise():
    out = project(
        [
            "bitwise_and(n, 6) as a", "bitwise_or(n, 8) as o",
            "bitwise_xor(n, 1) as x", "bitwise_not(n) as nt",
            "bitwise_left_shift(n, 2) as ls", "bit_count(n) as bc",
        ]
    )
    n = np.array([3, 5, 7, -2], np.int64)
    np.testing.assert_array_equal(out["a"], n & 6)
    np.testing.assert_array_equal(out["o"], n | 8)
    np.testing.assert_array_equal(out["x"], n ^ 1)
    np.testing.assert_array_equal(out["nt"], ~n)
    np.testing.assert_array_equal(out["ls"], n << 2)
    np.testing.assert_array_equal(
        out["bc"], [bin(int(v) & (2**64 - 1)).count("1") for v in n]
    )


def test_date_functions():
    out = project(
        [
            "date_trunc('month', d) as dtm",
            "date_trunc('year', d) as dty",
            "date_trunc('week', d) as dtw",
            "date_diff('day', d, date '1997-05-19') as ddd",
            "date_diff('month', d, date '1997-05-19') as ddm",
            "date_add('month', n, d) as dam",
            "date_add('year', 1, d) as day_",
            "week(d) as wk",
            "last_day_of_month(d) as ld",
        ]
    )
    import datetime as dt

    epoch = dt.date(1970, 1, 1)
    dates = [epoch + dt.timedelta(days=int(v)) for v in [8084, 8115, 8450, 10000]]
    target = dt.date(1997, 5, 19)
    for i, date in enumerate(dates):
        assert out["dtm"][i] == (date.replace(day=1) - epoch).days
        assert out["dty"][i] == (date.replace(month=1, day=1) - epoch).days
        monday = date - dt.timedelta(days=date.weekday())
        assert out["dtw"][i] == (monday - epoch).days
        assert out["ddd"][i] == (target - date).days
        assert out["wk"][i] == date.isocalendar()[1]
        # last day of month
        nxt = (date.replace(day=28) + dt.timedelta(days=4)).replace(day=1)
        assert out["ld"][i] == ((nxt - dt.timedelta(days=1)) - epoch).days


def test_math_extras():
    out = project(
        [
            "log2(x) as l2", "truncate(x) as tr", "is_nan(x / x) as nn",
            "atan2(x, 1e0) as at",
        ]
    )
    x = np.array([1.5, -2.5, 0.0, 100.0])
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_allclose(out["l2"], np.log2(x))
        np.testing.assert_array_equal(out["tr"], np.trunc(x))
        np.testing.assert_allclose(out["at"], np.arctan2(x, 1.0))
    assert out["nn"].tolist() == [False, False, True, False]


def test_timestamp_functions():
    from velox_tpu.dtypes import TIMESTAMP

    usec = 1_000_000
    ts = np.array(
        [0, 3723 * usec + 456789, 86_400 * usec * 2 + 7200 * usec], np.int64
    )
    t = Table(
        RowType(["ts", "n"], [TIMESTAMP, BIGINT]),
        {"ts": ts, "n": np.array([1, 2, 3], np.int64)},
    )
    out = run_plan(
        PlanBuilder()
        .table_scan(t)
        .project(
            [
                "hour(ts) as h", "minute(ts) as m", "second(ts) as s",
                "millisecond(ts) as ms", "to_unixtime(ts) as u",
                "date_trunc('hour', ts) as th",
                "date_add('minute', n, ts) as ta",
                "date_diff('hour', ts, ts) as dz",
                "from_unixtime(n) as fu",
            ]
        )
        .build()
    ).to_pandas()
    assert out["h"].tolist() == [0, 1, 2]
    assert out["m"].tolist() == [0, 2, 0]
    assert out["s"].tolist() == [0, 3, 0]
    assert out["ms"].tolist() == [0, 456, 0]
    np.testing.assert_allclose(out["u"], ts / 1e6)
    assert out["th"].tolist() == [0, 3_600_000_000, 180_000_000_000]
    assert out["ta"].tolist() == (ts + np.array([1, 2, 3]) * 60_000_000).tolist()
    assert out["dz"].tolist() == [0, 0, 0]
    assert out["fu"].tolist() == [usec, 2 * usec, 3 * usec]


def test_json_and_url_functions():
    st, st2 = StringTable(), StringTable()
    docs = ['{"a": {"b": 7}, "xs": [1,2,3]}', '{"a": {"b": "hi"}}', "not json"]
    urls = ["https://example.com/p/q?x=1", "http://foo.io/", "bad"]
    t = Table(
        RowType(["j", "u"], [VARCHAR, VARCHAR]),
        {"j": st.intern_all(docs), "u": st2.intern_all(urls)},
        string_tables={"j": st, "u": st2},
    )
    out = run_plan(
        PlanBuilder()
        .table_scan(t)
        .project(
            [
                "json_extract_scalar(j, '$.a.b') as jb",
                "json_extract(j, '$.xs') as jx",
                "json_array_length(json_extract(j, '$.xs')) as jl",
                "url_extract_host(u) as h",
                "url_extract_path(u) as p",
                "url_extract_protocol(u) as pr",
            ]
        )
        .build()
    ).to_pandas()
    assert out["jb"].tolist() == ["7", "hi", ""]
    assert out["jx"].tolist() == ["[1,2,3]", "", ""]
    assert out["jl"].tolist() == [3, -1, -1]
    assert out["h"].tolist() == ["example.com", "foo.io", ""]
    assert out["p"].tolist() == ["/p/q", "/", "bad"]
    assert out["pr"].tolist() == ["https", "http", ""]


def test_digest_codec_and_constants():
    import hashlib

    st = StringTable()
    t = Table(
        RowType(["s", "x"], [VARCHAR, DOUBLE]),
        {
            "s": st.intern_all(["abc", "", "hello"]),
            "x": np.array([0.5, 5.5, 12.0]),
        },
        {"s": st},
    )
    out = run_plan(
        PlanBuilder()
        .table_scan(t)
        .project(
            [
                "md5(s) as m",
                "sha256(s) as h",
                "to_hex(s) as th",
                "from_hex(to_hex(s)) as rt",
                "to_base64(s) as b64",
                "from_base64(to_base64(s)) as rb",
                "hamming_distance(s, 'abc') as hd",
                "pi() as p",
                "width_bucket(x, 0.0, 10.0, 5) as wb",
            ]
        )
        .build()
    ).to_pandas()
    assert out["m"][0] == hashlib.md5(b"abc").hexdigest()
    assert out["h"][2] == hashlib.sha256(b"hello").hexdigest()
    assert out["th"].tolist() == ["616263", "", "68656C6C6F"]
    assert out["rt"].tolist() == ["abc", "", "hello"]
    assert out["rb"].tolist() == ["abc", "", "hello"]
    assert out["hd"].tolist() == [0, -1, -1]
    assert abs(out["p"][0] - 3.14159265) < 1e-8
    assert out["wb"].tolist() == [1, 3, 6]


def test_two_column_string_functions():
    s1, s2 = StringTable(), StringTable()
    t = Table(
        RowType(["a", "b"], [VARCHAR, VARCHAR]),
        {
            "a": s1.intern_all(["hello", "foo", ""]),
            "b": s2.intern_all(["world", "oo", "x"]),
        },
        {"a": s1, "b": s2},
    )
    out = run_plan(
        PlanBuilder()
        .table_scan(t)
        .project(
            [
                "concat(a, b) as c",
                "concat(a, '-', 'post') as lit",
                "strpos(a, b) as p",
                "levenshtein(a, b) as lv",
                "starts_with(a, b) as sw",
                "ends_with(concat(a, b), b) as ew",
            ]
        )
        .build()
    ).to_pandas()
    assert out["c"].tolist() == ["helloworld", "foooo", "x"]
    assert out["lit"].tolist() == ["hello-post", "foo-post", "-post"]
    assert out["p"].tolist() == [0, 2, 0]
    assert out["lv"].tolist() == [4, 1, 1]
    assert out["sw"].tolist() == [False, False, False]
    assert out["ew"].tolist() == [True, True, True]
