"""chip_smoke.py on the CPU: its phases at a small size, its refusal to run
without a GPU, and the compile-cache placement of the package.

Phase 4 runs in a subprocess with pandas and pyarrow blocked, which proves
that the smoke path and everything it imports need neither.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _env(**overrides):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    for k, v in overrides.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return env


def _run(code, timeout=600, **env):
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=_env(**env),
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_tpch_phase_runs_without_pandas_or_pyarrow():
    code = (
        "import sys\n"
        "sys.modules['pandas'] = sys.modules['pyarrow'] = None\n"
        "import chip_smoke\n"
        "chip_smoke.phase_tpch(0.01)\n"
        "assert 'pandas' not in sys.modules or sys.modules['pandas'] is None\n"
    )
    r = _run(code, JAX_PLATFORMS="cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert [x["query"] for x in lines] == [6, 1, 3, 13]
    assert all(x["oracle"] == "equal" for x in lines)
    q1 = next(x for x in lines if x["query"] == 1)
    assert q1["float_columns_at_rtol"] == ["avg_qty", "avg_price", "avg_disc"]


def test_main_fails_without_a_gpu():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO,
        env=_env(JAX_PLATFORMS="cpu"),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.mark.parametrize("case", ["env_dir", "checkout_dir", "cpu_pinned"])
def test_compile_cache_placement(case, tmp_path):
    env = {"JAX_PLATFORMS": None, "JAX_COMPILATION_CACHE_DIR": None}
    if case == "env_dir":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
        want = str(tmp_path)
    elif case == "checkout_dir":
        want = os.path.join(REPO, ".jax_cache")
    else:
        env["JAX_PLATFORMS"] = "cpu"
        want = None
    r = _run(
        "import jax, velox_tpu\n"
        "print(repr(jax.config.jax_compilation_cache_dir))\n",
        timeout=120,
        **env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == repr(want)


def test_quickstart_phase(capsys):
    chip_smoke.phase_quickstart()
    assert '"quickstart"' in capsys.readouterr().out


def test_double_phase_small(capsys):
    chip_smoke.phase_double(40_000, 3, 1 << 16)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rows"] == 40_000 and out["nan"] > 0 and out["subnormal"] > 0


def test_make_doubles_covers_the_hard_cases():
    v = chip_smoke.make_doubles(10_000, 0)
    bits = v.view(np.int64)
    assert len(v) == 10_000
    assert np.isnan(v).any() and np.isposinf(v).any() and np.isneginf(v).any()
    assert (bits == np.float64(-0.0).view(np.int64)).any()
    assert ((v != 0) & (np.abs(v) < np.finfo(np.float64).tiny)).any()
    finite = np.sort(v[np.isfinite(v)])
    assert (np.diff(finite) == 0).any()  # repeated values
    assert (np.nextafter(finite[:-1], np.inf) == finite[1:]).any()  # ulp pairs


def test_distributed_phase_on_four_virtual_devices(capsys):
    assert len(jax.devices()) >= 4
    chip_smoke.phase_distributed(0.01, 4)
    chip_smoke.phase_grouped_sum(4, rows_per_device=1 << 12)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    dist = [x for x in lines if x["phase"] == "distributed"]
    assert [(x["query"], x["join"]) for x in dist] == [
        (1, "default"), (3, "default"), (3, "shuffle"), (13, "default")
    ]
    assert all(x["oracle"] == x["local"] == "equal" for x in dist)
    assert dist[2]["shuffle_segments"] >= 1
    assert lines[-1]["phase"] == "distributed_grouped_sum"
