"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on a virtual CPU mesh (the same pattern
the reference uses for multi-node tests without a cluster — reference:
velox/exec/tests/MultiFragmentTest.cpp:40 runs several Tasks in one process
over a fake transport).

Tests marked ``gpu`` need the card.  `chip_smoke.py` runs them in its own
process after setting VELOX_TESTS_ON_CARD=1, which leaves the backend it
already opened alone; every other run forces the CPU, so collection is the
same in every run and the ``gpu`` tests skip in the ``on_card`` fixture.
"""

import os

import pytest

ON_CARD = os.environ.get("VELOX_TESTS_ON_CARD") == "1"

if not ON_CARD:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def on_card(request):
    """Skip a ``gpu``-marked test unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the card")
