"""Test configuration.

By default the suite runs on the CPU with an 8-device virtual mesh, so the
sharding tests have devices to shard over. Tests marked `gpu` need the card:
they skip on the CPU and run on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(chip_smoke.py runs exactly that as its last phase).
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
# keep the persistent XLA compile cache OUT of test runs: a cache WRITE
# inside jax's serialization layer has segfaulted a full-suite run under
# memory pressure. CPU compiles are cheap; determinism beats cache speed.
os.environ["RUSTLIGHT_TPU_NO_COMPILE_CACHE"] = "1"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (run with -m gpu)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless the default backend is a GPU. Decided
    per test, at run time, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
