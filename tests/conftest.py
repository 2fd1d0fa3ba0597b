"""Test config: tests run on the CPU with 8 virtual devices.

Multi-device sharding logic is validated without GPUs — the analogue of the
reference's "CPU models that simulate thread decomposition" testing pattern
(``src/cuzk/test/utils.rs``). The suite is run with ``JAX_PLATFORMS=cpu``;
tests marked ``gpu`` need a GPU, skip without one, and run on a GPU machine
with ``python -m pytest tests/ -m gpu``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# virtual devices for the sharded tests (affects only the CPU backend)
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: the suite is XLA-CPU-compile-dominated
# (every e2e test compiles a multi-kernel pipeline), so repeat runs load
# executables from disk. JAX_COMPILATION_CACHE_DIR wins when set; otherwise
# the fixed in-checkout path of msm_tpu.utils.cache.
from msm_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False, help="run slow tests"
    )


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slow test (use --runslow)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped when JAX finds none"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests when the first JAX device is not a GPU —
    decided here, at run time, never at import or collection time."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU (JAX found none)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules: a single pytest
    process accumulates ~150 XLA CPU programs over the full suite and has
    been observed to segfault near the end (trace-time crash in native
    code, not reproducible in isolation). Re-compiles across modules cost
    a little time; process stability is worth it."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()
