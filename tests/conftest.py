"""Test configuration.

The suite runs on an 8-device *virtual CPU mesh*
(``--xla_force_host_platform_device_count``), giving multi-device coverage
without a pod — coverage the reference lacks entirely (SURVEY §4: ``prun``
is untested there).  Float64 is enabled so statistical tests compare against
the Julia reference's Float64 semantics; the framework itself is
dtype-agnostic.  Tests that need a GPU carry the ``gpu`` marker and skip
here (tests/test_gpu.py).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the CPU unless a run names another platform (JAX_PLATFORMS=cuda for the
# gpu-marked tests on a card)
if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# no persistent compile cache: the suite compiles fresh each run, so a
# cache entry from another machine can never be loaded

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop compiled executables between test modules.

    The XLA CPU compiler has segfaulted (inside backend_compile_and_load on
    the heaviest program, RMLMC) once a single process accumulated the full
    suite's worth of live executables.  Releasing executables per module
    keeps the process well under that; cross-module jit reuse is minimal so
    the time cost is noise."""
    yield
    jax.clear_caches()


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
