"""Test configuration.

By default tests run on the CPU with 8 virtual devices, so the shard_map /
multi-device paths are exercised without a GPU (the strategy from
SURVEY.md §4). ``RAYTPU_TEST_GPU=1`` leaves the platform alone instead, so
``RAYTPU_TEST_GPU=1 python -m pytest -m gpu tests/`` runs the GPU-marked
tests on the card; each ``gpu``-marked test skips where there is none.
"""
import os

ON_CPU = not os.environ.get("RAYTPU_TEST_GPU")
if ON_CPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    if not os.environ.get("RAYTPU_TEST_NO_CACHE"):
        # silence the AOT cache loader's per-load feature-mismatch spam
        # (see the cache block below); must land before backend init
        os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platform_name", "cpu")
    # The CPU suite is compile-bound (a small interpret-mode kernel case
    # spends seconds in XLA:CPU optimization passes and ~20 ms executing),
    # so trade optimization for compile time. Numerics note: this also
    # disables FMA contraction, i.e. results get CLOSER to the strict-f32
    # oracle; golden/byte tests still pass. Opt out with
    # RAYTPU_TEST_OPTIMIZED=1 to run the suite at full XLA optimization.
    if not os.environ.get("RAYTPU_TEST_OPTIMIZED"):
        jax.config.update("jax_disable_most_optimizations", True)
    # Persistent compilation cache for the compile-bound CPU suite: warm
    # reruns skip XLA:CPU entirely. The AOT loader logs a benign
    # machine-feature line per load (prefer-no-scatter/gather pseudo-
    # features differ between its compile-time and load-time detection on
    # the SAME host); a real mismatch would crash loudly, so the log spam
    # is suppressed via TF_CPP_MIN_LOG_LEVEL set before backend init
    # (opt out of caching with RAYTPU_TEST_NO_CACHE=1). The CPU entries
    # live apart from the GPU ones, under .jax_cache/cpu, unless
    # JAX_COMPILATION_CACHE_DIR names a directory.
    if not os.environ.get("RAYTPU_TEST_NO_CACHE"):
        from uob_raytracer_tpu.cache import DEFAULT_CACHE_DIR
        from uob_raytracer_tpu.cache import enable_compilation_cache
        enable_compilation_cache(os.path.join(DEFAULT_CACHE_DIR, "cpu"))

# CI NaN mode (SURVEY.md §4): RAYTPU_DEBUG_NANS=1 makes every jitted
# computation in the suite raise on the first NaN it produces
# (scripts/test.sh --nan-check runs a fast subset this way).
if os.environ.get("RAYTPU_DEBUG_NANS"):
    jax.config.update("jax_debug_nans", True)

import pytest  # noqa: E402

from uob_raytracer_tpu.reference.parity import (  # noqa: E402,F401
    assert_images_match,
)


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """``gpu``-marked tests run only where JAX's default platform is a GPU
    (decided here, at run time, never while modules are collected)."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: RAYTPU_TEST_GPU=1 python -m pytest -m gpu")


@pytest.fixture(scope="session")
def cornell():
    from uob_raytracer_tpu import cornell_box
    return cornell_box()
