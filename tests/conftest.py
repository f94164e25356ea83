"""Test config: run everything on CPU with 8 virtual devices.

Per SURVEY.md §4 "Distributed" tier: tiling/halo correctness is exactly
testable on a simulated multi-device CPU mesh
(--xla_force_host_platform_device_count), no GPU or cluster required.
The GPU aggregation kernel runs here through the Pallas interpreter: tests
pass `backend="triton_interpret"` (or `interpret=True`) explicitly.
Tests that need the card carry the `gpu` marker and skip here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables at module boundaries.

    The full suite compiles hundreds of XLA:CPU programs in one process;
    past ~120 tests the NEXT large compile segfaulted inside
    backend_compile_and_load (a cumulative XLA:CPU/LLVM JIT state bug in
    this jax build, not OOM).  Clearing the jit caches between modules
    keeps the live-executable footprint bounded; the recompiles cost a
    little wall-clock but keep the suite alive end-to-end."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
