"""Test configuration: run everything on a virtual 8-device CPU mesh.

This mirrors the reference's host-vs-device dual-build checks
(e.g. contrib/cugar/bvh/cuda/lbvh_test.cu:59-240): kernels and sharding are
validated on the CPU backend, GPU kernels in Pallas interpret mode. Tests
marked `gpu` need a CUDA card and skip here; `chip_smoke.py` runs the
same paths on the card.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from fermat_tpu import platform  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# persistent compile cache: the integrator graphs take minutes to compile on
# CPU; caching makes suite re-runs compile-free
platform.setup_compile_cache(min_compile_secs=2.0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a CUDA GPU (decided when the
    test runs, never at import)."""
    if not platform.on_gpu():
        pytest.skip("needs a CUDA GPU")
