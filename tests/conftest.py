"""Test harness configuration.

By default the suite runs on the CPU with 8 virtual XLA devices, so the
multi-device paths (``shard_map`` + mesh collectives) run without a
multi-GPU host — the same trick the reference uses to test its MPI-shaped
decomposition without a cluster (SURVEY.md §4).  x64 is enabled so
accuracy gates can compare against float64 NumPy twins.

An explicit ``JAX_PLATFORMS`` chooses the platform instead: the card-only
tests run on an NVIDIA GPU with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_card.py

Those tests take the ``gpu`` fixture, which skips them when JAX's default
backend is not a GPU.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The GPU devices; skips the test when JAX's default backend is not a
    GPU.  Decided here, when the test runs, never at import."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default backend is "
                    f"{devices[0].platform}")
    return devices


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The full suite segfaults inside XLA's CPU compiler at a
    position-dependent point (~91%) while every subset passes — the
    accumulated live-executable footprint across hundreds of distinct
    jitted programs eventually corrupts/exhausts the JIT code arena
    (reproduced twice at the same test, each half-suite green).  Bounding
    live executables to one module's worth removes the failure mode at a
    small recompile cost.
    """
    yield
    jax.clear_caches()
