"""Where the program runs: the device it measures on and its compile cache.

Every entry point that measures or checks the program on the accelerator
asks this module for its device, and nothing here falls back to the CPU:
a measuring run with no GPU fails instead of timing something else.

The persistent compilation cache follows ``JAX_COMPILATION_CACHE_DIR``
when it is set (JAX reads that variable itself).  Otherwise it sits at one
fixed directory inside the checkout, ``<repo>/.jax_cache``, which
``.gitignore`` lists: the path is part of the cache key, so it is never
built from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


class DeviceInfo(NamedTuple):
    """The device as JAX reports it."""

    platform: str   # jax.devices()[0].platform
    kind: str       # jax.devices()[0].device_kind
    count: int      # len(jax.devices())

    def as_dict(self) -> dict:
        return {"platform": self.platform, "kind": self.kind,
                "count": self.count}


def device_info() -> DeviceInfo:
    """Platform, device kind and device count of JAX's default backend."""
    devices = jax.devices()
    return DeviceInfo(devices[0].platform, devices[0].device_kind,
                      len(devices))


def require_gpu(min_count: int = 1) -> DeviceInfo:
    """The GPU devices JAX sees; raises ``RuntimeError`` when there is none
    (or fewer than ``min_count``)."""
    info = device_info()
    if info.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {info.platform!r} "
            f"({info.kind}); this entry point measures on the GPU only")
    if info.count < min_count:
        raise RuntimeError(
            f"needs {min_count} GPUs, JAX sees {info.count}")
    return info


def compile_cache_dir() -> Path:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<repo>/.jax_cache``."""
    env = os.environ.get(CACHE_ENV)
    return Path(env) if env else DEFAULT_CACHE_DIR


def enable_compile_cache() -> Path:
    """Turn on JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory.  When the
    environment names a directory, JAX already uses it and no other is set
    here."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", str(path))
    # The V-cycle hierarchies compile in seconds each; cache them all.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
