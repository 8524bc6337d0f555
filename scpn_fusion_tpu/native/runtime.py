"""ctypes bridge to the native C++ GS runtime.

Role-parity with the reference's HPC bridge (``hpc/hpc_bridge.py:89-456``):
a host-side accelerated elliptic lane with

* build-on-demand from the in-repo C++ source (``compile_cpp`` analogue:
  reference ``hpc_bridge.py:458-525``) via ``g++ -O3 -shared``,
* a fail-closed trust check — the built shared object carries a sidecar
  stamp with the SHA-256 of the exact source it was compiled from; a stale
  or tampered pairing refuses to load (the reference pins SHA-256 of its
  prebuilt binaries),
* graceful degradation: :func:`get_runtime` returns ``None`` when no
  compiler is available, and every consumer falls back to the NumPy twin
  (``utils/npref.py``) — mirroring the reference's "every native path has a
  pure-Python fallback" contract (``ARCHITECTURE.md:175-178``).

The device compute path never goes through this module; it exists for CPU
deployments and as an independent parity fixture for the SOR sweep.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("gs_runtime.cpp")
_BUILD_DIR = Path(__file__).with_name("_build")
_LIB = _BUILD_DIR / "libsfc_gs_runtime.so"
_STAMP = _BUILD_DIR / "libsfc_gs_runtime.stamp.json"
_ABI_VERSION = 1

_lock = threading.Lock()
_cached: "NativeGSRuntimeLib | None | bool" = False  # False = not probed yet


def _source_sha256() -> str:
    return hashlib.sha256(_SRC.read_bytes()).hexdigest()


def _compiler() -> str | None:
    for cand in (os.environ.get("CXX"), "g++", "clang++"):
        if not cand:
            continue
        try:
            subprocess.run([cand, "--version"], capture_output=True,
                           check=True, timeout=30)
            return cand
        except (OSError, subprocess.SubprocessError):
            continue
    return None


def build_library(force: bool = False) -> Path | None:
    """Compile the runtime if needed; returns the .so path or None."""
    src_hash = _source_sha256()
    if not force and _LIB.exists() and _STAMP.exists():
        try:
            stamp = json.loads(_STAMP.read_text())
            if (stamp.get("source_sha256") == src_hash
                    and stamp.get("abi") == _ABI_VERSION):
                return _LIB
        except (ValueError, OSError):
            pass
    cxx = _compiler()
    if cxx is None:
        return None
    _BUILD_DIR.mkdir(exist_ok=True)
    cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
           str(_SRC), "-o", str(_LIB)]
    try:
        subprocess.run(cmd, capture_output=True, check=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        # Retry without OpenMP (toolchains missing libgomp).
        cmd = [c for c in cmd if c != "-fopenmp"]
        try:
            subprocess.run(cmd, capture_output=True, check=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            return None
    _STAMP.write_text(json.dumps({
        "source_sha256": src_hash,
        "library_sha256": hashlib.sha256(_LIB.read_bytes()).hexdigest(),
        "abi": _ABI_VERSION,
        "compiler": cxx,
    }, indent=2))
    return _LIB


class NativeGSRuntimeLib:
    """Loaded shared library with typed C-ABI entry points."""

    def __init__(self, lib_path: Path):
        stamp = json.loads(_STAMP.read_text())
        lib_hash = hashlib.sha256(lib_path.read_bytes()).hexdigest()
        if stamp.get("library_sha256") != lib_hash:
            raise RuntimeError(
                "native runtime trust check failed: stamped sha256 does not "
                "match the shared object on disk — rebuild with "
                "build_library(force=True)")
        lib = ctypes.CDLL(str(lib_path))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.sfc_gs_create.restype = ctypes.c_void_p
        lib.sfc_gs_create.argtypes = [ctypes.c_int64, ctypes.c_int64, dp,
                                      ctypes.c_double, ctypes.c_double]
        lib.sfc_gs_destroy.argtypes = [ctypes.c_void_p]
        lib.sfc_gs_set_state.argtypes = [ctypes.c_void_p, dp, dp]
        lib.sfc_gs_get_psi.argtypes = [ctypes.c_void_p, dp]
        lib.sfc_gs_set_boundary.argtypes = [ctypes.c_void_p, dp]
        lib.sfc_gs_sor_sweeps.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_double]
        lib.sfc_gs_residual_rms.restype = ctypes.c_double
        lib.sfc_gs_residual_rms.argtypes = [ctypes.c_void_p]
        lib.sfc_gs_run_converged.restype = ctypes.c_int64
        lib.sfc_gs_run_converged.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_int64]
        lib.sfc_gs_abi_version.restype = ctypes.c_int
        if lib.sfc_gs_abi_version() != _ABI_VERSION:
            raise RuntimeError("native runtime ABI mismatch")
        self._lib = lib


def get_runtime() -> NativeGSRuntimeLib | None:
    """Probe/build/load the native runtime once per process."""
    global _cached
    with _lock:
        if _cached is not False:
            return _cached  # type: ignore[return-value]
        lib_path = build_library()
        if lib_path is None:
            _cached = None
            return None
        try:
            _cached = NativeGSRuntimeLib(lib_path)
        except (OSError, RuntimeError):
            _cached = None
        return _cached


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeGSSolver:
    """Host-side GS elliptic solver over the C++ arena.

    NumPy in / NumPy out; the arena owns all intermediate buffers so repeated
    ``sweeps``/``run_converged`` calls are allocation-free (the reference
    keeps the same contract across its C ABI,
    ``hpc_bridge.py:190-250``).
    """

    def __init__(self, r_1d: np.ndarray, d_r: float, d_z: float, nz: int):
        rt = get_runtime()
        if rt is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = rt._lib
        self.nz, self.nr = int(nz), int(r_1d.shape[0])
        r = np.ascontiguousarray(r_1d, dtype=np.float64)
        self._handle = self._lib.sfc_gs_create(
            self.nz, self.nr, _as_c(r), float(d_r), float(d_z))
        if not self._handle:
            raise RuntimeError("sfc_gs_create failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.sfc_gs_destroy(handle)
            self._handle = None

    def _check_grid(self, arr: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(arr, dtype=np.float64)
        if a.shape != (self.nz, self.nr):
            raise ValueError(f"expected {(self.nz, self.nr)}, got {a.shape}")
        return a

    def set_state(self, psi: np.ndarray, source: np.ndarray) -> None:
        self._lib.sfc_gs_set_state(
            self._handle, _as_c(self._check_grid(psi)),
            _as_c(self._check_grid(source)))

    def set_boundary(self, boundary: np.ndarray) -> None:
        self._lib.sfc_gs_set_boundary(
            self._handle, _as_c(self._check_grid(boundary)))

    def sweeps(self, n: int, omega: float = 1.6) -> None:
        self._lib.sfc_gs_sor_sweeps(self._handle, int(n), float(omega))

    def run_converged(self, max_sweeps: int = 10_000, tol: float = 1e-9,
                      omega: float = 1.6, chunk: int = 10) -> int:
        return int(self._lib.sfc_gs_run_converged(
            self._handle, int(max_sweeps), float(tol), float(omega),
            int(chunk)))

    def residual_rms(self) -> float:
        return float(self._lib.sfc_gs_residual_rms(self._handle))

    @property
    def psi(self) -> np.ndarray:
        out = np.empty((self.nz, self.nr), dtype=np.float64)
        self._lib.sfc_gs_get_psi(self._handle, _as_c(out))
        return out


def is_available() -> bool:
    return get_runtime() is not None
