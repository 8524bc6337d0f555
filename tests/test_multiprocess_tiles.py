"""Multi-node-without-a-cluster: tile execution in REAL separate processes.

The reference's key test trick (SURVEY.md §4,
``tests/test_gk_domain_decomposition.py:36-246``): decomposition plans
are executed (a) serially per rank-tile with halo views and (b) in REAL
separate OS processes via ``ProcessPoolExecutor``, asserting
tile-reductions == monolithic to 1e-12 — so the distributed contract is
proven across genuine process boundaries, not just a virtual device
mesh.  This file applies the same trick to this framework's Z-slab SOR
decomposition: the serial lane runs the SAME ``_local_half_sweep``
kernel the ``shard_map`` lane uses; the process lane runs a
dependency-free NumPy twin of it (spawned-worker framework imports cost
minutes and prove nothing), with the serial lane pinning twin == real
kernel == monolithic to 1e-12.
"""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest


def _make_pool():
    """Spawned workers with the CPU platform forced via the inherited
    environment: forked workers would share the parent's initialised
    runtime and deadlock, and spawned ones without the pin would each
    initialise the accelerator and compete for it."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    return ProcessPoolExecutor(
        max_workers=N_TILES,
        mp_context=multiprocessing.get_context("spawn"))

N_TILES = 4
NZ, NR = 32, 33
N_SWEEPS = 5
OMEGA = 1.5


def _numpy_half_sweep(psi_pad, src_local, a_e_f, a_w_f, a_ns, a_c,
                      parity, row_offset, nz_total):
    """Dependency-free NumPy twin of ``parallel.halo._local_half_sweep``
    (identical f64 elementwise arithmetic).  Worker processes run THIS:
    importing the framework (and jax) in each spawned worker costs
    minutes per process (measured), which is startup cost, not contract
    evidence — the serial lane below runs the real kernel in-process, and
    ``test_serial_tiles_match_monolithic`` pins the two to 1e-12."""
    local = psi_pad[1:-1].copy()
    l_rows, nr = local.shape
    gs = (a_e_f[None, 1:-1] * psi_pad[1:-1, 2:]
          + a_w_f[None, 1:-1] * psi_pad[1:-1, :-2]
          + a_ns * (psi_pad[:-2, 1:-1] + psi_pad[2:, 1:-1])
          - src_local[:, 1:-1]) / a_c
    iz = np.arange(l_rows)[:, None] + row_offset
    ir = np.arange(1, nr - 1)[None, :]
    mask = (((iz + ir) % 2) == parity) & (iz >= 1) & (iz <= nz_total - 2)
    old = local[:, 1:-1]
    local[:, 1:-1] = np.where(mask, old + OMEGA * (gs - old), old)
    return local


def _worker_half_sweep(payload):
    """One halo-padded half-sweep in a WORKER PROCESS (one rank of the
    reference's ProcessPool plan executor)."""
    (psi_pad, src_local, a_e, a_w, a_ns, a_c, parity, row_offset,
     nz_total) = payload
    out = _numpy_half_sweep(psi_pad, src_local, a_e, a_w, a_ns, a_c,
                            parity, row_offset, nz_total)
    return out, os.getpid()


def _jax_half_sweep(payload):
    """The REAL ``_local_half_sweep`` kernel (in-process serial lane)."""
    import jax.numpy as jnp

    from scpn_fusion_tpu.parallel.halo import _local_half_sweep

    (psi_pad, src_local, a_e, a_w, a_ns, a_c, parity, row_offset,
     nz_total) = payload
    out = _local_half_sweep(
        jnp.asarray(psi_pad), jnp.asarray(src_local),
        jnp.asarray(a_e)[1:-1], jnp.asarray(a_w)[1:-1], a_ns, a_c,
        OMEGA, parity, jnp.int32(row_offset), nz_total)
    return np.asarray(out), os.getpid()


def _worker_partial_l2(payload):
    """Per-tile partial sum-of-squares (reduction invariant worker)."""
    arr, = payload
    return float(np.sum(np.asarray(arr, dtype=np.float64) ** 2))


def _problem():
    rng = np.random.default_rng(5)
    r_1d = np.linspace(2.0, 10.0, NR)
    psi = rng.standard_normal((NZ, NR))
    src = rng.standard_normal((NZ, NR))
    return r_1d, psi, src


def _coeffs(r_1d, d_r, d_z):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from scpn_fusion_tpu.ops.stencil import stencil_coeffs

    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    a_e_f = np.zeros(NR)
    a_e_f[1:-1] = np.asarray(a_e)
    a_w_f = np.zeros(NR)
    a_w_f[1:-1] = np.asarray(a_w)
    return a_e_f, a_w_f, float(a_ns), float(a_c)


def _monolithic(psi0, src, r_1d, d_r, d_z):
    import jax.numpy as jnp

    from scpn_fusion_tpu.ops.stencil import sor_sweeps

    out = sor_sweeps(jnp.asarray(psi0), jnp.asarray(src),
                     jnp.asarray(r_1d), d_r, d_z, OMEGA, N_SWEEPS)
    return np.asarray(out)


def _run_tiled(pool_map, psi0, src, r_1d, d_r, d_z,
               n_sweeps=N_SWEEPS, worker=_worker_half_sweep):
    """Drive red/black rounds through per-tile executions, stitching
    between every half-sweep (serial halo exchange across the process
    boundary, reference ``serial_halo_exchange`` semantics)."""
    a_e_f, a_w_f, a_ns, a_c = _coeffs(r_1d, d_r, d_z)
    l_rows = NZ // N_TILES
    psi = psi0.copy()
    pids = set()
    for _ in range(n_sweeps):
        for parity in (0, 1):
            padded = np.zeros((NZ + 2, NR))
            padded[1:-1] = psi
            payloads = []
            for t in range(N_TILES):
                lo = t * l_rows
                payloads.append((
                    padded[lo:lo + l_rows + 2].copy(),
                    src[lo:lo + l_rows].copy(),
                    a_e_f, a_w_f, a_ns, a_c, parity, lo, NZ))
            results = list(pool_map(worker, payloads))
            for t, (block, pid) in enumerate(results):
                psi[t * l_rows:(t + 1) * l_rows] = block
                pids.add(pid)
    return psi, pids


@pytest.fixture(scope="module")
def problem():
    r_1d, psi, src = _problem()
    d_r = float(r_1d[1] - r_1d[0])
    d_z = 8.0 / (NZ - 1)
    return r_1d, psi, src, d_r, d_z


class TestProcessBoundaryTiles:
    def test_serial_tiles_match_monolithic(self, problem):
        """(a) serial per-tile execution with halo views == monolithic."""
        r_1d, psi, src, d_r, d_z = problem
        mono = _monolithic(psi, src, r_1d, d_r, d_z)
        tiled, _ = _run_tiled(map, psi, src, r_1d, d_r, d_z,
                              worker=_jax_half_sweep)
        np.testing.assert_allclose(tiled, mono, atol=1e-12)
        # The dependency-free numpy twin the process lane runs must agree
        # with the real kernel's plan to the same tolerance.
        twin, _ = _run_tiled(map, psi, src, r_1d, d_r, d_z)
        np.testing.assert_allclose(twin, mono, atol=1e-12)

    def test_real_processes_match_monolithic(self, problem):
        """(b) the SAME plan through real OS worker processes.

        Workers run the dependency-free numpy twin (framework import
        per spawned worker costs minutes — startup, not evidence); the
        serial lane pins twin == real kernel == monolithic."""
        r_1d, psi, src, d_r, d_z = problem
        mono = _monolithic(psi, src, r_1d, d_r, d_z)
        with _make_pool() as pool:
            tiled, pids = _run_tiled(pool.map, psi, src, r_1d, d_r, d_z)
        np.testing.assert_allclose(tiled, mono, atol=1e-12)
        # Genuine process boundary: more than one worker pid, none ours.
        assert len(pids) > 1
        assert os.getpid() not in pids

    def test_tile_reductions_match_monolithic(self, problem):
        """Tile-local partial reductions summed across processes equal
        the monolithic global reduction to 1e-12 (the reference's
        invariant metric)."""
        _, psi, _, _, _ = problem
        global_l2 = float(np.sum(psi.astype(np.float64) ** 2))
        l_rows = NZ // N_TILES
        payloads = [(psi[t * l_rows:(t + 1) * l_rows],)
                    for t in range(N_TILES)]
        with _make_pool() as pool:
            partials = list(pool.map(_worker_partial_l2, payloads))
        assert abs(sum(partials) - global_l2) <= 1e-12 * max(global_l2, 1.0)
