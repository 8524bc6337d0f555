"""2D tile decomposition + batched ensembles: tile == monolithic invariant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.ops import stencil as st
from scpn_fusion_tpu.parallel.ensemble import solve_equilibrium_batch
from scpn_fusion_tpu.parallel.halo2d import (
    make_2d_mesh,
    optimal_process_grid,
    sharded_sor_solve_2d,
)
from tests.test_fixed_boundary import make_cfg


def test_optimal_process_grid():
    assert optimal_process_grid(8) == (2, 4)
    assert optimal_process_grid(4) == (2, 2)
    assert optimal_process_grid(7) == (1, 7)
    assert optimal_process_grid(16) == (4, 4)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_2d_tiled_sor_matches_monolithic(n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    # Divisible sizes: NZ % pz == 0, NR % pr == 0.
    pz, pr = optimal_process_grid(n_dev)
    grid = Grid.from_bounds(16 * pr, 16 * pz, 2.0, 10.0, -4.0, 4.0,
                            dtype=np.float64)
    rng = np.random.default_rng(0)
    psi = jnp.asarray(rng.standard_normal(grid.shape))
    src = jnp.asarray(rng.standard_normal(grid.shape))

    mesh = make_2d_mesh(n_dev)
    out, res = sharded_sor_solve_2d(
        psi, src, grid.R, jnp.asarray(1.6),
        mesh=mesh, d_r=grid.dR, d_z=grid.dZ,
        n_sweeps=5, nz_total=grid.NZ, nr_total=grid.NR)

    ref = psi
    for _ in range(5):
        ref = st.sor_step(ref, src, grid.R, grid.dR, grid.dZ, 1.6)

    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)
    assert float(res) > 0.0


def test_2d_tiled_sor_converges():
    grid = Grid.from_bounds(64, 64, 2.0, 10.0, -4.0, 4.0, dtype=np.float64)
    rr, zz = np.asarray(grid.RR), np.asarray(grid.ZZ)
    psi_exact = jnp.asarray(np.exp(-((rr - 6.0) ** 2 + zz**2) / 3.0))
    src = st.gs_operator(psi_exact, grid.R, grid.dR, grid.dZ)
    rng = np.random.default_rng(1)
    psi0 = st.apply_dirichlet(
        jnp.asarray(np.asarray(psi_exact) + 0.3 * rng.standard_normal(grid.shape)),
        psi_exact)
    mesh = make_2d_mesh(4)
    out, _ = sharded_sor_solve_2d(
        psi0, src, grid.R, jnp.asarray(1.8),
        mesh=mesh, d_r=grid.dR, d_z=grid.dZ,
        n_sweeps=2000, nz_total=grid.NZ, nr_total=grid.NR)
    err = float(jnp.max(jnp.abs(out - psi_exact)))
    assert err < 1e-6, err


class TestEnsemble:
    def test_batch_matches_single_solve(self):
        """Batched element == single solve (reference gate: span-rel <= 5e-15
        on its compiled lane; we pin tight agreement)."""
        cfg = make_cfg("multigrid", n=33, max_iter=200)
        grid = Grid.from_config(cfg, dtype=np.float64)
        base = jnp.asarray([c.current * c.turns for c in cfg.coils],
                           jnp.float64)
        batch = jnp.stack([base, 1.1 * base, 0.9 * base])
        i_t = jnp.asarray([15.0, 15.0, 12.0], jnp.float64)

        psi_b, conv_b, iters_b = solve_equilibrium_batch(cfg, grid, batch, i_t)
        assert psi_b.shape == (3, 33, 33)
        assert np.all(np.asarray(conv_b))

        # Element 0 must match the unbatched solve bit-for-bit-ish.
        psi_1, conv_1, _ = solve_equilibrium_batch(
            cfg, grid, base[None, :], i_t[:1])
        span = float(jnp.max(psi_b[0]) - jnp.min(psi_b[0]))
        dev = float(jnp.max(jnp.abs(psi_b[0] - psi_1[0]))) / span
        assert dev < 1e-12, dev

    def test_batch_mixed_matches_single_and_full_f64(self):
        """Batched mixed-precision element == single mixed solve, and both
        land on the full-f64 batched fixed point at the correction scale
        (gates behind the batched_mixed_amortisation campaign lane)."""
        from scpn_fusion_tpu.parallel.ensemble import (
            solve_equilibrium_batch_mixed,
        )
        cfg = make_cfg("anderson_mg", n=33, max_iter=300, anderson_depth=4,
                       inner_sweeps=1)
        grid = Grid.from_config(cfg, dtype=np.float64)
        base = jnp.asarray([c.current * c.turns for c in cfg.coils],
                           jnp.float64)
        batch = jnp.stack([base, 1.1 * base, 0.9 * base])
        i_t = jnp.asarray([15.0, 15.0, 12.0], jnp.float64)

        psi_b, conv_b, _, _ = solve_equilibrium_batch_mixed(
            cfg, grid, batch, i_t)
        assert np.all(np.asarray(conv_b))
        psi_1, conv_1, _, _ = solve_equilibrium_batch_mixed(
            cfg, grid, base[None, :], i_t[:1])
        assert bool(np.asarray(conv_1)[0])
        span = float(jnp.max(psi_b[0]) - jnp.min(psi_b[0]))
        dev = float(jnp.max(jnp.abs(psi_b[0] - psi_1[0]))) / span
        # Not bitwise like the pure-f64 batch: the injected f32 V-cycle
        # rounds differently under the batched vs unbatched XLA layouts,
        # so elements agree at the f32-CORRECTION scale (~1e-6 span-rel),
        # not at f64 ulps.  The f64 master iterate bounds it there.
        assert dev < 1e-5, dev

        psi_f, conv_f, _ = solve_equilibrium_batch(cfg, grid, batch, i_t)
        assert np.all(np.asarray(conv_f))
        dev_f = float(jnp.max(jnp.abs(psi_b[0] - psi_f[0]))) / span
        assert dev_f < 1e-5, dev_f

    def test_batch_sharded_over_mesh(self):
        from scpn_fusion_tpu.parallel.halo import make_z_mesh
        cfg = make_cfg("multigrid", n=33, max_iter=150)
        grid = Grid.from_config(cfg, dtype=np.float64)
        base = jnp.asarray([c.current * c.turns for c in cfg.coils],
                           jnp.float64)
        scale = jnp.linspace(0.9, 1.1, 8)
        batch = scale[:, None] * base[None, :]
        i_t = 15.0 * jnp.ones(8)
        mesh = make_z_mesh(4, axis="batch")
        psi_b, conv_b, _ = solve_equilibrium_batch(
            cfg, grid, batch, i_t, mesh=mesh)
        assert psi_b.shape == (8, 33, 33)
        assert np.all(np.isfinite(np.asarray(psi_b)))


def test_batch_freeze_guard_with_straggler():
    """A batch containing one much-slower element: fast elements must be
    FROZEN at their own convergence point (guarded while-body), matching
    their standalone solves even while the straggler keeps iterating —
    without the guard the vmapped loop kept Picard-iterating converged
    elements (measured 2.7e-3 span-rel drift at B=16 in f32)."""
    cfg = make_cfg("multigrid", n=33, max_iter=300)
    grid = Grid.from_config(cfg, dtype=np.float64)
    base = jnp.asarray([c.current * c.turns for c in cfg.coils], jnp.float64)
    # Element 0: standard; element 1: weak current -> different iteration
    # count (straggler pairing).
    batch = jnp.stack([base, base])
    i_t = jnp.asarray([15.0, 2.0], jnp.float64)

    psi_b, conv_b, iters_b = solve_equilibrium_batch(cfg, grid, batch, i_t)
    assert np.all(np.asarray(conv_b))
    it = np.asarray(iters_b)
    assert it[0] != it[1], "need a genuine straggler for this test"

    for e in range(2):
        psi_1, conv_1, it_1 = solve_equilibrium_batch(
            cfg, grid, batch[e:e + 1], i_t[e:e + 1])
        assert int(it_1[0]) == int(it[e])
        span = float(jnp.max(psi_b[e]) - jnp.min(psi_b[e]))
        dev = float(jnp.max(jnp.abs(psi_b[e] - psi_1[0]))) / span
        assert dev < 1e-12, (e, dev)
