"""End-to-end fixed-boundary equilibrium solves.

Uses the reference's normalised-unit ITER-like setup (its
``validation/iter_config.json`` convention: mu0 = 1, currents and Ip in
normalised units, square-ish grid) so convergence behaviour is comparable.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from scpn_fusion_tpu.core.config import (
    Coil,
    Dimensions,
    PhysicsParams,
    ReactorConfig,
    SolverParams,
)
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium import solve_equilibrium

# Normalised ITER-like coil set (PF ring outside the computational domain so
# the vacuum flux is regular on the grid; the reference's validation config
# places coils inside the domain, which pins the global psi max to the
# singular Green's flux at the edge — we avoid that artefact by design).
ITER_COILS = (
    Coil(r=3.5, z=4.8, current=-1.0, name="PF1"),
    Coil(r=8.0, z=4.8, current=4.0, name="PF2"),
    Coil(r=10.8, z=0.0, current=6.0, name="PF3"),
    Coil(r=8.0, z=-4.8, current=4.0, name="PF4"),
    Coil(r=3.5, z=-4.8, current=-1.0, name="PF5"),
    Coil(r=10.8, z=2.5, current=3.0, name="PF6"),
)


def make_cfg(method="sor", n=65, max_iter=600, profile_mode="l-mode",
             i_target=15.0, **solver_kw):
    solver_kw.setdefault("inner_sweeps", 1 if method in ("multigrid", "jacobi") else 20)
    return ReactorConfig(
        reactor_name="ITER-like-normalised",
        grid_resolution=(n, n),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=ITER_COILS,
        physics=PhysicsParams(
            plasma_current_target=i_target,
            vacuum_permeability=1.0,
            profile_mode=profile_mode,
        ),
        solver=SolverParams(
            max_iterations=max_iter,
            convergence_threshold=1e-4,
            relaxation_factor=0.1,
            solver_method=method,
            **solver_kw,
        ),
    )


# Per-method inner elliptic sweeps: one MG V-cycle is a strong solve; plain
# SOR needs several sweeps per Picard step (the reference's accelerated HPC
# lane runs 50, hpc_bridge.py solve(iterations=50)).
@pytest.mark.parametrize("method,sweeps", [
    ("sor", 20), ("multigrid", 1), ("anderson", 20),
])
def test_solve_converges(method, sweeps):
    cfg = make_cfg(method, inner_sweeps=sweeps)
    res = solve_equilibrium(cfg, dtype=jnp.float64)
    assert bool(res.converged), (
        f"{method} did not converge in {int(res.iterations)} iters, "
        f"residual {float(res.residual):.3e}")
    psi = np.asarray(res.psi)
    assert np.all(np.isfinite(psi))
    assert float(jnp.max(jnp.abs(res.j_phi))) > 0.0


def test_jacobi_reduces_residual():
    """Jacobi is the slow legacy path — require monotone progress, not full
    convergence (same stance as the reference's legacy lane)."""
    cfg = make_cfg("jacobi", inner_sweeps=10, max_iter=200)
    res = solve_equilibrium(cfg, dtype=jnp.float64)
    h = np.asarray(res.residual_history)
    n = int(res.iterations)
    assert np.all(np.isfinite(np.asarray(res.psi)))
    assert h[n - 1] < h[0]


def test_plasma_current_matches_target():
    cfg = make_cfg("sor")
    res = solve_equilibrium(cfg, dtype=jnp.float64)
    grid = Grid.from_config(cfg, dtype=np.float64)
    ip = float(jnp.sum(res.j_phi)) * grid.dR * grid.dZ
    np.testing.assert_allclose(ip, 15.0, rtol=1e-3)


def test_axis_inside_domain():
    cfg = make_cfg("sor")
    res = solve_equilibrium(cfg, dtype=jnp.float64)
    psi = np.asarray(res.psi)
    iz, ir = np.unravel_index(np.argmax(psi), psi.shape)
    assert 0 < iz < psi.shape[0] - 1
    assert 0 < ir < psi.shape[1] - 1


def test_zero_current_returns_vacuum():
    cfg = make_cfg("sor", i_target=0.0)
    res = solve_equilibrium(cfg, dtype=jnp.float64)
    assert bool(res.converged)
    assert int(res.iterations) == 0
    assert float(jnp.max(jnp.abs(res.j_phi))) == 0.0
    assert float(jnp.max(jnp.abs(res.psi))) > 0.0


def test_hmode_profiles_solve():
    cfg = make_cfg("sor", profile_mode="h-mode")
    res = solve_equilibrium(cfg, dtype=jnp.float64)
    assert bool(res.converged)
    assert np.all(np.isfinite(np.asarray(res.psi)))


def test_result_histories_recorded():
    cfg = make_cfg("sor")
    res = solve_equilibrium(cfg, dtype=jnp.float64)
    n = int(res.iterations)
    hist = np.asarray(res.residual_history)
    assert np.all(np.isfinite(hist[:n]))
    assert np.all(np.isnan(hist[n:]))
    assert hist[n - 1] < hist[0]


def test_anderson_not_slower_than_sor():
    res_sor = solve_equilibrium(make_cfg("sor"), dtype=jnp.float64)
    res_and = solve_equilibrium(make_cfg("anderson"), dtype=jnp.float64)
    assert bool(res_and.converged)
    assert int(res_and.iterations) <= int(res_sor.iterations) * 1.5 + 10


def test_f32_matches_f64_span_relative():
    """f32 (the device production dtype) must track the f64 solve to span-relative
    tolerance — the reference pins span-relative comparisons for compiled
    lanes (jax_predictive_forward_compiled.py:23-27)."""
    cfg = make_cfg("sor")
    res64 = solve_equilibrium(cfg, dtype=jnp.float64)
    res32 = solve_equilibrium(cfg, dtype=jnp.float32)
    psi64 = np.asarray(res64.psi)
    psi32 = np.asarray(res32.psi, dtype=np.float64)
    span = psi64.max() - psi64.min()
    rel = np.max(np.abs(psi32 - psi64)) / span
    assert rel < 5e-3, f"f32/f64 span-relative deviation {rel:.2e}"


def test_anderson_mg_reaches_multigrid_fixed_point():
    """Anderson-accelerated multigrid-Picard (the headline-bench method)
    must reach the plain multigrid-Picard fixed point in far fewer outer
    iterations (measured 24 vs 176 at 513^2; checked here at 65^2)."""
    import dataclasses

    ref = solve_equilibrium(make_cfg("multigrid"), dtype=jnp.float64)
    base = make_cfg("multigrid")
    fast_cfg = dataclasses.replace(
        base, reactor_name="fb-anderson-mg",
        solver=dataclasses.replace(
            base.solver, solver_method="anderson_mg",
            relaxation_factor=0.8, anderson_depth=4))
    fast = solve_equilibrium(fast_cfg, dtype=jnp.float64)
    assert bool(fast.converged)
    assert int(fast.iterations) < int(ref.iterations)
    span = float(jnp.max(ref.psi) - jnp.min(ref.psi))
    dev = float(jnp.max(jnp.abs(fast.psi - ref.psi))) / span
    assert dev < 1e-3


class TestFMGCascade:
    def test_fmg_matches_direct_fixed_point(self):
        from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
            solve_equilibrium_fmg,
        )

        cfg = make_cfg("anderson_mg", n=129, max_iter=600,
                       anderson_depth=4)
        import dataclasses
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver,
                                            relaxation_factor=1.0))
        res, info = solve_equilibrium_fmg(cfg, min_coarse=65,
                                          dtype=jnp.float64)
        assert [lv["n"] for lv in info] == [65, 129]
        assert all(lv["converged"] for lv in info)

        direct = solve_equilibrium(cfg, dtype=jnp.float64)
        span = float(jnp.max(direct.psi) - jnp.min(direct.psi))
        dev = float(jnp.max(jnp.abs(res.psi - direct.psi))) / span
        assert dev < 1e-3, dev
        # Warm start must not be slower than the cold fine solve.
        assert info[-1]["iterations"] <= int(direct.iterations)

    def test_fmg_gates_only_the_finest_level_on_gs_residual(self):
        """Coarse levels stop on the update criterion alone; the GS-residual
        threshold gates the finest level.  At 1e-6 the threshold binds on
        every level of a 17 -> 33 -> 65 cascade when applied to all of them
        (6, 5, 5 iterations); gating only the finest gives 5, 4, 5."""
        import dataclasses

        from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
            solve_equilibrium_fmg,
        )

        base = make_cfg("anderson_mg", n=65, max_iter=300, anderson_depth=4)
        base = dataclasses.replace(base, solver=dataclasses.replace(
            base.solver, relaxation_factor=1.0))

        def cascade(threshold):
            cfg = dataclasses.replace(base, solver=dataclasses.replace(
                base.solver, gs_residual_threshold=threshold))
            return solve_equilibrium_fmg(cfg, min_coarse=17,
                                         dtype=jnp.float64)

        free, info_free = cascade(0.0)
        gated, info_gated = cascade(1e-6)
        its_free = [lv["iterations"] for lv in info_free]
        its_gated = [lv["iterations"] for lv in info_gated]
        assert all(lv["converged"] for lv in info_gated)
        assert its_gated[:-1] == its_free[:-1]
        assert its_gated[-1] > its_free[-1]
        hist = np.asarray(gated.gs_residual_history)
        assert hist[int(gated.iterations) - 1] < 1e-6
        assert float(gated.gs_residual) < float(free.gs_residual)

    def test_fmg_rejects_nonsquare(self):
        import dataclasses

        import pytest as _pytest

        from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
            solve_equilibrium_fmg,
        )

        cfg = dataclasses.replace(make_cfg("multigrid"),
                                  grid_resolution=(65, 129))
        with _pytest.raises(ValueError, match="square"):
            solve_equilibrium_fmg(cfg)
