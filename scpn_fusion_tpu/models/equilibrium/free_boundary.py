"""Free-boundary Grad-Shafranov solve with coil-driven boundary flux.

Compiled redesign of the reference's free-boundary machinery
(``fusion_kernel_free_boundary.py:623-739``): the outer loop — external coil
flux on the boundary, inner Picard GS solve, optional Tikhonov-bounded
coil-current re-optimisation against shape-control points — runs entirely
inside one ``jax.jit`` as a ``lax.while_loop``.  Green's-function tables
(coil -> grid, coil -> control points) are computed inside the traced
program from the coil arrays, so XLA hoists them into the per-geometry
compiled constant pool; per-iteration coil work is a couple of tiny matmuls.

The jit cache is keyed on the static (config, grid, loop controls), following
the reference's per-geometry compile-cache design
(``jax_predictive_forward_compiled.py:32-34``) — warm calls with new coil
currents do not retrace.

The coil-current optimisation is differentiable end-to-end (projected FISTA
in ``ops/lstsq.py`` instead of scipy's trf), which also covers the
reference's differentiable-design lane (``jax_equilibrium_solver.py:439``:
coil optimisation via ``jax.grad``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.config import ReactorConfig
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.core.special import green_coil_psi
from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
    EquilibriumResult,
    solve_fixed_boundary_impl,
)
from scpn_fusion_tpu.models.equilibrium.profiles import profile_coeffs_from_physics
from scpn_fusion_tpu.ops.lstsq import tikhonov_coil_lstsq

MU0_SI = 4.0e-7 * jnp.pi


class CoilSet(NamedTuple):
    """Traced coil description (arrays so gradients can flow through
    positions and currents).

    Mirrors the reference's ``CoilSet`` dataclass (``fusion_kernel.py:61-101``)
    minus the host-side validation, which lives in config loading.
    """

    r: jnp.ndarray          # (n_coils,)
    z: jnp.ndarray          # (n_coils,)
    currents: jnp.ndarray   # (n_coils,)
    turns: jnp.ndarray      # (n_coils,)
    current_limits: jnp.ndarray | None = None      # (n_coils,) or None
    target_flux_points: jnp.ndarray | None = None  # (n_pts, 2) or None
    target_flux_values: jnp.ndarray | None = None  # (n_pts,) or None


class FreeBoundaryResult(NamedTuple):
    psi: jnp.ndarray
    coil_currents: jnp.ndarray
    outer_iterations: jnp.ndarray
    final_diff: jnp.ndarray
    converged: jnp.ndarray
    equilibrium: EquilibriumResult


def coilset_from_config(cfg: ReactorConfig, dtype=jnp.float32) -> CoilSet:
    return CoilSet(
        r=jnp.asarray([c.r for c in cfg.coils], dtype),
        z=jnp.asarray([c.z for c in cfg.coils], dtype),
        currents=jnp.asarray([c.current for c in cfg.coils], dtype),
        turns=jnp.asarray([float(c.turns) for c in cfg.coils], dtype),
    )


def mutual_inductance_matrix(
    coil_r: jnp.ndarray,
    coil_z: jnp.ndarray,
    turns: jnp.ndarray,
    points: jnp.ndarray,
    mu0: float = float(MU0_SI),
) -> jnp.ndarray:
    """Coil-to-point flux response M[coil, point] (per ampere), including
    turns (reference ``build_mutual_inductance_matrix`` :137-153)."""
    r_obs = points[:, 0]
    z_obs = points[:, 1]

    def one(rc, zc, t):
        return t * green_coil_psi(rc, zc, r_obs, z_obs, mu0)

    return jax.vmap(one)(coil_r, coil_z, turns)


def external_flux_table(grid: Grid, coils: CoilSet, mu0: float) -> jnp.ndarray:
    """Per-coil unit-current flux on the grid: G[c, z, r] (incl. turns)."""
    rr, zz = grid.RR, grid.ZZ

    def one(rc, zc, t):
        return t * green_coil_psi(rc, zc, rr, zz, mu0)

    return jax.vmap(one)(coils.r, coils.z, coils.turns)


def interp_psi_at_points(
    psi: jnp.ndarray, grid: Grid, points: jnp.ndarray
) -> jnp.ndarray:
    """Bilinear interpolation of the flux grid at (R, Z) points
    (jit-safe twin of reference ``interp_psi`` :562-580)."""
    r_pt, z_pt = points[:, 0], points[:, 1]
    fr = jnp.clip((r_pt - grid.R_min) / grid.dR, 0.0, grid.NR - 1 - 1e-6)
    fz = jnp.clip((z_pt - grid.Z_min) / grid.dZ, 0.0, grid.NZ - 1 - 1e-6)
    ir = jnp.clip(fr.astype(jnp.int32), 0, grid.NR - 2)
    iz = jnp.clip(fz.astype(jnp.int32), 0, grid.NZ - 2)
    tr = jnp.clip(fr - ir, 0.0, 1.0)
    tz = jnp.clip(fz - iz, 0.0, 1.0)
    p00 = psi[iz, ir]
    p01 = psi[iz, ir + 1]
    p10 = psi[iz + 1, ir]
    p11 = psi[iz + 1, ir + 1]
    return ((1 - tr) * (1 - tz) * p00 + tr * (1 - tz) * p01
            + (1 - tr) * tz * p10 + tr * tz * p11)


class _OuterCarry(NamedTuple):
    k: jnp.ndarray
    psi: jnp.ndarray
    currents: jnp.ndarray
    diff: jnp.ndarray
    eq: EquilibriumResult


def _dummy_eq(grid: Grid, dtype, max_iter: int) -> EquilibriumResult:
    z = jnp.zeros(grid.shape, dtype)
    s = jnp.asarray(0.0, dtype)
    return EquilibriumResult(
        psi=z, j_phi=z, b_r=z, b_z=z,
        converged=jnp.bool_(False), iterations=jnp.int32(0),
        residual=s, gs_residual=s, gs_residual_best=s,
        residual_history=jnp.full((max_iter,), jnp.nan, dtype),
        gs_residual_history=jnp.full((max_iter,), jnp.nan, dtype),
    )


@partial(
    jax.jit,
    static_argnames=("cfg", "grid", "max_outer_iter", "tol", "optimize_shape",
                     "tikhonov_alpha", "mu0_green",
                     "use_wall_response", "anderson_gram_f32",
                     "mixed_n_refine", "elliptic_fn"),
)
def _run_free_boundary(
    coils: CoilSet,
    *,
    cfg: ReactorConfig,
    grid: Grid,
    max_outer_iter: int,
    tol: float,
    optimize_shape: bool,
    tikhonov_alpha: float,
    mu0_green: float,
    anderson_gram_f32: bool = False,
    use_wall_response: bool = False,
    mixed_n_refine: int = 0,
    elliptic_fn=None,
) -> FreeBoundaryResult:
    dtype = coils.currents.dtype
    g_table = external_flux_table(grid, coils, mu0_green)

    # Injected elliptic inner solve.  Two users: the mixed-precision
    # refinement elliptic below, and the DISTRIBUTED Z-slab V-cycle
    # (``parallel/sharded_fb.solve_free_boundary_sharded`` — the reference's
    # distributed solve applies to its GS class generally,
    # ``mpi_domain.rs:804``, so the free-boundary forward shards too).
    elliptic_inj = elliptic_fn
    # Mixed-precision inner elliptic (f64 master iterate, f32 MG defect
    # correction — models/equilibrium/mixed_precision.py): the V-cycle is
    # ~90% of the inner solve's cost and runs in f32,
    # while the outer criterion, Green's boundary, topology and source stay
    # f64 — same convergence semantics as the full-f64 lane at near-f32
    # device cost.
    if mixed_n_refine > 0 and elliptic_inj is None:
        from scpn_fusion_tpu.models.equilibrium.mixed_precision import (
            make_refinement_elliptic,
        )
        elliptic_inj = make_refinement_elliptic(
            grid, n_refine=mixed_n_refine)

    wall = None
    if use_wall_response:
        # Von Hagenow wall response: the plasma's own flux contribution on
        # the computational wall, one (n_wall x n_interior) matmul per outer
        # iteration (reference jax_free_boundary_predictive.py:177-202).
        # The matrix is geometry-only, so XLA hoists it into the compiled
        # constant pool.  Memory ~ 4*NZ*NR*(2NZ+2NR) floats: fine to ~129^2.
        from scpn_fusion_tpu.models.equilibrium.shape_control import (
            plasma_wall_flux,
            wall_response_matrix,
        )
        m_wall, b_idx, s_idx = wall_response_matrix(grid, mu0_green)
        d_area = grid.dR * grid.dZ

        def wall(j_phi):
            return plasma_wall_flux(m_wall, b_idx, s_idx, j_phi, d_area,
                                    grid.shape)

    m_ctrl = None
    if coils.target_flux_points is not None:
        m_ctrl = mutual_inductance_matrix(
            coils.r, coils.z, coils.turns, coils.target_flux_points, mu0_green)

    if coils.current_limits is not None:
        lb, ub = -jnp.abs(coils.current_limits), jnp.abs(coils.current_limits)
    else:
        big = jnp.full_like(coils.currents, 1e30)
        lb, ub = -big, big

    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype)
    sol = cfg.solver
    mu0_cfg = float(cfg.physics.vacuum_permeability)
    i_target = jnp.asarray(cfg.physics.plasma_current_target, dtype)

    def inner_solve(psi0, psi_ext):
        return solve_fixed_boundary_impl(
            grid, psi0, psi_ext, i_target, p_c, ff_c,
            jnp.asarray(sol.convergence_threshold, dtype),
            jnp.asarray(jnp.inf, dtype),
            jnp.asarray(sol.relaxation_factor, dtype),
            jnp.asarray(sol.sor_omega, dtype),
            solver_method=sol.solver_method,
            max_iter=sol.max_iterations,
            h_mode=cfg.physics.profile_mode == "h-mode",
            inner_sweeps=sol.inner_sweeps,
            anderson_m=sol.anderson_depth,
            mu0=mu0_cfg,
            use_gs_criterion=False,
            elliptic_fn=elliptic_inj,
            anderson_gram_f32=anderson_gram_f32,
        )

    def body(c: _OuterCarry) -> _OuterCarry:
        psi_ext = jnp.einsum("c,czr->zr", c.currents, g_table)
        if wall is not None:
            psi_ext = psi_ext + wall(c.eq.j_phi)
        # init.psi is the vacuum flux, so iteration 0 starts from it; later
        # iterations keep the previous interior (preserve_initial_state
        # semantics) under the updated boundary map.
        eq = inner_solve(c.psi, psi_ext)
        psi = eq.psi

        if optimize_shape:
            if coils.target_flux_values is not None:
                target = coils.target_flux_values
            else:
                samples = interp_psi_at_points(
                    psi, grid, coils.target_flux_points)
                target = jnp.full_like(samples, jnp.mean(samples))
            currents = tikhonov_coil_lstsq(
                m_ctrl.T, target, tikhonov_alpha, lb, ub)
        else:
            currents = c.currents

        diff = jnp.max(jnp.abs(psi - c.psi))
        return _OuterCarry(c.k + 1, psi, currents, diff, eq)

    def cond(c: _OuterCarry) -> jnp.ndarray:
        return (c.k < max_outer_iter) & (c.diff >= tol) & jnp.isfinite(c.diff)

    init = _OuterCarry(
        k=jnp.int32(0),
        psi=jnp.einsum("c,czr->zr", coils.currents, g_table),
        currents=coils.currents,
        diff=jnp.asarray(1e30, dtype),
        eq=_dummy_eq(grid, dtype, sol.max_iterations),
    )
    final = jax.lax.while_loop(cond, body, init)
    return FreeBoundaryResult(
        psi=final.psi,
        coil_currents=final.currents,
        outer_iterations=final.k,
        final_diff=final.diff,
        converged=final.diff < tol,
        equilibrium=final.eq,
    )


def solve_free_boundary(
    cfg: ReactorConfig,
    coils: CoilSet | None = None,
    *,
    grid: Grid | None = None,
    max_outer_iter: int = 20,
    tol: float = 1e-4,
    optimize_shape: bool = False,
    tikhonov_alpha: float = 1e-4,
    mu0_green: float | None = None,
    use_wall_response: bool = False,
    dtype=jnp.float32,
    anderson_gram_f32: bool = False,
    mixed_n_refine: int = 0,
) -> FreeBoundaryResult:
    """Free-boundary equilibrium: coil flux BC <-> inner GS solve outer loop.

    Parameters mirror the reference ``solve_free_boundary``.  ``mu0_green``
    is the permeability used in the coil Green's functions — the reference
    always uses SI mu0 there regardless of the config's (possibly
    normalised) value (``fusion_kernel_free_boundary.py:28``); pass 1.0 for
    fully normalised test problems.

    ``mixed_n_refine > 0`` selects the mixed-precision inner elliptic
    (requires ``dtype=float64`` + x64): the outer loop, boundary flux, and
    convergence criterion run in f64 while each inner elliptic solve is
    ``mixed_n_refine`` rounds of f64-defect -> f32-V-cycle correction
    (``mixed_precision.make_refinement_elliptic``) — f64 convergence
    semantics at near-f32 device cost.
    """
    if mixed_n_refine > 0:
        from scpn_fusion_tpu.models.equilibrium.mixed_precision import (
            require_x64,
        )
        require_x64()
        if jnp.dtype(dtype) != jnp.float64:
            raise ValueError("mixed_n_refine needs dtype=float64 (the f32 "
                             "work lives inside the injected V-cycle)")
    if grid is None:
        grid = Grid.from_config(cfg, dtype=dtype)
    if coils is None:
        coils = coilset_from_config(cfg, dtype)
    if mu0_green is None:
        mu0_green = float(MU0_SI)
    if optimize_shape and coils.target_flux_points is None:
        raise ValueError("optimize_shape requires CoilSet.target_flux_points")

    return _run_free_boundary(
        coils,
        cfg=cfg,
        grid=grid,
        max_outer_iter=int(max_outer_iter),
        tol=float(tol),
        optimize_shape=bool(optimize_shape),
        tikhonov_alpha=float(tikhonov_alpha),
        mu0_green=float(mu0_green),
        use_wall_response=bool(use_wall_response),
        anderson_gram_f32=bool(anderson_gram_f32),
        mixed_n_refine=int(mixed_n_refine),
    )
