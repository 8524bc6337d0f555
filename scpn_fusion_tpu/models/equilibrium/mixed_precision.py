"""Mixed-precision (f32 smoothing + f64 residual/correction) GS solve.

SURVEY §7 hard-parts prescription, reference precedent
``validation/benchmark_rung2_fp64.py`` (the reference's FP64 rung-2 lane):
a 513^2 solve that converges on the **GS-residual** criterion, which pure
f32 cannot do — the second difference of f32 rounding noise alone is
``O(6 eps |psi| / h^2)`` ~ 1e-2 at 513^2, so the f32 iterate's *measured*
residual stalls near 1e-3 regardless of how accurate the solve is
(``precision_budget.json``, VERDICT r3 weak #1).

Design (classic iterative refinement, MG as the inner solver):

* the master flux iterate, topology analysis, profile source, and the
  GS-residual convergence gate all run in **f64** (elementwise/stencil
  ops, a few % of a V-cycle's cost);
* the elliptic inner solve is **defect correction**: per refinement round,
  the f64 defect ``r = S - L[psi]`` is cast to f32 and ONE f32 multigrid
  V-cycle solves the error
  equation ``L e = r`` from zero; the correction is added back in f64.
  The f32 V-cycle sees a zero-boundary error equation whose solution is
  small, so f32 roundoff enters only at the *correction* scale — the
  iterate's accuracy is limited by f64 arithmetic, not f32;
* Anderson mixing runs over **f64 buffers** (the combination must not
  truncate the iterate) with the Gram build + LU in **f32**
  (``_anderson_mix(gram_in_f32=True)``): weight precision only perturbs
  the mixing direction, which the fixed-point iteration absorbs.

The result: GS-residual-gated convergence at 513^2 at near-f32 device
cost (the f64 ops are O(10) elementwise passes per outer iteration vs the
V-cycle's O(100)).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.config import ReactorConfig
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
    EquilibriumResult,
    _solve_fixed_boundary,
)
from scpn_fusion_tpu.models.equilibrium.profiles import (
    profile_coeffs_from_physics,
)
from scpn_fusion_tpu.models.equilibrium.vacuum import vacuum_psi_from_config
from scpn_fusion_tpu.ops.multigrid import _vcycle_impl, prolongate_bilinear
from scpn_fusion_tpu.ops.stencil import gs_residual


def require_x64() -> None:
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "mixed-precision solve needs jax_enable_x64 "
            "(jax.config.update('jax_enable_x64', True))")


def make_refinement_elliptic(
    grid: Grid,
    *,
    n_refine: int = 2,
):
    """Build the defect-correction elliptic step for ``elliptic_fn`` injection.

    Returns a closure ``(psi64, source64) -> psi64`` running ``n_refine``
    rounds of { f64 defect -> f32 V-cycle correction -> f64 update }.
    """
    r64 = jnp.asarray(grid.R, jnp.float64)
    r32 = jnp.asarray(grid.R, jnp.float32)
    d_r, d_z = float(grid.dR), float(grid.dZ)

    def elliptic(psi64: jnp.ndarray, source64: jnp.ndarray) -> jnp.ndarray:
        def round_(p64, _):
            defect64 = gs_residual(p64, source64, r64, d_r, d_z)
            e32 = _vcycle_impl(
                jnp.zeros(p64.shape, jnp.float32), defect64.astype(jnp.float32),
                r32, d_r, d_z, 1.0, 3, 3, 5, 50)
            return p64 + e32.astype(jnp.float64), None

        out, _ = jax.lax.scan(round_, psi64, None, length=n_refine)
        return out

    return elliptic


def solve_equilibrium_mixed(
    cfg: ReactorConfig,
    *,
    psi0: jnp.ndarray | None = None,
    i_target=None,
    n_refine: int = 2,
    skip_seed: bool = False,
) -> EquilibriumResult:
    """Fixed-boundary GS solve with an f64 master iterate and f32 MG inner.

    Converges on BOTH criteria: mean-|dpsi| < ``convergence_threshold`` AND
    f64 GS-residual RMS < ``gs_residual_threshold`` (set it > 0 in
    ``cfg.solver``; this path exists precisely to make that gate reachable
    at large grids).
    """
    require_x64()
    grid = Grid.from_config(cfg, dtype=jnp.float64)

    psi_bc = vacuum_psi_from_config(grid, cfg).astype(jnp.float64)
    psi_init = jnp.asarray(psi0, jnp.float64) if psi0 is not None else psi_bc
    i_t = cfg.physics.plasma_current_target if i_target is None else i_target
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, jnp.float64)
    sol = cfg.solver

    elliptic = make_refinement_elliptic(
        grid, n_refine=n_refine)

    return _solve_fixed_boundary(
        grid, psi_init, psi_bc,
        jnp.asarray(i_t, jnp.float64), p_c, ff_c,
        jnp.asarray(sol.convergence_threshold, jnp.float64),
        jnp.asarray(sol.gs_residual_threshold
                    if sol.gs_residual_threshold > 0 else jnp.inf,
                    jnp.float64),
        jnp.asarray(sol.relaxation_factor, jnp.float64),
        jnp.asarray(sol.sor_omega, jnp.float64),
        solver_method="anderson_mg" if sol.anderson_depth > 1 else "multigrid",
        max_iter=sol.max_iterations,
        h_mode=cfg.physics.profile_mode == "h-mode",
        inner_sweeps=sol.inner_sweeps,
        anderson_m=sol.anderson_depth,
        mu0=float(cfg.physics.vacuum_permeability),
        use_gs_criterion=sol.gs_residual_threshold > 0,
        elliptic_fn=elliptic,
        skip_seed=skip_seed,
        anderson_gram_f32=True,
    )


def solve_equilibrium_mixed_fmg(
    cfg: ReactorConfig,
    *,
    coarse_tol: float = 1e-3,
    min_coarse: int = 65,
    i_target=None,
    n_refine: int = 2,
) -> tuple[EquilibriumResult, list[dict]]:
    """FMG cascade ending in the mixed-precision residual-gated fine solve.

    Coarse levels run the plain f32 Anderson-MG solve (their job is only a
    warm start); the finest level runs ``solve_equilibrium_mixed`` so the
    headline configuration converges on the f64 GS-residual criterion.
    """
    require_x64()
    from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
        solve_equilibrium,
    )

    nr, nz = cfg.grid_resolution
    if nr != nz:
        raise ValueError("solve_equilibrium_mixed_fmg expects a square grid")
    sizes = [nr]
    while (sizes[-1] - 1) % 2 == 0 and (sizes[-1] - 1) // 2 + 1 >= min_coarse:
        sizes.append((sizes[-1] - 1) // 2 + 1)
    sizes = sizes[::-1]

    psi = None
    info: list[dict] = []
    res = None
    for n in sizes:
        fine = n == nr
        level_cfg = dataclasses.replace(
            cfg,
            grid_resolution=(n, n),
            solver=dataclasses.replace(
                cfg.solver,
                convergence_threshold=(cfg.solver.convergence_threshold
                                       if fine else coarse_tol),
                gs_residual_threshold=(cfg.solver.gs_residual_threshold
                                       if fine else 0.0)))
        if fine:
            res = solve_equilibrium_mixed(
                level_cfg, psi0=psi, i_target=i_target,
                n_refine=n_refine, skip_seed=psi is not None)
        else:
            res = solve_equilibrium(
                level_cfg,
                psi0=psi,
                boundary_flux=None if psi is None else vacuum_psi_from_config(
                    Grid.from_config(level_cfg, dtype=jnp.float32),
                    level_cfg).astype(jnp.float32),
                preserve_initial_state=psi is not None,
                i_target=i_target,
                dtype=jnp.float32,
                skip_seed=psi is not None)
        info.append({"n": n, "iterations": int(res.iterations),
                     "converged": bool(res.converged)})
        if not fine:
            psi = prolongate_bilinear(res.psi, 2 * (n - 1) + 1,
                                      2 * (n - 1) + 1)
    return res, info
