"""Batched equilibrium ensembles: vmap + device-mesh sharding.

The reference's batch-parallel lane (``jax_predictive_forward_compiled.py``
vmap batch variant; H100 evidence: B=16/64/256 amortised per-solve 13.6/13.0/
14.6 ms, BASELINE.md): here whole *nonlinear Picard solves* are vmapped over
coil-current / target-current ensembles, and the batch axis can additionally
be sharded over a device mesh (data-parallel over chips) — scenario scans,
coil-design sweeps and UQ ensembles run as one device program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scpn_fusion_tpu.core.config import ReactorConfig
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
    solve_fixed_boundary_impl,
)
from scpn_fusion_tpu.models.equilibrium.profiles import profile_coeffs_from_physics
from scpn_fusion_tpu.models.equilibrium.vacuum import coil_response_table


@partial(jax.jit, static_argnames=("cfg", "grid", "mesh", "batch_axis"))
def solve_equilibrium_batch(
    cfg: ReactorConfig,
    grid: Grid,
    coil_currents: jnp.ndarray,   # (B, n_coils) effective currents
    i_targets: jnp.ndarray,       # (B,)
    *,
    mesh: Mesh | None = None,
    batch_axis: str = "batch",
):
    """Solve a batch of equilibria (vmapped full Picard solves).

    When ``mesh`` is given, the batch axis is sharded across devices
    (data-parallel); otherwise the whole batch runs on one chip.
    Returns (psi_batch, converged, iterations).
    """
    dtype = coil_currents.dtype
    coil_r = jnp.asarray([c.r for c in cfg.coils], dtype)
    coil_z = jnp.asarray([c.z for c in cfg.coils], dtype)
    mu0 = float(cfg.physics.vacuum_permeability)
    table = coil_response_table(grid, coil_r, coil_z, mu0)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype)
    sol = cfg.solver

    def solve_one(currents, i_t):
        psi_bc = jnp.einsum("c,czr->zr", currents, table)
        res = solve_fixed_boundary_impl(
            grid, psi_bc, psi_bc, i_t, p_c, ff_c,
            jnp.asarray(sol.convergence_threshold, dtype),
            jnp.asarray(jnp.inf, dtype),
            jnp.asarray(sol.relaxation_factor, dtype),
            jnp.asarray(sol.sor_omega, dtype),
            solver_method=sol.solver_method, max_iter=sol.max_iterations,
            h_mode=cfg.physics.profile_mode == "h-mode",
            inner_sweeps=sol.inner_sweeps, anderson_m=sol.anderson_depth,
            mu0=mu0, use_gs_criterion=False)
        return res.psi, res.converged, res.iterations

    batched = jax.vmap(solve_one)
    if mesh is not None:
        sharding = NamedSharding(mesh, P(batch_axis))
        coil_currents = jax.device_put(coil_currents, sharding)
        i_targets = jax.device_put(i_targets, sharding)
    return batched(coil_currents, i_targets)


@partial(jax.jit,
         static_argnames=("cfg", "grid", "mesh", "batch_axis", "n_refine"))
def solve_equilibrium_batch_mixed(
    cfg: ReactorConfig,
    grid: Grid,                   # f64 grid
    coil_currents: jnp.ndarray,   # (B, n_coils) f64
    i_targets: jnp.ndarray,       # (B,) f64
    *,
    n_refine: int = 2,
    mesh: Mesh | None = None,
    batch_axis: str = "batch",
):
    """Batched MIXED-precision solves: f64 master iterate + criterion,
    f32 MG defect-correction inner elliptic, vmapped over the ensemble.

    Same amortisation lane as :func:`solve_equilibrium_batch` at f64
    convergence semantics — the comparison point for the reference's
    FP64 H100 batched figures (13.6/13.0/14.6 ms at B=16/64/256,
    BASELINE.md) in the SAME precision class.  Requires x64.  Returns
    (psi_batch, converged, iterations, gs_residual_best).
    """
    from scpn_fusion_tpu.models.equilibrium.mixed_precision import (
        make_refinement_elliptic,
        require_x64,
    )

    require_x64()
    dtype = jnp.float64
    coil_r = jnp.asarray([c.r for c in cfg.coils], dtype)
    coil_z = jnp.asarray([c.z for c in cfg.coils], dtype)
    mu0 = float(cfg.physics.vacuum_permeability)
    table = coil_response_table(grid, coil_r, coil_z, mu0)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype)
    sol = cfg.solver
    elliptic = make_refinement_elliptic(grid, n_refine=n_refine)

    def solve_one(currents, i_t):
        psi_bc = jnp.einsum("c,czr->zr", currents, table)
        res = solve_fixed_boundary_impl(
            grid, psi_bc, psi_bc, i_t, p_c, ff_c,
            jnp.asarray(sol.convergence_threshold, dtype),
            jnp.asarray(sol.gs_residual_threshold
                        if sol.gs_residual_threshold > 0 else jnp.inf,
                        dtype),
            jnp.asarray(sol.relaxation_factor, dtype),
            jnp.asarray(sol.sor_omega, dtype),
            solver_method=sol.solver_method, max_iter=sol.max_iterations,
            h_mode=cfg.physics.profile_mode == "h-mode",
            inner_sweeps=sol.inner_sweeps, anderson_m=sol.anderson_depth,
            mu0=mu0,
            use_gs_criterion=sol.gs_residual_threshold > 0,
            elliptic_fn=elliptic, anderson_gram_f32=True)
        return res.psi, res.converged, res.iterations, res.gs_residual_best

    batched = jax.vmap(solve_one)
    if mesh is not None:
        sharding = NamedSharding(mesh, P(batch_axis))
        coil_currents = jax.device_put(coil_currents, sharding)
        i_targets = jax.device_put(i_targets, sharding)
    return batched(coil_currents, i_targets)
