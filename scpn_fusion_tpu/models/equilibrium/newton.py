"""Newton-Krylov Grad-Shafranov solver (matrix-free, exact JVP).

Compiled redesign of the reference's Newton dispatch
(``fusion_kernel_newton_solver.py:104-374`` + ``_solver_runtime.py:206-315``):
Picard warm-up, then Newton iterations solving  J(psi) delta = -F(psi)  with

* F(psi) = Delta* psi - S(psi) on the interior (Dirichlet ring pinned),
  S the Ip-renormalised profile source;
* J v obtained EXACTLY via ``jax.jvp`` of the residual — the reference
  hand-assembles an approximate ``L + mu0 R dJ/dpsi`` operator and corrects
  with GMRES restarts; autodiff gives the true linearisation (including the
  topology and renormalisation terms) for free;
* the Krylov solve is matrix-free BiCGSTAB preconditioned by one geometric
  multigrid V-cycle (the reference uses diagonal/ILU + GMRES);
* Armijo backtracking line search over a fixed candidate ladder.

Whole solve is one jitted program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.dtypes import canonical, default_float

from scpn_fusion_tpu.core.config import ReactorConfig
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium.fixed_boundary import EquilibriumResult
from scpn_fusion_tpu.models.equilibrium.profiles import (
    ProfileCoeffs,
    plasma_current_density,
    profile_coeffs_from_physics,
)
from scpn_fusion_tpu.models.equilibrium.topology import analyze_topology, compute_b_field
from scpn_fusion_tpu.models.equilibrium.vacuum import vacuum_psi_from_config
from scpn_fusion_tpu.ops.multigrid import _vcycle_impl
from scpn_fusion_tpu.ops.stencil import (
    apply_dirichlet,
    gs_operator,
    jacobi_sweeps,
    sor_step,
)


class NewtonResult(NamedTuple):
    psi: jnp.ndarray
    j_phi: jnp.ndarray
    converged: jnp.ndarray
    iterations: jnp.ndarray
    residual_norm: jnp.ndarray
    residual_history: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=("grid", "max_newton", "warmup_iters", "krylov_iters",
                     "h_mode", "mu0"),
)
def _solve_newton_impl(
    grid: Grid,
    psi0: jnp.ndarray,
    psi_bc: jnp.ndarray,
    i_target: jnp.ndarray,
    p_coeffs: ProfileCoeffs,
    ff_coeffs: ProfileCoeffs,
    tol: jnp.ndarray,
    *,
    grid_hash_dummy: int = 0,
    max_newton: int = 30,
    warmup_iters: int = 15,
    krylov_iters: int = 30,
    h_mode: bool = False,
    mu0: float = 1.0,
) -> NewtonResult:
    r_1d = grid.R
    rr = grid.RR
    zz = grid.ZZ
    d_r, d_z = grid.dR, grid.dZ
    dtype = psi0.dtype

    def source_of(psi):
        topo = analyze_topology(psi, zz, d_r, d_z, grid.Z_min)
        j_phi = plasma_current_density(
            psi, topo.psi_axis, topo.psi_boundary, rr,
            h_mode=h_mode, p_coeffs=p_coeffs, ff_coeffs=ff_coeffs,
            mu0=mu0, i_target=i_target, d_r=d_r, d_z=d_z)
        return -mu0 * rr * j_phi, j_phi

    def residual(psi):
        src, _ = source_of(psi)
        res = gs_operator(psi, r_1d, d_r, d_z) - src
        # Interior residual only; boundary pinned to psi_bc exactly.
        return (res.at[0, :].set(0.0).at[-1, :].set(0.0)
                .at[:, 0].set(0.0).at[:, -1].set(0.0))

    def precond(v):
        # One MG V-cycle approximating (Delta*)^{-1} v (zero Dirichlet).
        return _vcycle_impl(jnp.zeros_like(v), v, r_1d, d_r, d_z,
                            1.0, 2, 2, 5, 30)

    # ── Picard warm-up: seed + a few relaxed fixed-point steps ──
    r_center = 0.5 * (grid.R_min + grid.R_max)
    j_seed = jnp.exp(-(((rr - r_center) ** 2 + zz**2) / 2.0))
    j_seed = j_seed * (i_target / jnp.maximum(jnp.sum(j_seed) * d_r * d_z, 1e-30))
    psi = jacobi_sweeps(psi0, -mu0 * rr * j_seed, r_1d, d_r, d_z, 50)

    def warm_body(_, p):
        src, _ = source_of(p)
        p_new = p
        for _ in range(10):
            p_new = sor_step(p_new, src, r_1d, d_r, d_z, 1.6)
        p_new = apply_dirichlet(p_new, psi_bc)
        return p + 0.3 * (p_new - p)

    psi = jax.lax.fori_loop(0, warmup_iters, warm_body, psi)
    psi = apply_dirichlet(psi, psi_bc)

    class Carry(NamedTuple):
        k: jnp.ndarray
        psi: jnp.ndarray
        f_norm: jnp.ndarray
        converged: jnp.ndarray
        hist: jnp.ndarray

    n_int = (grid.NZ - 2) * (grid.NR - 2)

    def newton_body(c: Carry) -> Carry:
        f = residual(c.psi)
        f_norm = jnp.sqrt(jnp.sum(f * f) / n_int)

        def matvec(v):
            # Exact Jacobian-vector product via forward-mode autodiff.
            return jax.jvp(residual, (c.psi,), (v,))[1]

        delta, _ = jax.scipy.sparse.linalg.bicgstab(
            matvec, -f, M=precond, maxiter=krylov_iters, tol=1e-3)
        delta = (delta.at[0, :].set(0.0).at[-1, :].set(0.0)
                 .at[:, 0].set(0.0).at[:, -1].set(0.0))
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)

        # Armijo backtracking over a fixed ladder of step sizes.
        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.1, 0.03], dtype)

        def merit(alpha):
            r_try = residual(c.psi + alpha * delta)
            return jnp.sqrt(jnp.sum(r_try * r_try) / n_int)

        merits = jax.vmap(merit)(alphas)
        ok = merits < f_norm * (1.0 - 1e-4 * alphas)
        best = jnp.argmax(ok)  # first acceptable step
        any_ok = jnp.any(ok)
        alpha = jnp.where(any_ok, alphas[best], 0.0)
        new_norm = jnp.where(any_ok, merits[best], f_norm)

        psi_new = c.psi + alpha * delta
        return Carry(
            k=c.k + 1,
            psi=psi_new,
            f_norm=new_norm,
            converged=new_norm < tol,
            hist=c.hist.at[c.k].set(new_norm),
        )

    def cond(c: Carry) -> jnp.ndarray:
        return (c.k < max_newton) & (~c.converged) & jnp.isfinite(c.f_norm)

    f0 = residual(psi)
    init = Carry(jnp.int32(0), psi,
                 jnp.sqrt(jnp.sum(f0 * f0) / n_int),
                 jnp.bool_(False),
                 jnp.full((max_newton,), jnp.nan, dtype))
    final = jax.lax.while_loop(cond, newton_body, init)

    _, j_phi = source_of(final.psi)
    return NewtonResult(
        psi=final.psi, j_phi=j_phi, converged=final.converged,
        iterations=final.k, residual_norm=final.f_norm,
        residual_history=final.hist)


def solve_equilibrium_newton(
    cfg: ReactorConfig,
    grid: Grid | None = None,
    *,
    boundary_flux: jnp.ndarray | None = None,
    max_newton: int = 30,
    warmup_iters: int = 15,
    krylov_iters: int = 30,
    tol: float | None = None,
    dtype=None,
) -> NewtonResult:
    """Newton-Krylov equilibrium solve (reference method="newton" lane)."""
    dtype = default_float() if dtype is None else canonical(dtype)
    if grid is None:
        import numpy as np
        grid = Grid.from_config(
            cfg, dtype=np.float64 if dtype == jnp.float64 else np.float32)
    if boundary_flux is not None:
        psi_bc = jnp.asarray(boundary_flux, dtype)
    else:
        psi_bc = vacuum_psi_from_config(grid, cfg).astype(dtype)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype)
    if tol is None:
        # GS-residual RMS tolerance scaled to the source magnitude.
        tol = 1e-6 * float(jnp.max(jnp.abs(psi_bc)) + 1.0)
    return _solve_newton_impl(
        grid, psi_bc, psi_bc,
        jnp.asarray(cfg.physics.plasma_current_target, dtype),
        p_c, ff_c, jnp.asarray(tol, dtype),
        max_newton=max_newton, warmup_iters=warmup_iters,
        krylov_iters=krylov_iters,
        h_mode=cfg.physics.profile_mode == "h-mode",
        mu0=float(cfg.physics.vacuum_permeability),
    )
