"""GS <-> transport self-consistent coupling, fully compiled.

Compiled redesign of the reference's coupling mixin
(``integrated_transport_solver_coupling.py:39-230``): the outer fixed-point
loop — n_inner transport steps under ``lax.scan``, 1D->2D profile projection,
a full compiled GS equilibrium solve, psi-residual convergence — runs inside
ONE jitted program (``lax.while_loop``), so the whole coupled scenario is a
single device program instead of the reference's host-orchestrated loop.

Projection semantics match ``map_profiles_to_2d`` (``:39-73``):
``rho_2d = sqrt(clip(psi_norm, 0, 1))``; pressure ``ne (Ti + Te)`` and Sauter
bootstrap current interpolated onto the 2D grid; ``J_phi = P * R + j_bs``
renormalised to the target plasma current.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.config import ReactorConfig
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
    EquilibriumResult,
    solve_fixed_boundary_impl,
)
from scpn_fusion_tpu.models.equilibrium.profiles import profile_coeffs_from_physics
from scpn_fusion_tpu.models.equilibrium.topology import analyze_topology
from scpn_fusion_tpu.models.transport.closures import E_KEV_J, sauter_bootstrap_current
from scpn_fusion_tpu.models.transport.solver import (
    TransportParams,
    TransportState,
    _volume_element,
    evolve_profiles,
)


class CoupledResult(NamedTuple):
    psi: jnp.ndarray
    transport: TransportState
    j_phi: jnp.ndarray
    outer_iterations: jnp.ndarray
    psi_residual: jnp.ndarray
    converged: jnp.ndarray
    t_core: jnp.ndarray
    tau_e: jnp.ndarray


def interp_profile_to_2d(
    profile_1d: jnp.ndarray,
    rho_1d: jnp.ndarray,
    rho_2d: jnp.ndarray,
) -> jnp.ndarray:
    """Linear interpolation of a 1D rho-profile onto a 2D rho map."""
    return jnp.interp(rho_2d.reshape(-1), rho_1d, profile_1d).reshape(rho_2d.shape)


def map_profiles_to_2d(
    psi: jnp.ndarray,
    ts: TransportState,
    tp: TransportParams,
    grid: Grid,
    i_target: jnp.ndarray,
    mu0: float,
) -> jnp.ndarray:
    """Project transport profiles to a 2D J_phi source (Ip-renormalised)."""
    rho_1d = tp.rho(psi.dtype)
    topo = analyze_topology(psi, grid.ZZ, grid.dR, grid.dZ, grid.Z_min)
    psi_axis = topo.psi_axis
    psi_edge = topo.psi_boundary
    # Degenerate-map guard (reference :45-46): fall back to global min.
    psi_edge = jnp.where(jnp.abs(psi_edge - psi_axis) < 1.0, jnp.min(psi), psi_edge)
    denom = psi_edge - psi_axis
    denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    psi_norm = jnp.clip((psi - psi_axis) / denom, 0.0, 1.0)
    rho_2d = jnp.sqrt(psi_norm)

    r0 = 0.5 * (grid.R_min + grid.R_max)
    j_bs_1d = sauter_bootstrap_current(
        rho_1d, ts.te, ts.ti, ts.ne, ts.q, r0, tp.a_minor, tp.b0, 1.5)

    pressure_2d = interp_profile_to_2d(ts.ne * (ts.ti + ts.te), rho_1d, rho_2d)
    j_bs_2d = interp_profile_to_2d(j_bs_1d, rho_1d, rho_2d)

    j_phi = pressure_2d * grid.RR + j_bs_2d
    i_curr = jnp.sum(j_phi) * grid.dR * grid.dZ
    scale = jnp.where(jnp.abs(i_curr) > 1e-9, i_target / i_curr, 0.0)
    return j_phi * scale


def compute_confinement_time(
    ts: TransportState, tp: TransportParams, p_loss_mw: jnp.ndarray
) -> jnp.ndarray:
    """tau_E = W_stored / P_loss (reference ``:75-113``)."""
    rho = tp.rho(ts.ti.dtype)
    d_v = _volume_element(tp, rho)
    energy = 1.5 * (jnp.clip(ts.ne, 0.0, 1e3) * 1e19) \
        * (jnp.clip(ts.ti, 0.0, 1e3) + jnp.clip(ts.te, 0.0, 1e3)) * E_KEV_J
    w_mw = jnp.sum(energy * d_v) / 1e6
    return jnp.where(p_loss_mw > 0, w_mw / jnp.maximum(p_loss_mw, 1e-30), jnp.inf)


@partial(jax.jit, static_argnames=("cfg", "grid", "tp", "n_inner", "n_outer"))
def run_self_consistent(
    cfg: ReactorConfig,
    grid: Grid,
    tp: TransportParams,
    ts0: TransportState,
    psi0: jnp.ndarray,
    psi_bc: jnp.ndarray,
    *,
    p_aux_mw: jnp.ndarray,
    dt: jnp.ndarray,
    n_inner: int = 100,
    n_outer: int = 10,
    psi_tol: float = 1e-3,
) -> CoupledResult:
    """Self-consistent GS <-> transport fixed point, one compiled program."""
    dtype = psi0.dtype
    i_target = jnp.asarray(cfg.physics.plasma_current_target, dtype)
    mu0 = float(cfg.physics.vacuum_permeability)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype)
    sol = cfg.solver

    def gs_solve(psi_in: jnp.ndarray) -> EquilibriumResult:
        return solve_fixed_boundary_impl(
            grid, psi_in, psi_bc, i_target, p_c, ff_c,
            jnp.asarray(sol.convergence_threshold, dtype),
            jnp.asarray(jnp.inf, dtype),
            jnp.asarray(sol.relaxation_factor, dtype),
            jnp.asarray(sol.sor_omega, dtype),
            solver_method=sol.solver_method,
            max_iter=sol.max_iterations,
            h_mode=cfg.physics.profile_mode == "h-mode",
            inner_sweeps=sol.inner_sweeps,
            anderson_m=sol.anderson_depth,
            mu0=mu0,
            use_gs_criterion=False,
        )

    def transport_block(ts: TransportState) -> TransportState:
        def step(state, _):
            return evolve_profiles(state, dt, p_aux_mw, tp), None
        out, _ = jax.lax.scan(step, ts, None, length=n_inner)
        return out

    class Carry(NamedTuple):
        k: jnp.ndarray
        psi: jnp.ndarray
        ts: TransportState
        j_phi: jnp.ndarray
        resid: jnp.ndarray

    def body(c: Carry) -> Carry:
        ts = transport_block(c.ts)
        j_phi = map_profiles_to_2d(c.psi, ts, tp, grid, i_target, mu0)
        eq = gs_solve(c.psi)
        psi_new = eq.psi
        norm_old = jnp.maximum(jnp.linalg.norm(c.psi), 1e-30)
        resid = jnp.linalg.norm(psi_new - c.psi) / norm_old
        return Carry(c.k + 1, psi_new, ts, j_phi, resid)

    def cond(c: Carry) -> jnp.ndarray:
        return (c.k < n_outer) & (c.resid >= psi_tol) & jnp.isfinite(c.resid)

    init = Carry(jnp.int32(0), psi0, ts0, jnp.zeros_like(psi0),
                 jnp.asarray(1e30, dtype))  # finite sentinel: loop must start
    final = jax.lax.while_loop(cond, body, init)

    tau_e = compute_confinement_time(final.ts, tp, p_aux_mw)
    return CoupledResult(
        psi=final.psi,
        transport=final.ts,
        j_phi=final.j_phi,
        outer_iterations=final.k,
        psi_residual=final.resid,
        converged=final.resid < psi_tol,
        t_core=final.ts.ti[1],
        tau_e=tau_e,
    )
