"""TEMHD-stabilised liquid-metal divertor layer (thermoelectric MHD).

Role-parity with the reference's ``nuclear/temhd_peltier.py:22-160``
(``TEMHD_Stabilizer``: implicit 1D heat conduction through a thin liquid-
lithium layer where thermoelectric currents J = -sigma S grad(T) crossed
with the tokamak field drive convection that boosts the effective
conductivity; ``run_temhd_experiment`` heat-flux scan).

JAX-native: the per-step tridiagonal solve is the shared Thomas kernel,
the whole transient runs in one ``lax.scan``, and heat-flux scans
``vmap`` over the experiment.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.ops.tridiag import thomas_solve


@dataclasses.dataclass(frozen=True)
class TEMHDParams:
    layer_thickness_mm: float = 5.0
    b_field_t: float = 10.0
    n_cells: int = 50
    rho_kg_m3: float = 500.0        # liquid lithium
    cp_j_kg_k: float = 4200.0
    k_thermal_w_m_k: float = 50.0
    seebeck_v_k: float = 20e-6
    sigma_s_m: float = 3e6
    viscosity_pa_s: float = 1e-3
    t_wall_k: float = 300.0

    @property
    def dz_m(self) -> float:
        return self.layer_thickness_mm * 1e-3 / (self.n_cells - 1)


class TEMHDState(NamedTuple):
    t_k: jnp.ndarray            # (n_cells,) temperature profile


class TEMHDTrace(NamedTuple):
    surface_t_k: jnp.ndarray    # (n_steps,)
    k_eff_max: jnp.ndarray      # (n_steps,)
    state: TEMHDState


def init_temhd(p: TEMHDParams) -> TEMHDState:
    return TEMHDState(t_k=jnp.full(p.n_cells, p.t_wall_k))


def temhd_step(p: TEMHDParams, state: TEMHDState, heat_flux_mw_m2,
               dt: float = 0.1):
    """One implicit step: TE-convection-enhanced conduction.

    Physics chain (reference ``step`` :86-131): grad T -> thermoelectric
    current J = -sigma S grad T -> Lorentz force |J x B| -> convection
    velocity (Stokes balance) -> Peclet number -> k_eff = k (1 + 0.2 Pe).
    """
    t = state.t_k
    dz = p.dz_m
    grad_t = jnp.gradient(t, dz)
    j_te = -p.sigma_s_m * p.seebeck_v_k * grad_t
    f_lorentz = jnp.abs(j_te * p.b_field_t)
    v_conv = f_lorentz * dz ** 2 / (p.viscosity_pa_s + 1e-9)
    alpha = p.k_thermal_w_m_k / (p.rho_kg_m3 * p.cp_j_kg_k)
    peclet = jnp.clip(v_conv * dz / alpha, 0.0, 200.0)
    k_eff = jnp.maximum(p.k_thermal_w_m_k * (1.0 + 0.2 * peclet), 1e-9)

    r = k_eff * dt / (p.rho_kg_m3 * p.cp_j_kg_k * dz ** 2)
    # implicit interior rows for cells 1..N-1 (cell 0 pinned at T_wall)
    diag = 1.0 + 2.0 * r[1:]
    lower = -r[2:]
    upper = -r[1:-1]
    rhs = t[1:]
    rhs = rhs.at[0].add(r[1] * p.t_wall_k)
    # Neumann heat-flux boundary at the plasma-facing surface
    diag = diag.at[-1].set(1.0 + r[-1])
    q_in = heat_flux_mw_m2 * 1e6
    rhs = rhs.at[-1].add(r[-1] * q_in * dz / k_eff[-1])
    t_new = thomas_solve(lower, diag, upper, rhs)
    t1 = jnp.concatenate([jnp.asarray([p.t_wall_k], t.dtype), t_new])
    return TEMHDState(t_k=t1), t1[-1], jnp.max(k_eff)


def run_temhd(p: TEMHDParams, heat_flux_mw_m2, *, dt: float = 0.1,
              n_steps: int = 300) -> TEMHDTrace:
    """Whole thermal transient at constant incident flux in one scan."""
    def step(s, _):
        s1, t_surf, k_max = temhd_step(p, s, heat_flux_mw_m2, dt)
        return s1, (t_surf, k_max)

    s_final, (t_surf, k_max) = jax.lax.scan(step, init_temhd(p), None,
                                            length=n_steps)
    return TEMHDTrace(surface_t_k=t_surf, k_eff_max=k_max, state=s_final)


def temhd_flux_scan(p: TEMHDParams, fluxes_mw_m2: jnp.ndarray, *,
                    dt: float = 0.1, n_steps: int = 300):
    """vmap the experiment over incident heat fluxes (reference
    ``run_temhd_experiment``); returns final surface temperatures and the
    TE conductivity-enhancement factors."""
    def one(q):
        tr = run_temhd(p, q, dt=dt, n_steps=n_steps)
        return tr.surface_t_k[-1], tr.k_eff_max[-1] / p.k_thermal_w_m_k

    return jax.vmap(one)(jnp.atleast_1d(fluxes_mw_m2))
