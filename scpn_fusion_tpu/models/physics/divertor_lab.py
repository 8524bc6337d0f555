"""Divertor heat-exhaust laboratory: tungsten vs liquid-lithium vapor shield.

JAX-native port of the reference's ``core/divertor_thermal_sim.py:19-244``
(``DivertorLab``): Eich-scaling parallel heat flux, two-point SOL transport,
1D tungsten monoblock conduction limit, self-consistent lithium vapor
shielding, Hartmann-corrected TEMHD pressure loss, and the combined
liquid-metal stability index.

The reference iterates the vapor-shield fixed point with a host Python loop
and adaptive relaxation (``simulate_lithium_vapor:107-183``); here the
same Picard map runs as a ``lax.while_loop`` with fixed under-relaxation
(the map is a contraction once shielding saturates) and every quantity is a
pure jnp function — the whole lab ``vmap``s over flow-velocity or P_SOL
scans as one compiled program (the reference runs one operating point per
call).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

W_MELT_C = 3422.0          # tungsten melting point [C]
LI_BOIL_C = 1342.0         # lithium boiling point  [C]


class DivertorLoad(NamedTuple):
    lambda_q_m: jnp.ndarray      # Eich SOL width
    q_parallel: jnp.ndarray      # upstream parallel flux [W/m^2]
    q_target: jnp.ndarray        # wetted-target flux [W/m^2]
    t_upstream_ev: jnp.ndarray
    t_target_ev: jnp.ndarray


def divertor_heat_load(
    p_sol_mw,
    r_major,
    b_pol,
    *,
    expansion_factor=10.0,
    f_rad=0.0,
    q95: float = 3.0,
    kappa0: float = 2000.0,
) -> DivertorLoad:
    """Eich-width parallel flux + conduction-limited two-point model
    (reference ``solve_2point_transport:42-74``):

    lambda_q [mm] = 0.63 B_pol^-1.19,  q_par = P_SOL / (2 pi R lambda_q),
    T = (3.5 q L_c / kappa0)^(2/7) upstream and at the (mitigated) target.
    """
    lambda_q = 0.63e-3 * b_pol ** (-1.19)
    l_c = jnp.pi * r_major * q95
    q_par = (p_sol_mw * 1e6) / (2.0 * jnp.pi * r_major * lambda_q)
    t_u = (3.5 * q_par * l_c / kappa0) ** (2.0 / 7.0)
    q_t = q_par * (1.0 - f_rad) / expansion_factor
    t_t = jnp.clip((3.5 * q_t * l_c / kappa0) ** (2.0 / 7.0), 1.0, t_u)
    return DivertorLoad(jnp.asarray(lambda_q), q_par, q_t, t_u, t_t)


class TungstenResult(NamedTuple):
    t_surface_c: jnp.ndarray
    melted: jnp.ndarray


def tungsten_monoblock(q_target, *, k_w: float = 100.0,
                       d_block_m: float = 0.01,
                       t_coolant_c: float = 100.0) -> TungstenResult:
    """1D tungsten conduction limit: T_surf = T_coolant + q d / k
    (reference ``simulate_tungsten:91-104``)."""
    t_surf = t_coolant_c + q_target * d_block_m / k_w
    return TungstenResult(t_surf, t_surf > W_MELT_C)


class LithiumShieldResult(NamedTuple):
    t_surface_c: jnp.ndarray
    q_surface: jnp.ndarray       # shielded flux reaching the substrate
    f_rad: jnp.ndarray           # vapor-shield radiated fraction
    iterations: jnp.ndarray


@partial(jax.jit, static_argnames=("max_iter",))
def lithium_vapor_shield(
    q_target,
    *,
    relaxation=0.7,
    tol=0.1,
    max_iter: int = 200,
    a_li: float = 10.0,
    b_li: float = 8000.0,
    k_eff: float = 150.0,
    d_m: float = 0.005,
    t_back_c: float = 300.0,
) -> LithiumShieldResult:
    """Self-consistent vapor shielding (reference
    ``simulate_lithium_vapor:107-183``): Alcock Li vapor pressure
    log10(P) = A - B/T_K drives a radiated fraction
    f_rad = 0.98 (1 - exp(-P/10)); the surface temperature solves the
    shielded conduction balance by under-relaxed Picard in a
    ``while_loop`` (step clipped to +-1200 C as in the reference)."""
    q_target = jnp.asarray(q_target, jnp.float32
                           if not jax.config.jax_enable_x64 else jnp.float64)
    dtype = q_target.dtype

    def shield(t_surf):
        p_sat = 10.0 ** (a_li - b_li / (t_surf + 273.15))
        f_rad = 0.98 * (1.0 - jnp.exp(-p_sat / 10.0))
        q_surf = q_target * (1.0 - f_rad)
        t_new = t_back_c + q_surf * d_m / k_eff
        return t_new, q_surf, f_rad

    def cond(carry):
        t, res, k = carry
        return (res > tol) & (k < max_iter)

    def body(carry):
        t, _, k = carry
        t_new, _, _ = shield(t)
        delta = jnp.clip(t_new - t, -1200.0, 1200.0)
        t_next = t + (1.0 - relaxation) * delta
        return t_next, jnp.abs(t_new - t), k + 1

    t0 = jnp.asarray(500.0, dtype)
    t_fin, _, k = jax.lax.while_loop(
        cond, body, (t0, jnp.asarray(jnp.inf, dtype), jnp.int32(0)))
    _, q_surf, f_rad = shield(t_fin)
    return LithiumShieldResult(t_fin, q_surf, f_rad, k)


def mhd_pressure_loss(
    flow_velocity_m_s,
    b_pol,
    *,
    channel_length_m: float = 1.2,
    channel_half_gap_m: float = 0.012,
    density_kg_m3: float = 510.0,
    viscosity_pa_s: float = 2.5e-3,
    conductivity_s_m: float = 8.0e5,
):
    """Hartmann-flow-corrected channel pressure loss (reference
    ``calculate_mhd_pressure_loss:186-216``).  Returns
    (pressure_loss_pa, hartmann_number)."""
    v = jnp.maximum(flow_velocity_m_s, 1e-6)
    nu = viscosity_pa_s / density_kg_m3
    ha = b_pol * channel_half_gap_m * jnp.sqrt(
        conductivity_s_m / jnp.maximum(density_kg_m3 * nu, 1e-12))
    dp_visc = 12.0 * viscosity_pa_s * channel_length_m * v \
        / channel_half_gap_m**2
    return dp_visc * (1.0 + ha / 6.0), ha


def evaporation_rate(surface_temp_c, flow_velocity_m_s):
    """Velocity-relieved Li evaporation [kg m^-2 s^-1] (reference
    ``estimate_evaporation_rate:218-224``)."""
    v = jnp.maximum(flow_velocity_m_s, 1e-6)
    thermal = jnp.exp(jnp.clip((surface_temp_c - 500.0) / 260.0, -8.0, 8.0))
    relief = 1.0 / (1.0 + 0.45 * jnp.sqrt(v))
    return 2.0e-6 * thermal * relief


class LiquidMetalState(NamedTuple):
    t_surface_c: jnp.ndarray
    q_surface: jnp.ndarray
    shielding_fraction: jnp.ndarray
    pressure_loss_pa: jnp.ndarray
    hartmann: jnp.ndarray
    evaporation_kg_m2_s: jnp.ndarray
    stability_index: jnp.ndarray
    is_stable: jnp.ndarray


def temhd_liquid_metal_state(
    flow_velocity_m_s,
    p_sol_mw,
    r_major,
    b_pol,
    *,
    expansion_factor=15.0,
) -> LiquidMetalState:
    """Combined reduced TEMHD divertor operating state + stability index
    (reference ``simulate_temhd_liquid_metal:226-258``: flux/45 MW +
    dP/0.8 MPa + evap/1e-3 <= 1).  Pure jnp — ``vmap`` over flow-velocity
    scans runs the whole operating map in one program."""
    load = divertor_heat_load(p_sol_mw, r_major, b_pol,
                              expansion_factor=expansion_factor)
    li = lithium_vapor_shield(load.q_target)
    dp, ha = mhd_pressure_loss(flow_velocity_m_s, b_pol)
    evap = evaporation_rate(li.t_surface_c, flow_velocity_m_s)
    idx = li.q_surface / 45.0e6 + dp / 8.0e5 + evap / 1.0e-3
    return LiquidMetalState(li.t_surface_c, li.q_surface, li.f_rad, dp, ha,
                            evap, idx, idx <= 1.0)


def flow_velocity_scan(velocities, p_sol_mw, r_major, b_pol,
                       *, expansion_factor=15.0) -> LiquidMetalState:
    """Vectorised operating-window scan over channel flow speeds."""
    return jax.vmap(
        lambda v: temhd_liquid_metal_state(
            v, p_sol_mw, r_major, b_pol,
            expansion_factor=expansion_factor))(jnp.asarray(velocities))
