"""Coolant-loop thermal hydraulics: friction factor + pumping power.

JAX-native port of the reference's lumped loop model
(``engineering/thermal_hydraulics.py:38-118``: Churchill all-regime Darcy
friction factor + Darcy-Weisbach pressure drop + pump power for
water/helium/LiPb loops).  Pure jnp functions — design scans ``vmap`` over
(Q, delta_T, L, D) envelopes in one compiled program, and the friction
factor is smooth and differentiable for gradient-based BoP optimisation
(the reference raises on Re <= 0; here inputs are clamped so the function
is total — design optimisers probe infeasible corners).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

#: Thermophysical properties at ~300 C (reference ``CoolantLoop.__init__``).
COOLANTS = {
    "water": {"rho": 700.0, "mu": 1e-4, "cp": 5000.0},
    "helium": {"rho": 5.0, "mu": 3e-5, "cp": 5190.0},
    "lipb": {"rho": 9000.0, "mu": 1e-3, "cp": 190.0},
}


def churchill_friction_factor(re, epsilon_d=1e-4):
    """Churchill correlation for the Darcy friction factor (all regimes:
    laminar / transition / turbulent; reference ``:38-53``)."""
    re = jnp.maximum(jnp.asarray(re, jnp.result_type(float, re)), 1e-3)
    a = (2.457 * jnp.log(1.0 / ((7.0 / re) ** 0.9 + 0.27 * epsilon_d))) ** 16
    b = (37530.0 / re) ** 16
    return 8.0 * ((8.0 / re) ** 12 + 1.0 / (a + b) ** 1.5) ** (1.0 / 12.0)


class PumpingPower(NamedTuple):
    mdot_kg_s: jnp.ndarray
    velocity_m_s: jnp.ndarray
    reynolds: jnp.ndarray
    friction_factor: jnp.ndarray
    dp_pa: jnp.ndarray
    p_pump_mw: jnp.ndarray


def pumping_power(
    q_thermal_mw,
    *,
    coolant: str = "water",
    delta_t=50.0,
    pipe_length_m=100.0,
    pipe_diameter_m=0.05,
    eta_pump: float = 0.8,
) -> PumpingPower:
    """Pumping power to exhaust ``q_thermal_mw`` through the loop
    (reference ``calculate_pumping_power:71-118``): mdot = Q/(cp dT),
    Darcy-Weisbach dP = f (L/D) rho v^2/2, P = dP mdot/(rho eta)."""
    p = COOLANTS[coolant]
    q = jnp.maximum(jnp.asarray(q_thermal_mw, jnp.result_type(float,
                                                              q_thermal_mw)),
                    0.0)
    mdot = q * 1e6 / (p["cp"] * delta_t)
    area = jnp.pi * (pipe_diameter_m / 2.0) ** 2
    v = mdot / (p["rho"] * area)
    re = p["rho"] * v * pipe_diameter_m / p["mu"]
    f = churchill_friction_factor(re)
    dp = f * (pipe_length_m / pipe_diameter_m) * p["rho"] * v**2 / 2.0
    p_pump = dp * (mdot / p["rho"]) / eta_pump
    return PumpingPower(mdot, v, re, f, dp, p_pump / 1e6)
