"""Plasma-wall interaction: Bohdansky-Yamamura sputtering + erosion.

JAX-native equivalent of the reference PWI module
(``nuclear/pwi_erosion.py:26-160``): the reduced Bohdansky yield

    Y(E) = Q s_n(eps) (1 - (E_th/E)^{2/3})(1 - E_th/E)^2 f(angle)

with s_n = ln(1 + 1.2288 eps)/(1 + sqrt(eps)), eps = E/E_th, an angular
enhancement 1/cos(theta) capped at 5, redeposition, and the macroscopic
erosion rate in mm/year.  All functions broadcast over arrays (the
reference scans temperatures in a Python loop) and are differentiable,
so wall-lifetime sensitivities come from ``jax.grad``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

_MATERIALS = {
    # (E_th [eV], Q, atomic mass [amu], density [g/cc])
    "Tungsten": (200.0, 0.03, 183.84, 19.25),
    "Carbon": (30.0, 0.1, 12.0, 2.2),
}


@dataclasses.dataclass(frozen=True)
class SputteringMaterial:
    e_th_ev: float = 200.0
    q_yield: float = 0.03
    atomic_mass: float = 183.84
    density_g_cc: float = 19.25
    redeposition_factor: float = 0.95

    @classmethod
    def from_name(cls, name: str = "Tungsten",
                  redeposition_factor: float = 0.95):
        e_th, q, mass, rho = _MATERIALS.get(name, _MATERIALS["Carbon"])
        return cls(e_th, q, mass, rho,
                   float(min(max(redeposition_factor, 0.0), 0.999)))


def sputtering_yield(mat: SputteringMaterial, e_ion_ev, angle_deg=45.0):
    """Atoms ejected per incident ion; zero below threshold (broadcasts)."""
    e = jnp.asarray(e_ion_ev)
    e_safe = jnp.maximum(e, mat.e_th_ev * (1.0 + 1e-9))
    eps = e_safe / mat.e_th_ev
    ratio = mat.e_th_ev / e_safe
    s_n = jnp.log1p(1.2288 * eps) / (1.0 + jnp.sqrt(eps))
    thr = jnp.maximum((1.0 - ratio ** (2.0 / 3.0)) * (1.0 - ratio) ** 2, 0.0)
    theta = jnp.deg2rad(jnp.clip(jnp.asarray(angle_deg), 0.0, 89.0))
    f_ang = jnp.minimum(5.0, 1.0 / jnp.maximum(jnp.cos(theta), 1e-3))
    y = mat.q_yield * s_n * thr * f_ang
    return jnp.where(e > mat.e_th_ev, jnp.maximum(y, 0.0), 0.0)


def erosion_rate(mat: SputteringMaterial, flux_m2_s, t_ion_ev,
                 angle_deg=45.0):
    """Erosion metrics dict (impact energy 5 T_i sheath closure).

    Returns dict with Yield, E_impact, Net_Flux [1/m^2 s],
    Erosion_mm_year, Impurity_Source — same keys as the reference.
    """
    e_impact = 5.0 * jnp.asarray(t_ion_ev)
    y = sputtering_yield(mat, e_impact, angle_deg)
    flux_net = jnp.asarray(flux_m2_s) * y * (1.0 - mat.redeposition_factor)
    recession = flux_net * (mat.atomic_mass * 1.66e-27) \
        / (mat.density_g_cc * 1000.0)
    mm_year = recession * 1000.0 * (3600.0 * 24.0 * 365.0)
    return {
        "Yield": y,
        "E_impact": e_impact,
        "Net_Flux": flux_net,
        "Redeposition": mat.redeposition_factor,
        "Erosion_mm_year": mm_year,
        "Impurity_Source": flux_net,
    }


def erosion_scan(mat: SputteringMaterial, flux_m2_s, t_min_ev, t_max_ev,
                 n_points: int = 50, angle_deg=45.0):
    """Vectorised temperature scan (reference ``run_pwi_demo`` loop)."""
    temps = jnp.linspace(t_min_ev, t_max_ev, n_points)
    out = erosion_rate(mat, flux_m2_s, temps, angle_deg)
    return temps, out["Erosion_mm_year"], out["Yield"]
