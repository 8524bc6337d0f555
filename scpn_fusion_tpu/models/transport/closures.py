"""Transport closures: neoclassical, gyro-Bohm, bootstrap, reactivity, radiation.

JAX ports of the reference's closure kernels with identical formulas and
numeric guards:

* Chang-Hinton (1982) neoclassical chi_i — reference
  ``integrated_transport_solver.py:180-320``
* gyro-Bohm anomalous chi — ``integrated_transport_solver_model.py:393-487``
* full Sauter bootstrap current (Sauter et al., Phys. Plasmas 6, 1999) —
  ``integrated_transport_solver.py:322-497``
* Bosch-Hale D-T reactivity (NF 32 (1992) 611, Table IV) —
  ``core/uncertainty.py:208-229``
* coronal tungsten radiation rate + bremsstrahlung —
  ``integrated_transport_solver_runtime_physics.py:215-258``

All functions are pure jnp, differentiable, vmap-able.
"""

from __future__ import annotations

import jax.numpy as jnp

E_CHARGE = 1.602176634e-19
E_KEV_J = 1.602176634e-16
EPS0 = 8.854187812e-12
M_P = 1.672621924e-27
M_E = 9.10938370e-31

import numpy as _np


def _coulomb_prefactor(mass_kg: float) -> float:
    """Python-float constant K such that
    nu = K * n_19 * Z_factor * ln_lambda / T_keV^1.5  [1/s].

    Hoisting e^4 / (eps0^2 sqrt(m) (1e3 e)^1.5) into one host-side float is
    required for f32: the naive SI expression underflows (n * e^4 ~
    1e-56 < f32 min normal), which silently floors the chi closures and
    NaNs the pedestal model (found by on-hardware probing).
    """
    return float(1e19 * E_CHARGE**4
                 / (12.0 * _np.pi**1.5 * EPS0**2 * _np.sqrt(mass_kg)
                    * (1e3 * E_CHARGE) ** 1.5))


def _ln_lambda(t_kev: jnp.ndarray, n_e_m3: jnp.ndarray) -> jnp.ndarray:
    """NRL Coulomb logarithm with the reference's clamps."""
    return jnp.clip(
        17.7 + jnp.log(jnp.maximum(t_kev, 0.01) / 10.0)
        - 0.5 * jnp.log(jnp.maximum(n_e_m3, 1e10) / 1e20),
        10.0, 25.0)


def chang_hinton_chi(
    rho: jnp.ndarray,
    t_i_kev: jnp.ndarray,
    n_e_19: jnp.ndarray,
    q: jnp.ndarray,
    r0: float,
    a_minor: float,
    b0: float,
    a_ion: float = 2.0,
    z_eff: float = 1.5,
) -> jnp.ndarray:
    """Chang-Hinton (1982) neoclassical ion thermal diffusivity [m^2/s]."""
    rho_c = jnp.clip(rho, 0.0, 1.0)
    t_i = jnp.maximum(t_i_kev, 0.01)
    n_e = jnp.maximum(n_e_19, 0.1)
    q_c = jnp.maximum(q, 0.1)
    m_i = a_ion * M_P

    epsilon = rho_c * a_minor / r0
    valid = epsilon >= 1e-6

    t_j = t_i * E_KEV_J
    v_ti = jnp.sqrt(2.0 * t_j / m_i)
    rho_i = m_i * v_ti / (E_CHARGE * b0)
    n_m3 = n_e * 1e19
    ll = _ln_lambda(t_i, n_m3)
    nu_ii = _coulomb_prefactor(m_i) * n_e * z_eff**2 * ll / t_i**1.5

    eps_safe = jnp.where(valid, epsilon, 1.0)
    eps32 = eps_safe**1.5
    nu_star = jnp.maximum(nu_ii * q_c * r0 / (eps32 * v_ti), 0.0)
    chi = (0.66 * (1.0 + 1.54 * eps_safe) * q_c**2 * rho_i**2 * nu_ii
           / (eps32 * (1.0 + 0.74 * nu_star ** (2.0 / 3.0))))
    chi = jnp.where(jnp.isfinite(chi), jnp.maximum(chi, 0.01), 0.01)
    return jnp.where(valid, chi, 0.01)


def gyro_bohm_chi(
    t_i_kev: jnp.ndarray,
    t_e_kev: jnp.ndarray,
    q: jnp.ndarray,
    r0: float,
    a_minor: float,
    b0: float,
    a_ion: float = 2.0,
    c_gb: float = 1.0,
) -> jnp.ndarray:
    """Gyro-Bohm anomalous transport diffusivity [m^2/s]."""
    m_i = a_ion * M_P
    ti = jnp.maximum(t_i_kev, 0.01)
    te = jnp.maximum(t_e_kev, 0.01)
    qi = jnp.maximum(q, 0.5)
    t_i_j = ti * 1e3 * E_CHARGE
    t_e_j = te * 1e3 * E_CHARGE
    rho_s = jnp.sqrt(t_i_j * m_i) / (E_CHARGE * b0)
    c_s = jnp.sqrt(t_e_j / m_i)
    denom = jnp.maximum(a_minor * qi * r0, 1e-6)
    chi = c_gb * rho_s**2 * c_s / denom
    return jnp.where(jnp.isfinite(chi), jnp.maximum(chi, 0.01), 0.01)


def sauter_bootstrap_current(
    rho: jnp.ndarray,
    te_kev: jnp.ndarray,
    ti_kev: jnp.ndarray,
    ne_19: jnp.ndarray,
    q: jnp.ndarray,
    r0: float,
    a_minor: float,
    b0: float,
    z_eff: float = 1.5,
) -> jnp.ndarray:
    """Full Sauter bootstrap current density [A/m^2] (zero at both edges)."""
    n = rho.shape[0]
    te = jnp.maximum(te_kev, 0.01)
    ti = jnp.maximum(ti_kev, 0.01)
    ne = jnp.maximum(ne_19, 0.1)
    q_c = jnp.maximum(q, 0.1)

    # Interior arithmetic evaluated everywhere; edges zeroed at the end.
    eps = jnp.clip(rho * a_minor / r0, 1e-6, 0.999999)
    sqrt_trap = jnp.sqrt(jnp.maximum(1.0 - eps**2, 1e-12))
    f_t = 1.0 - (1.0 - eps) ** 2 / (sqrt_trap * (1.0 + 1.46 * jnp.sqrt(eps)))
    f_t = jnp.clip(f_t, 0.0, 1.0)

    t_e_j = te * 1e3 * E_CHARGE
    v_te = jnp.sqrt(2.0 * t_e_j / M_E)
    n_m3 = ne * 1e19
    ll = _ln_lambda(te, n_m3)
    nu_ei = _coulomb_prefactor(M_E) * ne * z_eff * ll / te**1.5
    nu_ei = jnp.where(jnp.isfinite(nu_ei) & (nu_ei >= 0), nu_ei, 0.0)
    nu_star_e = jnp.where(v_te > 0, nu_ei * q_c * r0 / (eps**1.5 * v_te), 1e6)
    nu_star_e = jnp.where(jnp.isfinite(nu_star_e) & (nu_star_e >= 0), nu_star_e, 1e6)

    alpha31 = 1.0 / (1.0 + 0.36 / z_eff)
    l31 = f_t * alpha31 / (1.0 + alpha31 * jnp.sqrt(nu_star_e)
                           + 0.25 * nu_star_e * (1.0 - f_t) ** 2)
    l32 = f_t * (0.05 + 0.62 * z_eff) / (z_eff * (1.0 + 0.44 * z_eff))
    l32 = l32 / (1.0 + 0.22 * jnp.sqrt(nu_star_e) + 0.19 * nu_star_e * (1.0 - f_t))
    l34 = l31 * ti / jnp.maximum(te, 0.01)

    # Central-difference gradients (edges dropped below).
    dr = (jnp.roll(rho, -1) - jnp.roll(rho, 1)) * a_minor
    dr_ok = jnp.abs(dr) >= 1e-12
    dr_safe = jnp.where(dr_ok, dr, 1.0)
    dn_dr = jnp.where(dr_ok, (jnp.roll(ne, -1) - jnp.roll(ne, 1)) * 1e19 / dr_safe, 0.0)
    dte_dr = jnp.where(dr_ok, (jnp.roll(te, -1) - jnp.roll(te, 1)) * 1e3 * E_CHARGE / dr_safe, 0.0)
    dti_dr = jnp.where(dr_ok, (jnp.roll(ti, -1) - jnp.roll(ti, 1)) * 1e3 * E_CHARGE / dr_safe, 0.0)

    b_pol = b0 * eps / jnp.maximum(q_c, 0.1)
    b_ok = b_pol >= 1e-10
    t_floor = 10.0 * E_CHARGE
    p_e = n_m3 * t_e_j
    j = -(p_e / jnp.where(b_ok, b_pol, 1.0)) * (
        l31 * dn_dr / jnp.maximum(n_m3, 1e10)
        + l32 * dte_dr / jnp.maximum(t_e_j, t_floor)
        + l34 * dti_dr / jnp.maximum(ti * 1e3 * E_CHARGE, t_floor)
    )
    j = jnp.where(dr_ok & b_ok & jnp.isfinite(j), j, 0.0)
    idx = jnp.arange(n)
    return jnp.where((idx == 0) | (idx == n - 1), 0.0, j)


def bosch_hale_sigmav(t_i_kev: jnp.ndarray) -> jnp.ndarray:
    """D-T fusion reactivity <sigma v> [m^3/s] (Bosch & Hale 1992)."""
    t = jnp.clip(t_i_kev, 0.2, 100.0)
    bg2 = 34.3827**2
    mrc2 = 1124656.0
    c1 = 1.17302e-9
    c2, c3 = 1.51361e-2, 7.51886e-2
    c4, c5 = 4.60643e-3, 1.35000e-2
    c6, c7 = -1.06750e-4, 1.36600e-5
    theta = t / (1.0 - t * (c2 + t * (c4 + t * c6))
                 / (1.0 + t * (c3 + t * (c5 + t * c7))))
    xi = (bg2 / (4.0 * theta)) ** (1.0 / 3.0)
    sv = c1 * theta * jnp.sqrt(xi / (mrc2 * t**3)) * jnp.exp(-3.0 * xi) * 1e-6
    return jnp.maximum(sv, 0.0)


def tungsten_radiation_rate(te_kev: jnp.ndarray) -> jnp.ndarray:
    """Coronal-equilibrium tungsten Lz [W m^3] (piecewise fit)."""
    te = jnp.clip(te_kev, 0.01, 1e3)
    return jnp.where(
        te < 1.0, 5.0e-31 * jnp.sqrt(te),
        jnp.where(te < 5.0, 5.0e-31,
                  jnp.where(te < 20.0, 2.0e-31 * te**0.3, 8.0e-31)))


def bremsstrahlung_power_density(
    ne_19: jnp.ndarray, te_kev: jnp.ndarray, z_eff: float
) -> jnp.ndarray:
    """Bremsstrahlung power density [W/m^3].

    Computed in 1e19-normalised density units: ne^2 in SI (~1e40) overflows
    f32; the prefactor folds the 1e38 back in host-side.
    """
    ne19 = jnp.clip(ne_19, 0.0, 1e6)
    te = jnp.clip(te_kev, 0.01, 1e3)
    z = jnp.clip(z_eff, 1e-6, 100.0)
    p = (5.35e-37 * 1e38) * z * ne19**2 * jnp.sqrt(te)
    return jnp.where(jnp.isfinite(p), p, 0.0)
