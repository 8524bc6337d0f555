"""Closure-based quasilinear gyrokinetic transport model (profile-level).

JAX-native port of the reference's ``core/gyrokinetic_transport.py`` —
the compact closure workflow that sits between the analytic gyro-Bohm
scaling and the full TGLF lane:

1. map normalized profiles into local TGLF-10-style parameters,
2. scan ``k_theta rho_s`` for ITG/TEM/ETG growth branches
   (``solve_dispersion`` :73-147: Dimits-shifted ITG threshold,
   Romanelli-Zonca TEM, Jenko ETG threshold),
3. saturate (``gamma_sat = gamma/(1+gamma q)``, mixing length
   ``|phi|^2 = 1/ky^2``) and sum quasilinear weights into
   ``chi_i, chi_e, D_e`` (``quasilinear_fluxes`` :205-283),
4. convert to physical units with gyro-Bohm scaling
   (``GyrokineticTransportModel.evaluate`` :334-428).

The reference evaluates one radius per Python call and loops the profile
(``evaluate_profile`` :430-495).  Here every step is branchless array
code over the full ``(n_modes,)`` spectrum, and the profile evaluation is
ONE ``vmap`` over radius — a whole-profile closure usable inside a jitted
transport step.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

M_DEUTERON = 2.0 * 1.6726219e-27
E_CHARGE = 1.602176634e-19
SQRT_MASS_RATIO = 60.6          # sqrt(m_D / m_e), reference :186


class QLLocalParams(NamedTuple):
    """TGLF-10 style local input vector (reference ``GyrokineticsParams``).

    Every field is a scalar (or batched) jnp array so the whole struct
    vmaps over radius."""

    r_l_ti: jnp.ndarray
    r_l_te: jnp.ndarray
    r_l_ne: jnp.ndarray
    q: jnp.ndarray
    s_hat: jnp.ndarray
    te_ti: jnp.ndarray
    z_eff: jnp.ndarray
    nu_star: jnp.ndarray
    epsilon: jnp.ndarray


class QLSpectrum(NamedTuple):
    k_y: jnp.ndarray          # (n_modes,)
    gamma: jnp.ndarray        # growth rate [c_s/R]
    omega_r: jnp.ndarray      # real frequency [c_s/R]
    mode_type: jnp.ndarray    # 0 stable, 1 ITG, 2 TEM, 3 ETG


class QLFluxes(NamedTuple):
    chi_i: jnp.ndarray
    chi_e: jnp.ndarray
    d_e: jnp.ndarray


def ion_scale_dispersion(p: QLLocalParams, k_y: jnp.ndarray):
    """ITG/TEM branch competition at one (or many) ``k_y`` (reference
    ``solve_dispersion`` :108-147), branchless."""
    # ITG: Dimits-shifted critical gradient.
    r_l_ti_crit = jnp.maximum(
        (4.0 / 3.0) * (1.0 + 1.0 / p.te_ti) * (1.0 + 2.0 * p.s_hat / p.q), 0.0)
    drive_itg = p.r_l_ti - r_l_ti_crit
    # Safe sqrt: evaluate the unstable branch on a clamped argument so the
    # where() gradient is finite at the threshold.
    sqrt_itg = jnp.sqrt(jnp.where(drive_itg > 0.0, drive_itg, 1.0))
    gamma_itg = jnp.where(
        drive_itg > 0.0,
        k_y * p.r_l_ti * sqrt_itg / (1.0 + k_y ** 2),
        0.0)
    omega_itg = jnp.where(drive_itg > 0.0, -k_y * p.r_l_ti / p.te_ti, 0.0)

    # TEM: Romanelli-Zonca with collisional detrapping via nu_star.
    f_t = jnp.sqrt(2.0 * p.epsilon / (1.0 + p.epsilon))
    omega_star_e = k_y * p.r_l_ne
    gamma_tem = jnp.where(
        omega_star_e > 0.0,
        f_t * omega_star_e / (1.0 + k_y ** 2 * (1.0 + p.nu_star)),
        0.0)
    omega_tem = omega_star_e

    itg_wins = (gamma_itg > gamma_tem) & (gamma_itg > 0.0)
    tem_wins = (gamma_tem > gamma_itg) & (gamma_tem > 0.0)
    gamma = jnp.where(itg_wins, gamma_itg, jnp.where(tem_wins, gamma_tem, 0.0))
    omega = jnp.where(itg_wins, omega_itg, jnp.where(tem_wins, omega_tem, 0.0))
    mode = jnp.where(itg_wins, 1, jnp.where(tem_wins, 2, 0))
    return gamma, omega, mode


def etg_dispersion(p: QLLocalParams, k_y: jnp.ndarray):
    """Jenko ETG branch (reference :97-106), scaled to c_s/R units."""
    r_l_te_crit = (1.0 + p.z_eff) * jnp.maximum(
        1.33 + 1.91 * p.s_hat / p.q, 0.0)
    drive = p.r_l_te - r_l_te_crit
    sqrt_etg = jnp.sqrt(jnp.where(drive > 0.0, drive, 1.0))
    gamma = jnp.where(
        drive > 0.0,
        k_y * p.r_l_te * sqrt_etg / (1.0 + k_y ** 2),
        0.0) * SQRT_MASS_RATIO
    omega = jnp.where(drive > 0.0, k_y * p.r_l_te, 0.0) * SQRT_MASS_RATIO
    mode = jnp.where(gamma > 0.0, 3, 0)   # k_y-shaped, matches ion branch
    return gamma, omega, mode


def compute_spectrum(p: QLLocalParams, n_modes: int = 16,
                     include_etg: bool = False) -> QLSpectrum:
    """Ion-scale (+ optional electron-scale) ``k_y`` scan as pure array ops
    (reference ``compute_spectrum`` :148-205)."""
    k_ion = jnp.linspace(0.1, 2.0, n_modes)
    g_i, w_i, m_i = ion_scale_dispersion(p, k_ion)
    if not include_etg:
        return QLSpectrum(k_ion, g_i, w_i, m_i)
    k_etg = jnp.linspace(2.0, 30.0, n_modes)
    g_e, w_e, m_e = etg_dispersion(p, k_etg)
    return QLSpectrum(jnp.concatenate([k_ion, k_etg]),
                      jnp.concatenate([g_i, g_e]),
                      jnp.concatenate([w_i, w_e]),
                      jnp.concatenate([m_i, m_e]))


def quasilinear_fluxes(p: QLLocalParams, spec: QLSpectrum) -> QLFluxes:
    """Saturation + quasilinear weights summed over the unstable spectrum
    (reference ``quasilinear_fluxes`` :205-283), fully vectorised."""
    gamma_max = 1.0 / jnp.maximum(p.q, 0.1)
    active = (spec.gamma > 0.0) & (spec.mode_type != 0)
    gamma_sat = spec.gamma / (1.0 + spec.gamma / gamma_max)
    phi_sq = 1.0 / spec.k_y ** 2
    omega_safe = jnp.where(spec.omega_r == 0.0, 1.0, spec.omega_r)

    # ITG channel -> chi_i
    omega_star_ti = -spec.k_y * p.r_l_ti / p.te_ti
    w_itg = jnp.where(active & (spec.mode_type == 1) & (p.r_l_ti > 0.0),
                      omega_star_ti / omega_safe, 0.0)
    chi_i = jnp.sum(gamma_sat * phi_sq * w_itg)

    # TEM channel -> chi_e, D_e
    omega_star_te = spec.k_y * p.r_l_te
    omega_star_n = spec.k_y * p.r_l_ne
    tem = active & (spec.mode_type == 2)
    w_te = jnp.where(tem & (p.r_l_te > 0.0), omega_star_te / omega_safe, 0.0)
    w_n = jnp.where(tem & (p.r_l_ne > 0.0), omega_star_n / omega_safe, 0.0)
    chi_e = jnp.sum(gamma_sat * phi_sq * w_te)
    d_e = jnp.sum(gamma_sat * phi_sq * w_n)

    # ETG channel -> chi_e, rho_e^2/rho_s^2 demotion (reference :268-277)
    etg = active & (spec.mode_type == 3)
    w_etg = jnp.where(etg & (p.r_l_te > 0.0), omega_star_te / omega_safe, 0.0)
    chi_e = chi_e + jnp.sum(gamma_sat * phi_sq * w_etg) / SQRT_MASS_RATIO ** 2

    return QLFluxes(jnp.maximum(chi_i, 0.0), jnp.maximum(chi_e, 0.0),
                    jnp.maximum(d_e, 0.0))


def infer_nu_star(r0, q, te_kev, ne_1e19, epsilon, z_eff=1.5,
                  ln_lambda=17.0):
    """Normalised electron collisionality
    ``nu_* = C R q n_e Z_eff lnLambda / (Te^2 eps^1.5)``
    (reference ``_infer_nu_star`` :296-333, coeff 6.921e-5)."""
    nu = (6.921e-5 * r0 * q * ne_1e19 * z_eff * ln_lambda
          / jnp.maximum(te_kev, 1e-9) ** 2)
    return jnp.maximum(nu / jnp.maximum(epsilon ** 1.5, 1e-12), 0.0)


@dataclasses.dataclass(frozen=True)
class QLTransportModel:
    """Drop-in quasilinear replacement for gyro-Bohm scaling (reference
    ``GyrokineticTransportModel`` :286-495)."""

    n_modes: int = 16
    include_etg: bool = False
    c_tune: float = 0.5          # macroscopic tuning constant
    axis_rho: float = 0.05
    axis_chi: float = 0.01

    def local_params(self, rho, te_kev, ti_kev, ne_1e19, q, s_hat,
                     dte_dr, dti_dr, dne_dr, r0, a, z_eff=1.5,
                     nu_star=None) -> QLLocalParams:
        """Profiles -> gradient-normalised local parameters
        (reference ``evaluate`` :358-408)."""
        r_l_te = jnp.maximum(-r0 / jnp.maximum(te_kev, 1e-3) * dte_dr, 0.0)
        r_l_ti = jnp.maximum(-r0 / jnp.maximum(ti_kev, 1e-3) * dti_dr, 0.0)
        r_l_ne = jnp.maximum(-r0 / jnp.maximum(ne_1e19, 1e-3) * dne_dr, 0.0)
        te_ti = jnp.maximum(te_kev / jnp.maximum(ti_kev, 1e-3), 0.1)
        epsilon = jnp.maximum(rho * a / r0, 1e-3)
        q_c = jnp.maximum(q, 0.5)
        if nu_star is None:
            nu_star = infer_nu_star(r0, q_c, te_kev, ne_1e19, epsilon,
                                    z_eff)
        return QLLocalParams(
            r_l_ti=r_l_ti, r_l_te=r_l_te, r_l_ne=r_l_ne, q=q_c,
            s_hat=jnp.asarray(s_hat, jnp.result_type(float)),
            te_ti=te_ti, z_eff=jnp.asarray(z_eff, jnp.result_type(float)),
            nu_star=nu_star, epsilon=epsilon)

    def evaluate_point(self, rho, p: QLLocalParams, te_kev, b0, r0):
        """(chi_i, chi_e, D_e) in m^2/s at one radius, branchless axis
        guard (reference :356 returns 0.01 inside rho<=0.05)."""
        spec = compute_spectrum(p, self.n_modes, self.include_etg)
        flux = quasilinear_fluxes(p, spec)
        te_j = te_kev * 1e3 * E_CHARGE
        c_s = jnp.sqrt(jnp.maximum(te_j, 1e-30) / M_DEUTERON)
        rho_s = M_DEUTERON * c_s / (E_CHARGE * b0)
        chi_gb = rho_s ** 2 * c_s / r0
        on_axis = rho <= self.axis_rho
        chi_i = jnp.where(on_axis, self.axis_chi,
                          flux.chi_i * chi_gb * self.c_tune)
        chi_e = jnp.where(on_axis, self.axis_chi,
                          flux.chi_e * chi_gb * self.c_tune)
        d_e = jnp.where(on_axis, self.axis_chi,
                        flux.d_e * chi_gb * self.c_tune)
        return chi_i, chi_e, d_e

    @partial(jax.jit, static_argnames=("self",))
    def evaluate_profile(self, rho, te_kev, ti_kev, ne_1e19, q, s_hat,
                         dte_dr, dti_dr, dne_dr, r0, a, b0,
                         z_eff=1.5):
        """Whole-profile closure: ONE vmapped program over radius
        (replaces the reference's per-point host loop :430-495)."""

        def point(rho_i, te_i, ti_i, ne_i, q_i, s_i, dte_i, dti_i, dne_i):
            p = self.local_params(rho_i, te_i, ti_i, ne_i, q_i, s_i,
                                  dte_i, dti_i, dne_i, r0, a, z_eff)
            return self.evaluate_point(rho_i, p, te_i, b0, r0)

        return jax.vmap(point)(rho, te_kev, ti_kev, ne_1e19, q, s_hat,
                               dte_dr, dti_dr, dne_dr)
