"""FRC n=1 tilt-mode diagnostics + rigid-rotor validation contracts.

Covers the reference's MIF/FRC stability family
(``core/tilt_mode_frc.py``, ``core/frc_rigid_rotor_closures.py:167``
``_s_parameter_from_profile``, ``core/frc_rigid_rotor_validation.py:27``
``validate_equilibrium``) with a JAX-native design:

* the Steinhauer Eq. 27 kinetic parameter
  ``s = (1/R_s) \\int_0^{R_s} r / rho_i(r) dr`` is computed with a
  static-shape separatrix *mask* (no data-dependent clipping, so the
  whole diagnostic jits and vmaps over equilibrium batches);
* the tilt growth rate is the Belova-normalised MHD Alfven scaling
  ``gamma = C * V_A / (E * R_s)`` (reference
  ``tilt_mode_frc.py:110`` ``frc_tilt_growth_rate``);
* projecting the diagnostic over a pulsed-compression trajectory
  (reference ``tilt_mode_frc.py:152``) is one vectorised program:
  per-sample growth rates in a single fused evaluation and the
  cumulative growth exponent as a trapezoidal ``cumsum`` — not a host
  loop over states;
* rigid-body FLR regime classification returns an integer code (0-3)
  so it can live inside jitted safety supervisors; the string names are
  host-side decoration.

Like the reference, the tilt *stability claim* is fail-closed: without a
redistributable digitised Belova Table I, ``tilt_mode_stable`` always
returns ``stable=False`` and exposes the growth estimate as a
diagnostic (reference ``tilt_mode_frc.py:287-301``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from scpn_fusion_tpu.core.dtypes import default_float
from scpn_fusion_tpu.models.physics.frc import MU0, FRCEquilibriumState

ATOMIC_MASS_KG = 1.66053906892e-27
ELEMENTARY_CHARGE_C = 1.602176634e-19
DEUTERIUM_MASS_AMU = 2.014102

# Belova-normalised n=1 MHD tilt growth coefficient and the rigid-body
# FLR s/E thresholds (reference ``tilt_mode_frc.py:33-36``).
BELOVA_MHD_GROWTH_COEFFICIENT = 1.2
DIAMAGNETIC_S_OVER_E = 1.7
GYROVISCOUS_S_OVER_E = 2.2
COMBINED_FLR_S_OVER_E = 2.8

REGIME_NAMES = (
    "diamagnetic_flr_threshold_passed",
    "gyroviscous_flr_threshold_passed",
    "combined_flr_threshold_passed",
    "mhd_tilt_susceptible",
)


class TiltModeReport(NamedTuple):
    """Jit-friendly n=1 tilt diagnostic (reference ``FRCTiltModeReport``)."""

    growth_rate_s_inv: jnp.ndarray
    alfven_speed_m_s: jnp.ndarray
    alfven_transit_time_s: jnp.ndarray
    s_parameter: jnp.ndarray
    elongation: jnp.ndarray
    s_over_elongation: jnp.ndarray
    regime_code: jnp.ndarray        # int32 index into REGIME_NAMES
    threshold_passed: jnp.ndarray   # bool: any FLR threshold satisfied


class TiltTrajectory(NamedTuple):
    """Tilt diagnostic projected over a compression trajectory."""

    t_s: jnp.ndarray
    growth_rate_s_inv: jnp.ndarray
    s_parameter: jnp.ndarray
    s_over_elongation: jnp.ndarray
    regime_code: jnp.ndarray
    cumulative_growth_integral: jnp.ndarray
    perturbation_amplification: jnp.ndarray
    amplification_overflow_limited: jnp.ndarray


class FRCValidationReport(NamedTuple):
    """Fail-closed rigid-rotor equilibrium audit (reference
    ``frc_rigid_rotor_validation.py:27``)."""

    finite: jnp.ndarray
    force_balance_ok: jnp.ndarray
    ampere_ok: jnp.ndarray
    flux_derivative_ok: jnp.ndarray
    pressure_balance_ok: jnp.ndarray
    field_reversal_ok: jnp.ndarray
    psi_monotonic_ok: jnp.ndarray
    null_radius_ok: jnp.ndarray
    all_passed: jnp.ndarray
    force_balance_residual: jnp.ndarray
    ampere_residual: jnp.ndarray
    flux_derivative_residual: jnp.ndarray
    pressure_balance_residual: jnp.ndarray


def alfven_speed_m_s(b_reference_t, density_peak_m3,
                     ion_mass_amu: float = DEUTERIUM_MASS_AMU) -> jnp.ndarray:
    """``V_A = |B| / sqrt(mu0 * n_m * m_i)`` (reference ``tilt_mode_frc.py:91``)."""
    rho_m = density_peak_m3 * ion_mass_amu * ATOMIC_MASS_KG
    return jnp.abs(b_reference_t) / jnp.sqrt(MU0 * rho_m)


def s_parameter(
    eq: FRCEquilibriumState,
    t_i_ev,
    ion_mass_amu: float = DEUTERIUM_MASS_AMU,
) -> jnp.ndarray:
    """Steinhauer Eq. 27: ``s = (1/R_s) \\int_0^{R_s} r / rho_i dr``.

    The reference clips the profile at the separatrix with
    ``np.searchsorted`` + ``np.append`` (dynamic shapes,
    ``frc_rigid_rotor_closures.py:150-186``); here the integrand is
    masked to ``rho <= R_s`` so the trapezoid runs over the full static
    grid and the function jits/vmaps.  The endpoint sliver between the
    last in-separatrix node and ``R_s`` is added analytically.
    """
    thermal_momentum = jnp.sqrt(
        2.0 * ion_mass_amu * ATOMIC_MASS_KG * t_i_ev * ELEMENTARY_CHARGE_C)
    inv_gyro = ELEMENTARY_CHARGE_C * jnp.abs(eq.b_z) / thermal_momentum
    integrand = eq.rho * inv_gyro

    inside = eq.rho <= eq.r_s
    pair_in = inside[:-1] & inside[1:]
    dr = jnp.diff(eq.rho)
    core = jnp.sum(jnp.where(pair_in,
                             0.5 * (integrand[:-1] + integrand[1:]) * dr, 0.0))

    # Analytic sliver [r_last, R_s]: linear interpolation of the integrand.
    r_last = jnp.max(jnp.where(inside, eq.rho, -jnp.inf))
    f_last = jnp.max(jnp.where(inside, jnp.where(eq.rho == r_last, integrand,
                                                 -jnp.inf), -jnp.inf))
    f_sep = jnp.interp(eq.r_s, eq.rho, integrand)
    sliver = jnp.maximum(eq.r_s - r_last, 0.0) * 0.5 * (f_last + f_sep)
    return (core + sliver) / eq.r_s


def s_over_elongation(eq: FRCEquilibriumState, t_i_ev, elongation) -> jnp.ndarray:
    """Dimensionless ``s / E`` rigid-body stability diagnostic."""
    return s_parameter(eq, t_i_ev) / jnp.asarray(elongation)


def rigid_body_flr_regime_code(ratio) -> jnp.ndarray:
    """Map ``s/E`` onto the 4-regime FLR ladder as an int32 code."""
    ratio = jnp.asarray(ratio)
    return (
        (ratio > DIAMAGNETIC_S_OVER_E).astype(jnp.int32)
        + (ratio > GYROVISCOUS_S_OVER_E).astype(jnp.int32)
        + (ratio > COMBINED_FLR_S_OVER_E).astype(jnp.int32)
    )


def regime_name(code) -> str:
    """Host-side decoration of a regime code."""
    return REGIME_NAMES[int(code)]


def _report_from_values(*, s_value, b_reference_t, density_peak_m3, radius_m,
                        elongation, mhd_coefficient, ion_mass_amu) -> TiltModeReport:
    speed = alfven_speed_m_s(b_reference_t, density_peak_m3, ion_mass_amu)
    half_length = jnp.asarray(radius_m) * jnp.asarray(elongation)
    ratio = s_value / jnp.asarray(elongation)
    code = rigid_body_flr_regime_code(ratio)
    return TiltModeReport(
        growth_rate_s_inv=mhd_coefficient * speed / half_length,
        alfven_speed_m_s=speed,
        alfven_transit_time_s=half_length / speed,
        s_parameter=jnp.asarray(s_value),
        elongation=jnp.asarray(elongation, default_float()),
        s_over_elongation=ratio,
        regime_code=code,
        threshold_passed=code < 3,
    )


def tilt_mode_report(
    eq: FRCEquilibriumState,
    t_i_ev,
    elongation,
    *,
    mhd_coefficient: float = BELOVA_MHD_GROWTH_COEFFICIENT,
    ion_mass_amu: float = DEUTERIUM_MASS_AMU,
) -> TiltModeReport:
    """n=1 tilt diagnostic for a rigid-rotor state (ref ``tilt_mode_frc.py:264``)."""
    return _report_from_values(
        s_value=s_parameter(eq, t_i_ev, ion_mass_amu),
        b_reference_t=jnp.max(jnp.abs(eq.b_z)),
        density_peak_m3=jnp.max(eq.density),
        radius_m=eq.r_s,
        elongation=elongation,
        mhd_coefficient=mhd_coefficient,
        ion_mass_amu=ion_mass_amu,
    )


def tilt_mode_stable(eq: FRCEquilibriumState, t_i_ev, elongation) -> tuple[bool, jnp.ndarray]:
    """Fail-closed stability claim: always ``(False, gamma)`` until a
    digitised Belova Table I reference exists (ref ``tilt_mode_frc.py:287``)."""
    report = tilt_mode_report(eq, t_i_ev, elongation)
    return False, report.growth_rate_s_inv


def belova_table1_acceptance_status() -> dict[str, str]:
    """Fail-closed external-parity status (ref ``tilt_mode_frc.py:304``)."""
    return {
        "case": "belova_2001_table1_tilt_stability",
        "status": "blocked_missing_public_digitised_reference",
        "required_artifact": (
            "digitised Belova Table I growth/stability data with provenance, "
            "checksum, and matching equilibrium-deck metadata"),
    }


def claim_boundary() -> dict[str, str]:
    return {
        "accepted": ("MHD Alfven-time tilt-growth diagnostic with conservative "
                     "fail-closed status"),
        "not_accepted": ("full Belova hybrid eigenvalue solver or Table I "
                         "same-case parity"),
    }


def tilt_trajectory_from_compression(
    eq: FRCEquilibriumState,
    t_i_ev_ref,
    elongation,
    *,
    t_s: jnp.ndarray,
    radius_m: jnp.ndarray,
    t_i_ev: jnp.ndarray,
    density_m3: jnp.ndarray,
    b_ext_t: jnp.ndarray,
    mhd_coefficient: float = BELOVA_MHD_GROWTH_COEFFICIENT,
    ion_mass_amu: float = DEUTERIUM_MASS_AMU,
) -> TiltTrajectory:
    """Project the tilt diagnostic over a pulsed-compression trajectory.

    Reference semantics (``tilt_mode_frc.py:152-247``): the compression
    state carries no radial profile per sample, so ``s`` is projected
    self-similarly, ``s(t) = s0 * (R/R0) * (B/B0) * sqrt(T0/T)``, and the
    cumulative growth exponent is the trapezoidal integral of the
    per-sample growth rates.  The reference accumulates in a Python
    ``for`` over states; here the whole trajectory is one vectorised
    program — per-sample reports in a single fused evaluation and the
    exponent as a trapezoidal ``cumsum`` — so it fuses into the
    pulsed-compression scan products (``models/physics/pulsed_compression.py``).
    """
    s0 = s_parameter(eq, t_i_ev_ref, ion_mass_amu)
    r0, b0, temp0 = radius_m[0], jnp.abs(b_ext_t[0]), t_i_ev[0]
    s_t = s0 * (radius_m / r0) * (jnp.abs(b_ext_t) / b0) * jnp.sqrt(temp0 / t_i_ev)

    speed = alfven_speed_m_s(b_ext_t, density_m3, ion_mass_amu)
    gamma = mhd_coefficient * speed / (radius_m * jnp.asarray(elongation))
    ratio = s_t / jnp.asarray(elongation)
    code = rigid_body_flr_regime_code(ratio)

    dt = jnp.diff(t_s)
    increments = 0.5 * (gamma[:-1] + gamma[1:]) * dt
    cumulative = jnp.concatenate([jnp.zeros((1,), gamma.dtype),
                                  jnp.cumsum(increments)])
    log_max = jnp.log(jnp.finfo(gamma.dtype).max)
    overflow = cumulative > log_max
    amplification = jnp.exp(jnp.minimum(cumulative, log_max))
    return TiltTrajectory(
        t_s=t_s, growth_rate_s_inv=gamma, s_parameter=s_t,
        s_over_elongation=ratio, regime_code=code,
        cumulative_growth_integral=cumulative,
        perturbation_amplification=amplification,
        amplification_overflow_limited=overflow)


def validate_rigid_rotor(
    eq: FRCEquilibriumState,
    *,
    tolerance: float = 2e-2,
) -> FRCValidationReport:
    """Audit a rigid-rotor state against its own closure identities.

    Mirrors the magnetostatic gates of the reference's
    ``validate_equilibrium`` (``frc_rigid_rotor_validation.py:27``):
    radial force balance ``d(p + B^2/2mu0)/dr = 0``, Ampere's law
    ``J_theta = -(1/mu0) dB_z/dr``, the flux derivative
    ``dpsi/dr = B_z r``, constant total pressure, field reversal inside
    the separatrix, monotone normalised flux, and the analytic null at
    ``R_s/sqrt(2)``.  All residuals are relative, the report is a pytree
    of scalars, and the whole audit jits.
    """
    dr = eq.rho[1] - eq.rho[0]
    b_e = jnp.max(jnp.abs(eq.b_z))
    scale_p = b_e**2 / (2.0 * MU0)

    finite = (jnp.all(jnp.isfinite(eq.b_z)) & jnp.all(jnp.isfinite(eq.pressure))
              & jnp.all(jnp.isfinite(eq.psi)) & jnp.all(jnp.isfinite(eq.j_theta)))

    total = eq.pressure + eq.b_z**2 / (2.0 * MU0)
    fb_res = jnp.max(jnp.abs(jnp.diff(total))) / (scale_p / eq.r_s * dr)

    dbz = jnp.gradient(eq.b_z, dr)
    amp_res = jnp.max(jnp.abs(eq.j_theta + dbz / MU0)) / (b_e / (MU0 * eq.r_s))

    dpsi = jnp.gradient(eq.psi, dr)
    flux_res = jnp.max(jnp.abs(dpsi - eq.b_z * eq.rho)) / (b_e * eq.r_s)

    # Constant total pressure: audit against the profile's own mean (the
    # grid max |B_z| under-reads B_e when tanh has not saturated at the wall).
    total_ref = jnp.mean(total)
    pb_res = jnp.max(jnp.abs(total - total_ref)) / total_ref

    # Field reversal: B_z changes sign across the null inside [0, R_s].
    inside = eq.rho < eq.r_s
    reversal = (jnp.min(jnp.where(inside, eq.b_z, jnp.inf)) < 0.0) & (
        jnp.max(jnp.where(inside, eq.b_z, -jnp.inf)) > 0.0)

    # psi rises monotonically from the axis to the null, falls beyond it.
    null_ok = jnp.abs(eq.r_null - eq.r_s / jnp.sqrt(2.0)) <= tolerance * eq.r_s
    pre_null = eq.rho[:-1] < eq.r_null
    dpsi_steps = jnp.diff(eq.psi)
    span = jnp.max(jnp.abs(eq.psi)) + 1e-300
    mono = jnp.all(jnp.where(pre_null, dpsi_steps >= -tolerance * span,
                             dpsi_steps <= tolerance * span))

    checks = (fb_res <= tolerance, amp_res <= tolerance,
              flux_res <= tolerance, pb_res <= tolerance)
    all_passed = finite & reversal & mono & null_ok
    for ok in checks:
        all_passed = all_passed & ok
    return FRCValidationReport(
        finite=finite,
        force_balance_ok=checks[0], ampere_ok=checks[1],
        flux_derivative_ok=checks[2], pressure_balance_ok=checks[3],
        field_reversal_ok=reversal, psi_monotonic_ok=mono,
        null_radius_ok=null_ok, all_passed=all_passed,
        force_balance_residual=fb_res, ampere_residual=amp_res,
        flux_derivative_residual=flux_res, pressure_balance_residual=pb_res)
