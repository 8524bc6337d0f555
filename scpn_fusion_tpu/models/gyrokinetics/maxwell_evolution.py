"""Local electromagnetic Maxwell evolution evidence for nonlinear GK.

Covers the reference's ``core/gk_maxwell_evolution.py``: a source-free
perpendicular spectral Maxwell system for ``A_parallel`` plus a
compressional ``B_parallel`` component, audited against Faraday
induction, the Ampere-Maxwell displacement current, the inductive
parallel electric field relation ``E_par = -dA/dt``, and the
perpendicular magnetic divergence constraint — with the same honest
claim boundary: it is *not* a Vlasov-Maxwell parity claim because the
kinetic current is not self-consistently supplied by the 5D
distribution (``self_consistent_kinetic_current_supported=False``).

JAX-native design: each spectral mode evolves as a closed-form harmonic
oscillator (``omega = c k_perp``), so the whole history is one
broadcast evaluation over a ``(n_steps, n_kx, n_ky)`` tensor — the
reference's per-step Python loop (``:187-253``) collapses into a single
fused jitted program.  Residual L-inf norms and field energies reduce
over the mode axes in the same kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

C_LIGHT = 299_792_458.0
EPSILON_0 = 8.854_187_8128e-12
MU_0_SI = 1.256_637_06212e-6
_TINY = 1.0e-300


@dataclass(frozen=True)
class MaxwellEvolutionConfig:
    """Source-free local spectral Maxwell evolution configuration
    (reference ``MaxwellEvolutionConfig:33-50``)."""

    n_kx: int = 8
    n_ky: int = 8
    n_steps: int = 16
    dt: float = 1.0e-12
    lx_m: float = 1.0
    ly_m: float = 1.0
    seed: int = 23
    amplitude_a_parallel: float = 1.0e-9
    amplitude_e_parallel: float = 1.0e-2
    amplitude_b_parallel: float = 1.0e-8
    amplitude_e_perpendicular: float = 1.0e-2
    courant_limit: float = 0.2
    relative_energy_tolerance: float = 1.0e-11
    residual_tolerance: float = 1.0e-12


class MaxwellEvolutionResult(NamedTuple):
    """Per-step diagnostics (jnp arrays; host decoration in
    :func:`to_evidence`)."""

    time_s: jnp.ndarray
    phi_energy_t: jnp.ndarray
    a_parallel_energy_t: jnp.ndarray
    b_parallel_energy_t: jnp.ndarray
    electric_parallel_energy_t: jnp.ndarray
    electric_perpendicular_energy_t: jnp.ndarray
    total_field_energy_t: jnp.ndarray
    faraday_linf_residual_t: jnp.ndarray
    ampere_maxwell_linf_residual_t: jnp.ndarray
    inductive_e_parallel_linf_residual_t: jnp.ndarray
    magnetic_divergence_linf_residual_t: jnp.ndarray
    relative_total_field_energy_drift: jnp.ndarray


def _spectral_grid(config: MaxwellEvolutionConfig):
    if config.n_kx < 2 or config.n_ky < 2:
        raise ValueError("Maxwell evolution requires at least two kx and ky modes")
    if config.n_steps < 2:
        raise ValueError("Maxwell evolution requires at least two saved steps")
    if config.dt <= 0.0 or config.lx_m <= 0.0 or config.ly_m <= 0.0:
        raise ValueError("Maxwell evolution requires positive dt and domain lengths")
    kx = 2.0 * np.pi * np.fft.fftfreq(config.n_kx, d=config.lx_m / config.n_kx)
    ky = 2.0 * np.pi * np.fft.fftfreq(config.n_ky, d=config.ly_m / config.n_ky)
    kxg, kyg = np.meshgrid(kx, ky, indexing="ij")
    k_perp = np.hypot(kxg, kyg)
    max_omega_dt = float(C_LIGHT * k_perp.max() * config.dt)
    if max_omega_dt > config.courant_limit:
        raise ValueError(
            "Courant limit violated for local Maxwell evolution: "
            f"max(c k_perp dt)={max_omega_dt:.6e}, "
            f"limit={config.courant_limit:.6e}")
    return jnp.asarray(kxg), jnp.asarray(kyg), jnp.asarray(k_perp)


def _random_complex_modes(rng, shape, amplitude):
    modes = amplitude * (rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape)) / np.sqrt(2.0)
    modes[0, 0] = 0.0
    return jnp.asarray(modes)


@partial(jax.jit, static_argnames=("n_steps", "dt"))
def _evolve(kx, ky, k_perp, a0, e0, b0, c0, *, n_steps: int, dt: float
            ) -> MaxwellEvolutionResult:
    """All timesteps in one broadcast evaluation: leading axis is time."""
    omega = C_LIGHT * k_perp
    inv_omega = jnp.where(k_perp > 0.0, 1.0 / jnp.where(k_perp > 0.0, omega, 1.0), 0.0)
    t = jnp.arange(n_steps, dtype=k_perp.dtype) * dt
    phase = t[:, None, None] * omega[None, :, :]
    cos_p, sin_p = jnp.cos(phase), jnp.sin(phase)

    a = a0 * cos_p - e0 * inv_omega * sin_p
    e_par = e0 * cos_p + omega * a0 * sin_p
    da_dt = -e_par
    d2a_dt2 = -(omega**2) * a
    b_par = b0 * cos_p - c0 / C_LIGHT * sin_p
    e_perp = c0 * cos_p + C_LIGHT * b0 * sin_p

    bx = 1j * ky * a
    by = -1j * kx * a
    dbx_dt = 1j * ky * da_dt
    dby_dt = -1j * kx * da_dt

    faraday_x = dbx_dt + 1j * ky * e_par
    faraday_y = dby_dt - 1j * kx * e_par
    ampere = d2a_dt2 + omega**2 * a
    inductive = e_par + da_dt
    div_b = 1j * kx * bx + 1j * ky * by

    def _linf(num, scale):
        return jnp.max(num / jnp.maximum(scale, _TINY), axis=(1, 2))

    faraday_scale = jnp.maximum(
        jnp.maximum(jnp.abs(dbx_dt), jnp.abs(dby_dt)),
        jnp.maximum(jnp.abs(kx * e_par), jnp.abs(ky * e_par)))
    faraday_res = _linf(jnp.maximum(jnp.abs(faraday_x), jnp.abs(faraday_y)),
                        faraday_scale)
    ampere_res = _linf(jnp.abs(ampere),
                       jnp.maximum(jnp.abs(d2a_dt2), jnp.abs(omega**2 * a)))
    inductive_res = _linf(jnp.abs(inductive),
                          jnp.maximum(jnp.abs(e_par), jnp.abs(da_dt)))
    div_res = _linf(jnp.abs(div_b),
                    jnp.maximum(jnp.abs(kx * bx), jnp.abs(ky * by)))

    e_par_energy = 0.5 * EPSILON_0 * jnp.sum(jnp.abs(e_par)**2, axis=(1, 2))
    a_energy = 0.5 / MU_0_SI * jnp.sum(jnp.abs(bx)**2 + jnp.abs(by)**2,
                                       axis=(1, 2))
    b_energy = 0.5 / MU_0_SI * jnp.sum(jnp.abs(b_par)**2, axis=(1, 2))
    e_perp_energy = 0.5 * EPSILON_0 * jnp.sum(jnp.abs(e_perp)**2, axis=(1, 2))
    total = e_par_energy + a_energy + b_energy + e_perp_energy
    drift = jnp.max(jnp.abs(total - total[0])) / jnp.maximum(
        jnp.abs(total[0]), _TINY)

    return MaxwellEvolutionResult(
        time_s=t,
        phi_energy_t=jnp.zeros_like(t),
        a_parallel_energy_t=a_energy,
        b_parallel_energy_t=b_energy,
        electric_parallel_energy_t=e_par_energy,
        electric_perpendicular_energy_t=e_perp_energy,
        total_field_energy_t=total,
        faraday_linf_residual_t=faraday_res,
        ampere_maxwell_linf_residual_t=ampere_res,
        inductive_e_parallel_linf_residual_t=inductive_res,
        magnetic_divergence_linf_residual_t=div_res,
        relative_total_field_energy_drift=drift)


def run_local_maxwell_evolution(
    config: MaxwellEvolutionConfig = MaxwellEvolutionConfig(),
) -> MaxwellEvolutionResult:
    """Run the source-free local spectral Maxwell evolution
    (reference ``run_local_maxwell_evolution:158``)."""
    kx, ky, k_perp = _spectral_grid(config)
    rng = np.random.default_rng(config.seed)
    shape = (config.n_kx, config.n_ky)
    a0 = _random_complex_modes(rng, shape, config.amplitude_a_parallel)
    e0 = _random_complex_modes(rng, shape, config.amplitude_e_parallel)
    b0 = _random_complex_modes(rng, shape, config.amplitude_b_parallel)
    c0 = _random_complex_modes(rng, shape, config.amplitude_e_perpendicular)
    return _evolve(kx, ky, k_perp, a0, e0, b0, c0,
                   n_steps=config.n_steps, dt=config.dt)


def to_evidence(result: MaxwellEvolutionResult,
                config: MaxwellEvolutionConfig) -> dict[str, object]:
    """JSON-serialisable fail-closed evidence record
    (reference ``MaxwellEvolutionResult.to_evidence:82-116``)."""
    max_faraday = float(jnp.max(result.faraday_linf_residual_t))
    max_ampere = float(jnp.max(result.ampere_maxwell_linf_residual_t))
    max_inductive = float(jnp.max(result.inductive_e_parallel_linf_residual_t))
    max_div = float(jnp.max(result.magnetic_divergence_linf_residual_t))
    drift = float(result.relative_total_field_energy_drift)
    accepted = (drift <= config.relative_energy_tolerance
                and max_faraday <= config.residual_tolerance
                and max_ampere <= config.residual_tolerance
                and max_inductive <= config.residual_tolerance
                and max_div <= config.residual_tolerance)
    return {
        "schema": "gk-maxwell-evolution.v1",
        "saved_steps": int(result.time_s.shape[0]),
        "max_faraday_linf_residual": max_faraday,
        "max_ampere_maxwell_linf_residual": max_ampere,
        "max_inductive_e_parallel_linf_residual": max_inductive,
        "max_magnetic_divergence_linf_residual": max_div,
        "max_relative_total_field_energy_drift": drift,
        "relative_energy_tolerance": config.relative_energy_tolerance,
        "residual_tolerance": config.residual_tolerance,
        "faraday_induction_supported": True,
        "ampere_maxwell_displacement_current_supported": True,
        "inductive_parallel_electric_field_supported": True,
        "magnetic_divergence_constraint_supported": True,
        "self_consistent_kinetic_current_supported": False,
        "status": ("accepted_local_source_free_maxwell_evolution" if accepted
                   else "blocked_local_maxwell_evolution_residuals_failed"),
    }
