"""Pulsed axisymmetric Hall-MHD flux carrier (Ono Eq. 8 closure), compiled.

JAX-native port of the reference's pulsed-compression flux carrier
(``core/hall_mhd_pulsed.py:39-341``; Rust twin
``fusion-physics/src/hall_mhd_pulsed.rs``): Spitzer resistivity, circular-loop
Faraday drive ``E_theta = -r/2 dB_ext/dt`` from the external-field ramp,
implicit-backward-Euler and IMEX-RK2 integrators of

    dpsi/dt = hall_scale * R_null * E_theta - eta * J_theta - psi / tau_psi,

axial field ``B_z = (1/r) dpsi/dr``, and the magnetic-energy / L2 sink
diagnostics.  Whole trajectories run as one ``lax.scan``.

The external-field ramp is a traced function of time, so drive waveforms can
be optimised end-to-end with ``jax.grad``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

MU_0 = 4.0e-7 * jnp.pi


def spitzer_resistivity_ohm_m(
    temperature_ev,
    *,
    z_eff: float = 1.0,
    ln_lambda: float = 17.0,
):
    """Spitzer parallel resistivity [Ohm m] for T_e in eV.

    Wesson's coefficient form ``eta = 1.65e-9 Z lnLambda / T_keV^1.5``
    evaluated with the eV input converted to keV (equivalently
    ``5.218e-5 Z lnLambda / T_eV^1.5``); at 100 eV, Z=1, lnL=17 this gives
    8.9e-7 Ohm m, the NRL parallel value (0.51 x eta_perp).  DISCLOSED FIX vs the reference:
    ``core/hall_mhd_pulsed.py:74-86`` applies the keV coefficient directly
    to an eV temperature, underestimating eta by (1000)^1.5 ~ 3.2e4 (its
    own ``disruption_sequence`` sibling uses the correct eV coefficient
    5.2e-5).  The carrier dynamics only feel eta through the
    ``eta * J_theta`` sink, which every committed reference scenario runs
    with J_theta = 0, so trajectory parity is unaffected.
    """
    return 1.65e-9 * z_eff * ln_lambda / jnp.power(
        jnp.asarray(temperature_ev) / 1.0e3, 1.5)


def faraday_e_theta_from_b_ramp(
    rho_m: jnp.ndarray,
    b_ext_t: Callable,
    t_s,
    *,
    derivative_dt_s: float = 1.0e-9,
) -> jnp.ndarray:
    """Circular-loop Faraday drive ``E_theta = -r/2 dB_ext/dt`` (two-sided
    difference away from t=0, one-sided at the origin — reference :92-106)."""
    dt = derivative_dt_s
    db_central = (b_ext_t(t_s + dt) - b_ext_t(t_s - dt)) / (2.0 * dt)
    db_onesided = (b_ext_t(t_s + dt) - b_ext_t(t_s)) / dt
    db_dt = jnp.where(t_s >= dt, db_central, db_onesided)
    return -0.5 * rho_m * db_dt


def axial_field_from_flux(rho_m: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
    """``B_z = (1/r) dpsi/dr`` with finite-axis handling (B_z[0] = B_z[1]).

    Second-order one-sided edge stencils match the reference's
    ``np.gradient(..., edge_order=2)`` (uniform-grid form).
    """
    h = rho_m[1] - rho_m[0]
    interior = (psi[2:] - psi[:-2]) / (2.0 * h)
    left = (-3.0 * psi[0] + 4.0 * psi[1] - psi[2]) / (2.0 * h)
    right = (3.0 * psi[-1] - 4.0 * psi[-2] + psi[-3]) / (2.0 * h)
    dpsi_dr = jnp.concatenate([left[None], interior, right[None]])
    field = dpsi_dr / jnp.where(rho_m > 0, rho_m, 1.0)
    return field.at[0].set(field[1])


def _trapezoid(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(0.5 * (y[1:] + y[:-1]) * (x[1:] - x[:-1]))


def magnetic_energy_proxy(rho: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
    return _trapezoid(0.5 * psi * psi * 2.0 * jnp.pi * rho / MU_0, rho)


def _l2(rho: jnp.ndarray, profile: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(
        _trapezoid(profile * profile * 2.0 * jnp.pi * rho, rho), 0.0))


@dataclasses.dataclass(frozen=True)
class HallMHDPulsedParams:
    """Static carrier configuration (grid + profiles arrive as arrays)."""

    tau_psi_s: float
    electron_temperature_ev: float
    r_null_m: float
    z_eff: float = 1.0
    ln_lambda: float = 17.0
    hall_scale: float = 1.0
    time_integrator: str = "implicit_be"   # "implicit_be" | "imex_rk2"

    def __post_init__(self) -> None:
        for name in ("tau_psi_s", "electron_temperature_ev", "r_null_m"):
            if not getattr(self, name) > 0:
                raise ValueError(f"{name} must be positive")
        if self.time_integrator not in ("implicit_be", "imex_rk2"):
            raise ValueError("time_integrator must be 'implicit_be' or 'imex_rk2'")


class HallMHDState(NamedTuple):
    t_s: jnp.ndarray
    psi: jnp.ndarray


class HallMHDDiagnostics(NamedTuple):
    energy_proxy: jnp.ndarray
    hall_drive_l2: jnp.ndarray
    resistive_sink_l2: jnp.ndarray
    damping_sink_l2: jnp.ndarray
    source_residual_linf: jnp.ndarray


def _ono_source(params, rho, j_theta, b_ext_t, t_s):
    e_theta = faraday_e_theta_from_b_ramp(rho, b_ext_t, t_s)
    eta = spitzer_resistivity_ohm_m(
        jnp.full_like(rho, params.electron_temperature_ev),
        z_eff=params.z_eff, ln_lambda=params.ln_lambda)
    return params.hall_scale * params.r_null_m * e_theta - eta * j_theta, e_theta, eta


def step_hall_mhd_pulsed(
    state: HallMHDState,
    params: HallMHDPulsedParams,
    rho: jnp.ndarray,
    j_theta: jnp.ndarray,
    b_ext_t: Callable,
    dt_s,
):
    """One carrier step (implicit BE or IMEX-RK2, reference :218-243)."""
    psi, t = state.psi, state.t_s
    if params.time_integrator == "implicit_be":
        source, _, _ = _ono_source(params, rho, j_theta, b_ext_t, t + dt_s)
        psi_new = (psi + dt_s * source) / (1.0 + dt_s / params.tau_psi_s)
    else:  # imex_rk2
        source_2, _, _ = _ono_source(params, rho, j_theta, b_ext_t, t + 0.5 * dt_s)
        psi_new = (psi + dt_s * source_2) / (1.0 + dt_s / params.tau_psi_s)
        source = source_2

    residual = (psi_new - psi) / dt_s - source + psi_new / params.tau_psi_s
    scale = jnp.maximum(jnp.maximum(
        jnp.max(jnp.abs(source)), jnp.max(jnp.abs(psi_new / params.tau_psi_s))), 1.0)

    _, e_theta, eta = _ono_source(params, rho, j_theta, b_ext_t, t + dt_s)
    diag = HallMHDDiagnostics(
        energy_proxy=magnetic_energy_proxy(rho, psi_new),
        hall_drive_l2=_l2(rho, params.hall_scale * params.r_null_m * e_theta),
        resistive_sink_l2=_l2(rho, eta * j_theta),
        damping_sink_l2=_l2(rho, psi_new / params.tau_psi_s),
        source_residual_linf=jnp.max(jnp.abs(residual)) / scale,
    )
    return HallMHDState(t + dt_s, psi_new), diag


@partial(jax.jit, static_argnames=("params", "b_ext_t", "n_steps"))
def run_hall_mhd_pulsed(
    params: HallMHDPulsedParams,
    psi0: jnp.ndarray,
    rho: jnp.ndarray,
    j_theta: jnp.ndarray,
    b_ext_t: Callable,
    dt_s,
    *,
    n_steps: int,
):
    """Run the carrier trajectory under ``lax.scan``; returns the final
    state, final B_z, and per-step diagnostics."""
    init = HallMHDState(jnp.asarray(0.0, psi0.dtype), psi0)

    def step(s, _):
        s_new, diag = step_hall_mhd_pulsed(s, params, rho, j_theta, b_ext_t, dt_s)
        return s_new, diag

    final, diags = jax.lax.scan(step, init, None, length=n_steps)
    b_z = axial_field_from_flux(rho, final.psi)
    return final, b_z, diags
