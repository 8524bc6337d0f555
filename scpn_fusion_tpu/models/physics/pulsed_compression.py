"""FRC pulsed magnetic compression: coil circuit + adiabatic piston + flux.

JAX-native port of the reference's pulsed-compression lane
(``core/pulsed_compression.py:139-545``): a voltage-driven R-L coil bank
produces the external solenoid field ``B_ext = mu0 N I / L``; the magnetic
piston ``(p_int - B^2/2mu0) * 2 pi R L / m`` drives the separatrix radius;
compression is adiabatic (``T V^(gamma-1)`` invariant) with an optional
radial loss time; and energy bookkeeping tracks thermal / compression-work /
radiated channels with a normalised balance residual.

Where the reference integrates with a host Python loop over frozen
dataclasses (``run_pulsed_compression:450-465``), the whole trajectory here
is ONE ``lax.scan`` — the coil circuit and the plasma advance together in a
single compiled program, differentiable end-to-end through the drive
waveform (coil-bank voltage optimisation via ``jax.grad``, which the
reference cannot do).  The circuit step uses the same exact per-interval
R-L solution (``step_coil_circuit:164-209``): for constant V over dt,
``I(t+dt) = V/R + (I - V/R) exp(-R dt / L)``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

MU_0 = 4.0e-7 * jnp.pi
E_CHARGE = 1.602176634e-19


@dataclasses.dataclass(frozen=True)
class CoilGeometry:
    """Uniform-solenoid pulsed coil (reference ``CoilGeometry:44-53``)."""

    n_turns: int = 40
    l_coil_m: float = 1.0
    r_coil_m: float = 0.35
    inductance_h: float = 2.0e-6
    resistance_ohm: float = 5.0e-3
    bank_voltage_max_v: float = 5.0e3


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static parameters of the compression run."""

    coil: CoilGeometry = CoilGeometry()
    plasma_mass_kg: float = 2.0e-7
    plasma_length_m: float = 1.0
    gamma: float = 5.0 / 3.0
    radial_loss_time_s: float = jnp.inf
    min_radius_m: float = 1.0e-4


class CompressionState(NamedTuple):
    t_s: jnp.ndarray
    radius_m: jnp.ndarray
    velocity_m_s: jnp.ndarray
    t_i_ev: jnp.ndarray
    t_e_ev: jnp.ndarray
    density_m3: jnp.ndarray
    coil_current_a: jnp.ndarray
    thermal_energy_j: jnp.ndarray
    compression_work_j: jnp.ndarray
    radiated_loss_j: jnp.ndarray
    ohmic_loss_j: jnp.ndarray
    source_work_j: jnp.ndarray


class CompressionTrace(NamedTuple):
    state: CompressionState            # stacked over time
    b_ext_t: jnp.ndarray
    beta: jnp.ndarray
    balance_residual: jnp.ndarray


class CompressionDiagnostics(NamedTuple):
    """Aggregate trajectory diagnostics (reference
    ``pulsed_compression_trajectory_diagnostics:507-545``)."""

    min_radius_m: jnp.ndarray
    compression_ratio: jnp.ndarray
    max_abs_acceleration: jnp.ndarray
    radial_turning_points: jnp.ndarray
    floor_contact_count: jnp.ndarray
    max_balance_residual: jnp.ndarray


def coil_field_t(coil: CoilGeometry, current_a) -> jnp.ndarray:
    """``B_ext = mu0 N I / L`` (reference ``coil_field_t:139-143``)."""
    return MU_0 * coil.n_turns * current_a / coil.l_coil_m


def magnetic_pressure_pa(b_t) -> jnp.ndarray:
    return b_t * b_t / (2.0 * MU_0)


def thermal_pressure_pa(density_m3, t_i_ev, t_e_ev) -> jnp.ndarray:
    return density_m3 * (t_i_ev + t_e_ev) * E_CHARGE


def plasma_volume_m3(radius_m, length_m) -> jnp.ndarray:
    return jnp.pi * radius_m**2 * length_m


def adiabatic_temperature_ev(t_ev, v_old, v_new, gamma) -> jnp.ndarray:
    """``T V^(gamma-1)`` invariant (reference ``:299-312``)."""
    return t_ev * (v_old / v_new) ** (gamma - 1.0)


def _thermal_energy_j(density, volume, t_i, t_e) -> jnp.ndarray:
    return 1.5 * density * volume * (t_i + t_e) * E_CHARGE


def initial_state(
    cfg: CompressionConfig,
    *,
    radius_m=0.25,
    t_i_ev=100.0,
    t_e_ev=100.0,
    density_m3=5.0e20,
) -> CompressionState:
    vol = plasma_volume_m3(jnp.asarray(radius_m), cfg.plasma_length_m)
    z = jnp.asarray(0.0)
    return CompressionState(
        t_s=z, radius_m=jnp.asarray(radius_m), velocity_m_s=z,
        t_i_ev=jnp.asarray(t_i_ev), t_e_ev=jnp.asarray(t_e_ev),
        density_m3=jnp.asarray(density_m3),
        coil_current_a=z,
        thermal_energy_j=_thermal_energy_j(
            jnp.asarray(density_m3), vol, jnp.asarray(t_i_ev),
            jnp.asarray(t_e_ev)),
        compression_work_j=z, radiated_loss_j=z, ohmic_loss_j=z,
        source_work_j=z)


def _circuit_step(coil: CoilGeometry, i_a, v_drive, dt):
    """Exact constant-voltage R-L interval (reference ``:164-209``):
    ``I -> V/R + (I - V/R) e^(-R dt/L)``, with trapezoid energy ledgers."""
    v = jnp.clip(v_drive, -coil.bank_voltage_max_v, coil.bank_voltage_max_v)
    tau = coil.inductance_h / coil.resistance_ohm
    i_inf = v / coil.resistance_ohm
    i_new = i_inf + (i_a - i_inf) * jnp.exp(-dt / tau)
    di_dt = (v - coil.resistance_ohm * i_new) / coil.inductance_h
    # Trapezoid work/dissipation over the step.
    ohmic = 0.5 * coil.resistance_ohm * (i_a**2 + i_new**2) * dt
    source = 0.5 * v * (i_a + i_new) * dt
    return i_new, di_dt, ohmic, source


@partial(jax.jit, static_argnames=("cfg", "n_steps", "drive_voltage_t"))
def run_voltage_driven_compression(
    cfg: CompressionConfig,
    state0: CompressionState,
    drive_voltage_t: Callable,
    *,
    dt_s: float = 2.0e-8,
    n_steps: int = 2000,
) -> CompressionTrace:
    """Coupled coil-circuit + pressure-driven compression, one ``scan``
    (reference ``run_voltage_driven_pulsed_compression:467-504``)."""
    coil = cfg.coil

    def step(s: CompressionState, _):
        # 1) coil circuit over [t, t+dt]
        i_new, _, d_ohm, d_src = _circuit_step(
            coil, s.coil_current_a, drive_voltage_t(s.t_s), dt_s)
        field = coil_field_t(coil, i_new)
        p_ext = magnetic_pressure_pa(field)

        # 2) radial Newton piston (reference ``step_pulsed_compression``)
        vol_old = plasma_volume_m3(s.radius_m, cfg.plasma_length_m)
        p_int = thermal_pressure_pa(s.density_m3, s.t_i_ev, s.t_e_ev)
        area = 2.0 * jnp.pi * s.radius_m * cfg.plasma_length_m
        accel = (p_int - p_ext) * area / cfg.plasma_mass_kg
        vel = s.velocity_m_s + accel * dt_s
        radius = jnp.maximum(cfg.min_radius_m, s.radius_m + vel * dt_s)

        # 3) adiabatic compression + radial loss channel
        vol_new = plasma_volume_m3(radius, cfg.plasma_length_m)
        density = s.density_m3 * vol_old / vol_new
        t_i_ad = adiabatic_temperature_ev(s.t_i_ev, vol_old, vol_new,
                                          cfg.gamma)
        t_e_ad = adiabatic_temperature_ev(s.t_e_ev, vol_old, vol_new,
                                          cfg.gamma)
        e_ad = _thermal_energy_j(density, vol_new, t_i_ad, t_e_ad)
        loss = jnp.exp(-dt_s / cfg.radial_loss_time_s)
        t_i, t_e = t_i_ad * loss, t_e_ad * loss
        e_th = _thermal_energy_j(density, vol_new, t_i, t_e)

        work = s.compression_work_j + (e_ad - s.thermal_energy_j)
        rad = s.radiated_loss_j + (e_ad - e_th)
        residual = (e_th - s.thermal_energy_j
                    - (work - s.compression_work_j)
                    + (rad - s.radiated_loss_j))
        scale = jnp.maximum(
            jnp.maximum(jnp.abs(e_th), jnp.abs(s.thermal_energy_j)),
            jnp.maximum(jnp.abs(work), 1e-30))

        s_new = CompressionState(
            t_s=s.t_s + dt_s, radius_m=radius, velocity_m_s=vel,
            t_i_ev=t_i, t_e_ev=t_e, density_m3=density,
            coil_current_a=i_new, thermal_energy_j=e_th,
            compression_work_j=work, radiated_loss_j=rad,
            ohmic_loss_j=s.ohmic_loss_j + d_ohm,
            source_work_j=s.source_work_j + d_src)
        p_now = thermal_pressure_pa(density, t_i, t_e)
        beta = p_now / jnp.maximum(magnetic_pressure_pa(field), 1e-30)
        return s_new, (s_new, field, beta, residual / scale)

    _, (states, fields, betas, residuals) = jax.lax.scan(
        step, state0, None, length=n_steps)
    return CompressionTrace(states, fields, betas, residuals)


def trajectory_diagnostics(trace: CompressionTrace,
                           cfg: CompressionConfig,
                           r_initial) -> CompressionDiagnostics:
    """Validated aggregates (reference ``:507-545``): minimum radius,
    compression ratio, turning points (velocity sign changes), floor
    contacts, worst energy-balance residual."""
    r = trace.state.radius_m
    v = trace.state.velocity_m_s
    sign_change = jnp.signbit(v[1:]) != jnp.signbit(v[:-1])
    dv = (v[1:] - v[:-1])
    accel_max = jnp.max(jnp.abs(dv)) / (trace.state.t_s[1]
                                        - trace.state.t_s[0])
    return CompressionDiagnostics(
        min_radius_m=jnp.min(r),
        compression_ratio=jnp.asarray(r_initial) / jnp.maximum(
            jnp.min(r), 1e-30),
        max_abs_acceleration=accel_max,
        radial_turning_points=jnp.sum(sign_change),
        floor_contact_count=jnp.sum(r <= cfg.min_radius_m * (1.0 + 1e-9)),
        max_balance_residual=jnp.max(jnp.abs(trace.balance_residual)))
