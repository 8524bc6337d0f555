"""Synthetic diagnostics: forward models from plasma state to detectors.

JAX port of the reference's forward-model suite
(``diagnostics/forward.py:133-560``) with identical physics closures:

* interferometer:  dphi = r_e * lambda * integral(n_e dl)
* neutron rate:    counts = sum(S_n) dV * efficiency * solid-angle
* Thomson voltage: V = g * n_e (1 + s * T_e) + baseline at sample points
* ECE:             optically-thick T_e(R_ch, z_obs) * optical-depth factor
* soft X-ray:      eps = n_e^2 sqrt(T_e) Z_eff exp(-E_filter/T_e), chord-integrated
* bolometer:       P = n_e^2 C_rad Z_eff^2 sqrt(T_e)(1 + f_imp), chord-integrated
* CXRS:            Gaussian-beam-weighted chord averages of T_i and rotation
* magnetics:       psi and (B_R, B_Z) sampled at probe points (the synthetic
                   sensor lane, ``diagnostics/synthetic_sensors.py:48-116``)

accelerator-first: chords are (n_chords, 2, 2) arrays and every channel family is a
single vmapped computation — no per-chord host loops; all models are
differentiable, so synthetic diagnostics can close inverse problems
(tomography, current reconstruction) by gradient descent.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium.topology import compute_b_field

ELECTRON_RADIUS_M = 2.8179403262e-15


def _nearest_indices(axis_min: float, step: float, n: int, values: jnp.ndarray):
    idx = jnp.round((values - axis_min) / step).astype(jnp.int32)
    return jnp.clip(idx, 0, n - 1)


def line_integral_nearest(
    field: jnp.ndarray,
    grid: Grid,
    chords: jnp.ndarray,       # (n_chords, 2, 2): [[r0,z0],[r1,z1]]
    samples: int = 96,
) -> jnp.ndarray:
    """Chord integrals with nearest-grid-point sampling (reference
    ``_line_integral_nearest`` semantics), vmapped over chords."""
    t = jnp.linspace(0.0, 1.0, samples)

    def one(chord):
        start, end = chord[0], chord[1]
        r_vals = start[0] + (end[0] - start[0]) * t
        z_vals = start[1] + (end[1] - start[1]) * t
        dl = jnp.hypot(end[0] - start[0], end[1] - start[1]) / samples
        ir = _nearest_indices(grid.R_min, grid.dR, grid.NR, r_vals)
        iz = _nearest_indices(grid.Z_min, grid.dZ, grid.NZ, z_vals)
        return jnp.sum(field[iz, ir]) * dl

    return jax.vmap(one)(chords)


def interferometer_phase_shift(
    electron_density_m3: jnp.ndarray,
    grid: Grid,
    chords: jnp.ndarray,
    *,
    laser_wavelength_m: float = 1.064e-6,
    samples: int = 96,
) -> jnp.ndarray:
    """Line-integrated interferometer phase shift [rad] per chord."""
    coeff = ELECTRON_RADIUS_M * laser_wavelength_m
    return coeff * line_integral_nearest(electron_density_m3, grid, chords, samples)


def neutron_count_rate(
    neutron_source_m3_s: jnp.ndarray,
    *,
    volume_element_m3,
    detector_efficiency: float = 0.12,
    solid_angle_fraction: float = 1.0e-4,
) -> jnp.ndarray:
    """Detector neutron count rate [Hz] from the volumetric source map."""
    emitted = jnp.sum(jnp.maximum(neutron_source_m3_s, 0.0)) * volume_element_m3
    return emitted * detector_efficiency * solid_angle_fraction


def thomson_scattering_voltage(
    electron_density_m3: jnp.ndarray,
    electron_temp_kev: jnp.ndarray,
    grid: Grid,
    sample_points: jnp.ndarray,   # (n_pts, 2)
    *,
    gain_v_per_m3: float = 2.5e-24,
    temp_sensitivity_per_kev: float = 0.08,
    baseline_voltage_v: float = 0.0,
) -> jnp.ndarray:
    """Thomson-scattering detector voltages at sample points."""
    ir = _nearest_indices(grid.R_min, grid.dR, grid.NR, sample_points[:, 0])
    iz = _nearest_indices(grid.Z_min, grid.dZ, grid.NZ, sample_points[:, 1])
    ne_local = jnp.maximum(electron_density_m3[iz, ir], 0.0)
    te_local = jnp.maximum(electron_temp_kev[iz, ir], 0.0)
    return (gain_v_per_m3 * ne_local
            * (1.0 + temp_sensitivity_per_kev * te_local) + baseline_voltage_v)


def ece_radiometer_temperature(
    electron_temp_kev: jnp.ndarray,
    grid: Grid,
    channel_r_positions: jnp.ndarray,
    *,
    z_observation: float = 0.0,
    optical_depth_factor: float = 1.0,
) -> jnp.ndarray:
    """Optically-thick ECE radiometer channels: T_e(R_ch, z_obs) * tau."""
    iz = _nearest_indices(grid.Z_min, grid.dZ, grid.NZ,
                          jnp.asarray(z_observation))
    ir = _nearest_indices(grid.R_min, grid.dR, grid.NR, channel_r_positions)
    return jnp.maximum(electron_temp_kev[iz, ir], 0.0) * optical_depth_factor


def soft_xray_brightness(
    electron_density_m3: jnp.ndarray,
    electron_temp_kev: jnp.ndarray,
    grid: Grid,
    chords: jnp.ndarray,
    *,
    z_eff: float = 1.5,
    filter_energy_kev: float = 1.0,
    samples: int = 96,
) -> jnp.ndarray:
    """Soft X-ray chord brightness: eps = ne^2 sqrt(Te) Z exp(-E_f/Te)."""
    te_safe = jnp.clip(electron_temp_kev, 0.01, None)
    emissivity = (electron_density_m3**2 * jnp.sqrt(te_safe) * z_eff
                  * jnp.exp(-filter_energy_kev / te_safe))
    return line_integral_nearest(emissivity, grid, chords, samples)


def bolometer_power_density(
    electron_density_m3: jnp.ndarray,
    electron_temp_kev: jnp.ndarray,
    grid: Grid,
    chords: jnp.ndarray,
    *,
    z_eff: float = 1.5,
    impurity_fraction: float = 0.02,
    samples: int = 96,
) -> jnp.ndarray:
    """Bolometer chords: P = ne^2 C_rad Z^2 sqrt(Te) (1 + f_imp)."""
    c_rad = 1.0e-31
    te_safe = jnp.clip(electron_temp_kev, 0.01, None)
    p_rad = (electron_density_m3**2 * c_rad * z_eff**2
             * jnp.sqrt(te_safe) * (1.0 + impurity_fraction))
    return line_integral_nearest(p_rad, grid, chords, samples)


def cxrs_ion_diagnostics(
    ion_temp_kev: jnp.ndarray,
    rotation_km_s: jnp.ndarray,
    grid: Grid,
    chords: jnp.ndarray,
    *,
    beam_r_center: float = 6.2,
    beam_width: float = 0.1,
    samples: int = 96,
):
    """CXRS: Gaussian-beam-weighted chord averages of (T_i, v_tor)."""
    t = jnp.linspace(0.0, 1.0, samples)

    def one(chord):
        start, end = chord[0], chord[1]
        r_vals = start[0] + (end[0] - start[0]) * t
        z_vals = start[1] + (end[1] - start[1]) * t
        ir = _nearest_indices(grid.R_min, grid.dR, grid.NR, r_vals)
        iz = _nearest_indices(grid.Z_min, grid.dZ, grid.NZ, z_vals)
        w = jnp.exp(-((r_vals - beam_r_center) / jnp.maximum(beam_width, 1e-6)) ** 2)
        w_sum = jnp.maximum(jnp.sum(w), 1e-12)
        ti = jnp.sum(w * ion_temp_kev[iz, ir]) / w_sum
        vrot = jnp.sum(w * rotation_km_s[iz, ir]) / w_sum
        return ti, vrot

    ti, vrot = jax.vmap(one)(chords)
    return ti, vrot


def synthetic_magnetic_probes(
    psi: jnp.ndarray,
    grid: Grid,
    probe_points: jnp.ndarray,   # (n_probes, 2)
):
    """Synthetic magnetics: (psi, B_R, B_Z) at probe points
    (reference ``diagnostics/synthetic_sensors.py:48-116`` lane)."""
    from scpn_fusion_tpu.models.equilibrium.free_boundary import interp_psi_at_points

    b_r, b_z = compute_b_field(psi, grid.RR, grid.dR, grid.dZ)
    psi_p = interp_psi_at_points(psi, grid, probe_points)
    b_r_p = interp_psi_at_points(b_r, grid, probe_points)
    b_z_p = interp_psi_at_points(b_z, grid, probe_points)
    return psi_p, b_r_p, b_z_p


class ForwardChannels(NamedTuple):
    """Bundle of all synthetic channels (reference
    ``ForwardDiagnosticChannels`` / ``generate_forward_channels``)."""

    interferometer_rad: jnp.ndarray
    neutron_rate_hz: jnp.ndarray
    thomson_v: jnp.ndarray
    ece_kev: jnp.ndarray
    soft_xray: jnp.ndarray
    bolometer: jnp.ndarray


def generate_forward_channels(
    *,
    ne_m3: jnp.ndarray,
    te_kev: jnp.ndarray,
    neutron_source: jnp.ndarray,
    grid: Grid,
    chords: jnp.ndarray,
    thomson_points: jnp.ndarray,
    ece_channels: jnp.ndarray,
    volume_element_m3,
) -> ForwardChannels:
    """All channel families in one jittable pass."""
    return ForwardChannels(
        interferometer_rad=interferometer_phase_shift(ne_m3, grid, chords),
        neutron_rate_hz=neutron_count_rate(
            neutron_source, volume_element_m3=volume_element_m3),
        thomson_v=thomson_scattering_voltage(ne_m3, te_kev, grid, thomson_points),
        ece_kev=ece_radiometer_temperature(te_kev, grid, ece_channels),
        soft_xray=soft_xray_brightness(ne_m3, te_kev, grid, chords),
        bolometer=bolometer_power_density(ne_m3, te_kev, grid, chords),
    )
