"""Quasi-3D physics contracts: cross-subsystem validation-grade coupling.

Compiled re-design of the reference's Task-4 contract module
(``core/quasi_3d_contracts.py``): synthetic SOLPS-like toroidal heat-flux
references derived from JET G-EQDSK data (:56-126), axisymmetric-vs-
stellarator force-balance observables (:126-199), Hall-MHD zonal-ratio
estimation (:200-251), a toroidal-poloidal force-residual relaxation
(:252-316), electron-ion two-fluid evolution coupled to TEMHD surface
cooling (:317-372), divertor heat-load profile construction (:373-430),
and TBR calibration against erosion trend curves (:431-508).

Design deltas (deliberate, accelerator-first):
* The reference steps ONE shared ``TEMHD_Stabilizer`` sequentially across
  all profile points inside a double Python loop (:361-365) — its thermal
  state bleeds between toroidal positions.  Here each profile point
  carries an independent vmapped TEMHD column, and the 120-step two-fluid
  relaxation is one ``lax.scan``.
* Asymmetry observables come from an rfft over the toroidal angle of the
  flux-surface geometry rather than from a sampled field-line trace —
  same (n1, n2, asymmetry index, radial spread) surface, deterministic.
* The force-residual relaxation (:302-310) is a ``lax.scan`` over
  iterations; the erosion angle curve (:457-473) is one vmap.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.models.nuclear.blanket import BlanketConfig, volumetric_tbr
from scpn_fusion_tpu.models.nuclear.pwi import SputteringMaterial, erosion_rate
from scpn_fusion_tpu.models.nuclear.temhd import (
    TEMHDParams,
    init_temhd,
    temhd_step,
)
from scpn_fusion_tpu.models.physics.divertor_lab import temhd_liquid_metal_state
from scpn_fusion_tpu.models.physics.hall_mhd_discovery import (
    init_hall_mhd,
    run_hall_mhd,
)
from scpn_fusion_tpu.models.physics.stellarator import StellaratorConfig

# ── SOLPS-like JET reference profile ─────────────────────────────────────


def jet_solps_reference_profile(
    geqdsk_stats: list[dict[str, float]],
    toroidal_points: int = 48,
) -> tuple[np.ndarray, dict[str, Any]]:
    """Deterministic SOLPS-surrogate toroidal heat-flux profile from JET
    equilibrium statistics (reference :56-126: amplitude from edge psi
    gradient and q95, low-order toroidal harmonics with per-file phases).

    ``geqdsk_stats``: one dict per equilibrium with keys ``q95``,
    ``edge_gradient``, ``bcentr`` — extract with
    :func:`geqdsk_profile_stats` from a parsed G-EQDSK.
    """
    if toroidal_points < 16:
        raise ValueError("toroidal_points must be >= 16.")
    if not geqdsk_stats:
        raise ValueError("geqdsk_stats must be non-empty.")
    angles = np.linspace(0.0, 2.0 * np.pi, toroidal_points, endpoint=False)
    profiles = []
    for i, st in enumerate(geqdsk_stats):
        q95 = float(st["q95"])
        eg = float(st["edge_gradient"])
        bc = abs(float(st["bcentr"]))
        amp = 8.0e5 * (1.0 + 3.2 * eg) * (1.0 + 0.03 * (q95 - 4.0))
        phase = 0.17 * i
        prof = amp * (1.0
                      + 0.14 * np.cos(angles - phase)
                      + 0.05 * np.cos(2.0 * angles + 0.6 * phase)
                      + 0.03 * np.sin(angles + 0.2 * bc))
        profiles.append(np.clip(prof, 5.0e4, None))
    ref = np.mean(np.stack(profiles), axis=0)
    meta = {
        "jet_file_count": len(profiles),
        "mean_q95": float(np.mean([s["q95"] for s in geqdsk_stats])),
        "mean_edge_gradient": float(
            np.mean([s["edge_gradient"] for s in geqdsk_stats])),
    }
    return ref, meta


def geqdsk_profile_stats(eq) -> dict[str, float]:
    """Extract the (q95, edge_gradient, bcentr) statistics the SOLPS
    surrogate needs from a parsed G-EQDSK (reference :90-106)."""
    psi_mid = np.asarray(eq.psirz[eq.nh // 2, :], float)
    denom = float(eq.sibry - eq.simag)
    if not np.isfinite(denom) or abs(denom) < 1e-12:
        raise ValueError("degenerate psi span")
    psi_norm = np.clip((psi_mid - float(eq.simag)) / denom, 0.0, 1.2)
    edge_grad = float(np.mean(np.abs(np.gradient(psi_norm)[-8:])))
    q = np.asarray(eq.qpsi, float)
    if q.size > 0 and np.all(np.isfinite(q)):
        q95 = float(abs(q[min(q.size - 1, int(0.95 * (q.size - 1)))]))
    else:
        q95 = 4.2
    return {"q95": q95, "edge_gradient": edge_grad,
            "bcentr": float(eq.bcentr)}


# ── Quasi-3D force balance observables ───────────────────────────────────


def _surface_points(cfg: StellaratorConfig, s, theta, phi):
    """Cartesian points of the parametric flux surface at (s, theta, phi)
    (same map as ``stellarator.stellarator_flux_surface``, point-wise)."""
    r_min = cfg.a * jnp.sqrt(jnp.clip(s, 1e-6, 1.0))
    delta_r = cfg.helical_excursion * jnp.cos(cfg.n_fp * phi)
    r_maj = cfg.r0 + r_min * jnp.cos(theta) + delta_r
    z = r_min * jnp.sin(theta) \
        + cfg.helical_excursion * jnp.sin(cfg.n_fp * phi)
    x = r_maj * jnp.cos(phi)
    y = r_maj * jnp.sin(phi)
    return x, y, z, r_maj


class ForceBalanceObservables(NamedTuple):
    force_balance_rmse_pct: jnp.ndarray
    asymmetry_index: jnp.ndarray
    radial_spread_m: jnp.ndarray
    n1_amp: jnp.ndarray
    n2_amp: jnp.ndarray
    z_n1_amp: jnp.ndarray


@partial(jax.jit, static_argnames=("base", "stellar", "samples", "n_phi"))
def quasi_3d_force_balance(
    key: jnp.ndarray,
    *,
    base: StellaratorConfig,
    stellar: StellaratorConfig,
    samples: int = 720,
    rho: float = 0.92,
    n_phi: int = 96,
) -> ForceBalanceObservables:
    """Distance RMSE between paired axisymmetric/stellarator surfaces at
    random (theta, phi) samples plus toroidal-harmonic asymmetry
    observables (reference :126-199)."""
    k1, k2 = jax.random.split(key)
    theta = jax.random.uniform(k1, (samples,)) * 2.0 * jnp.pi
    phi = jax.random.uniform(k2, (samples,)) * 2.0 * jnp.pi
    s = rho * rho
    xb, yb, zb, _ = _surface_points(base, s, theta, phi)
    xs, ys, zs, _ = _surface_points(stellar, s, theta, phi)
    dist = jnp.sqrt((xs - xb) ** 2 + (ys - yb) ** 2 + (zs - zb) ** 2)
    rmse_pct = 100.0 * jnp.sqrt(jnp.mean(dist**2)) / stellar.a

    # Toroidal-harmonic observables from the outboard-midplane ring.
    # A stellarator-symmetric surface has zero amplitude at n=1..n_fp-1,
    # so the leading asymmetry harmonics live at multiples of the field
    # period: report (n1, n2, n3) as the per-field-period harmonic family
    # (bins n_fp, 2 n_fp, 3 n_fp) — the reference's field-line-sampled
    # observables pick up the same structure aliased to low n.
    phi_ring = jnp.linspace(0.0, 2.0 * jnp.pi, n_phi, endpoint=False)
    _, _, z_ring, r_ring = _surface_points(
        stellar, s, jnp.zeros_like(phi_ring), phi_ring)
    r_hat = jnp.fft.rfft(r_ring - jnp.mean(r_ring)) / n_phi
    z_hat = jnp.fft.rfft(z_ring - jnp.mean(z_ring)) / n_phi
    nb = r_hat.shape[0] - 1
    b1, b2, b3 = (min(stellar.n_fp, nb), min(2 * stellar.n_fp, nb),
                  min(3 * stellar.n_fp, nb))
    n1 = 2.0 * jnp.abs(r_hat[b1])
    n2 = 2.0 * jnp.abs(r_hat[b2])
    n3 = 2.0 * jnp.abs(r_hat[b3])
    z_n1 = 2.0 * jnp.abs(z_hat[b1])
    asym = jnp.sqrt(n1**2 + n2**2 + n3**2) / stellar.a
    spread = jnp.std(r_ring)
    return ForceBalanceObservables(rmse_pct, asym, spread, n1, n2, z_n1)


# ── Hall-MHD zonal ratio ─────────────────────────────────────────────────


def hall_mhd_zonal_ratio(key, *, grid: int = 18, steps: int = 36) -> dict:
    """Mean zonal-to-total energy ratio from the spectral Hall-MHD sandbox
    (reference :200-251 — its ``HallMHD`` backend lane; the proxy fallback
    is unnecessary here because the backend is always present)."""
    state0 = init_hall_mhd(key, grid)
    trace = run_hall_mhd(state0, n_steps=steps, n=grid)
    ratios = trace.zonal_energy / jnp.maximum(trace.total_energy, 1e-12)
    ratio = float(jnp.mean(ratios))
    if not np.isfinite(ratio) or ratio <= 0.0:
        return {"backend": "proxy", "zonal_ratio": 0.06}
    return {"backend": "hall_mhd", "zonal_ratio": ratio}


# ── Force-residual relaxation ────────────────────────────────────────────


@partial(jax.jit, static_argnames=("poloidal_points", "toroidal_points",
                                   "iterations"))
def solve_quasi_3d_force_residual(
    asymmetry_index,
    n1_amp,
    n2_amp,
    *,
    poloidal_points: int = 56,
    toroidal_points: int = 48,
    iterations: int = 14,
):
    """Fixed-point pressure/J x B residual relaxation over a
    (theta, phi) grid (reference :252-316), iterations as one scan.
    Returns ``(mean_pct, p95_pct)``."""
    theta = jnp.linspace(0.0, 2.0 * jnp.pi, poloidal_points,
                         endpoint=False)
    phi = jnp.linspace(0.0, 2.0 * jnp.pi, toroidal_points, endpoint=False)
    th, ph = jnp.meshgrid(theta, phi, indexing="ij")
    pressure = 1.0 * (1.0
                      + 0.05 * asymmetry_index * jnp.cos(th - 0.25 * ph)
                      + 0.03 * n1_amp * jnp.cos(ph)
                      + 0.02 * n2_amp * jnp.cos(2.0 * ph))
    baseline_grad = jnp.gradient(pressure, axis=0)
    jxb_target = baseline_grad * (1.0
                                  + 0.10 * asymmetry_index * jnp.cos(ph)
                                  + 0.06 * n1_amp * jnp.cos(th - ph)
                                  + 0.04 * n2_amp * jnp.cos(th - 2.0 * ph))

    def body(p, _):
        resid = jnp.gradient(p, axis=0) - jxb_target
        return jnp.clip(p - 0.45 * resid, 0.30, 4.50), resid

    _, resids = jax.lax.scan(body, pressure, None, length=iterations)
    residual = resids[-1]
    denom = jnp.maximum(jnp.mean(jnp.abs(jxb_target)), 1e-9)
    abs_r = jnp.abs(residual)
    return (100.0 * jnp.mean(abs_r) / denom,
            100.0 * jnp.percentile(abs_r, 95.0) / denom)


# ── Two-fluid + TEMHD coupling ───────────────────────────────────────────


@partial(jax.jit, static_argnames=("n_steps",))
def two_fluid_temhd_coupled_profile(
    raw_heat_flux_w_m2: jnp.ndarray,
    zonal_ratio,
    *,
    n_steps: int = 120,
):
    """Electron-ion two-fluid relaxation with per-point TEMHD surface
    cooling (reference :317-372).  Each profile point carries its own
    vmapped TEMHD column (see module docstring); the whole evolution is
    one scan.  Returns ``(coupled_profile, diagnostics dict)``."""
    raw = jnp.asarray(raw_heat_flux_w_m2)
    te0 = 8.0 + 1.5e-5 * raw
    ti0 = 11.0 + 1.8e-5 * raw
    p = TEMHDParams(layer_thickness_mm=7.0, b_field_t=11.5, n_cells=24)
    states0 = jax.vmap(lambda _: init_temhd(p))(raw)
    zr = jnp.clip(zonal_ratio, 0.0, 1.0)

    def body(carry, _):
        te, ti, states = carry
        delta = te - ti
        nu_ei = 0.18 + 0.52 * zr
        q_ei = nu_ei * delta
        te = jnp.clip(te + 0.008 * (6.0e-5 * raw - q_ei - 0.22 * te),
                      2.0, 45.0)
        ti = jnp.clip(ti + 0.008 * (8.0e-5 * raw + q_ei - 0.17 * ti),
                      2.0, 65.0)
        states, t_surf_k, _ = jax.vmap(
            lambda s, q: temhd_step(p, s, q / 1e6, 0.05))(states, raw)
        cooling = jax.nn.sigmoid((t_surf_k - 273.15 - 720.0) / 180.0)
        relax = 0.060 * cooling + 0.022 * jnp.clip(delta / 18.0, -1.0, 1.0)
        coupled = raw * jnp.clip(1.0 - relax, 0.70, 0.989)
        return (te, ti, states), coupled

    (te, ti, _), coupled_t = jax.lax.scan(
        body, (te0, ti0, states0), None, length=n_steps)
    coupled = coupled_t[-1]
    diag = {
        "two_fluid_temp_split_index": jnp.mean(jnp.abs(te - ti))
            / jnp.maximum(jnp.mean(te), 1e-9),
        "electron_temp_mean_kev": jnp.mean(te),
        "ion_temp_mean_kev": jnp.mean(ti),
    }
    return coupled, diag


# ── Divertor profile construction ────────────────────────────────────────


def build_divertor_profiles(
    *,
    n1_amp,
    n2_amp,
    z_n1_amp,
    zonal_ratio,
    reference_profile_w_m2: np.ndarray,
) -> dict[str, Any]:
    """Divertor heat-load toroidal profile: TEMHD liquid-metal base state,
    harmonic asymmetry structure, reference-mean normalisation, two-fluid
    TEMHD cooling (reference :373-430)."""
    ref = jnp.asarray(reference_profile_w_m2)
    n = ref.shape[0]
    state = temhd_liquid_metal_state(5.0, 42.0, 2.95, 1.3,
                                     expansion_factor=22.0)
    q_base = state.q_surface
    angles = jnp.linspace(0.0, 2.0 * jnp.pi, n, endpoint=False)
    raw = q_base * (1.0
                    + 0.08 * n1_amp * jnp.cos(angles)
                    + 0.05 * n2_amp * jnp.cos(2.0 * angles)
                    - 0.03 * z_n1_amp * jnp.sin(angles)
                    + 0.03 * zonal_ratio * jnp.sin(3.0 * angles))
    raw = raw * (jnp.mean(ref) / jnp.maximum(jnp.mean(raw), 1e-9))
    cool, diag = two_fluid_temhd_coupled_profile(raw, zonal_ratio)
    gain_pct = 100.0 * (jnp.mean(raw) - jnp.mean(cool)) \
        / jnp.maximum(jnp.mean(raw), 1e-12)
    return {
        "reference_profile_w_m2": np.asarray(ref),
        "predicted_profile_w_m2": np.asarray(cool),
        "cooling_gain_pct": float(gain_pct),
        "two_fluid_diag": {k: float(v) for k, v in diag.items()},
        "divertor_state": {
            "hartmann_number": float(state.hartmann),
            "stability_index": float(state.stability_index),
            "surface_temperature_c": float(state.t_surface_c),
            "surface_heat_flux_w_m2": float(state.q_surface),
        },
    }


# ── TBR calibration against erosion curves ───────────────────────────────

ASDEX_EROSION_ANGLES_DEG = np.asarray([15.0, 30.0, 45.0, 60.0, 75.0])
ASDEX_EROSION_SHAPE = np.asarray([0.70, 0.90, 1.00, 1.22, 1.44])


def calibrate_tbr_with_erosion(
    *,
    mean_heat_flux_w_m2: float,
    thickness_cm: float,
    asdex_erosion_ref_mm_year: float,
) -> dict[str, Any]:
    """TBR calibrated by tungsten-erosion trend parity against the ASDEX
    shape curve (reference :431-508): erosion angle-curve from the PWI
    model (vmapped), shape RMSE penalty, blanket TBR scaled by the
    erosion-headroom factor."""
    mat = SputteringMaterial.from_name("Tungsten", redeposition_factor=0.97)
    flux = max(1.0e21, (float(mean_heat_flux_w_m2) / 1.2e6) * 2.0e21)
    angles = jnp.asarray(ASDEX_EROSION_ANGLES_DEG)
    curve = jax.vmap(
        lambda a: erosion_rate(mat, flux, 65.0, a)["Erosion_mm_year"]
    )(angles)
    curve = np.asarray(curve)
    erosion = float(np.mean(curve))
    ref_curve = ASDEX_EROSION_SHAPE * float(asdex_erosion_ref_mm_year)
    ref_shape = ref_curve / max(float(np.mean(ref_curve)), 1e-12)
    pred_shape = curve / max(erosion, 1e-12)
    rmse_pct = float(100.0 * np.sqrt(np.mean((ref_shape - pred_shape) ** 2))
                     / max(float(np.mean(np.abs(ref_shape))), 1e-12))

    blanket = volumetric_tbr(
        BlanketConfig(thickness_cm=float(thickness_cm), li6_enrichment=1.0),
        major_radius_m=6.2, minor_radius_m=2.0, elongation=1.7)
    raw_tbr = float(blanket.tbr)
    base = min(1.0, float(asdex_erosion_ref_mm_year) / max(erosion, 1e-12))
    penalty = float(np.clip(1.0 - 0.004 * rmse_pct, 0.60, 1.00))
    factor = base * penalty
    return {
        "particle_flux_m2_s": flux,
        "estimated_erosion_mm_year": erosion,
        "asdex_reference_erosion_mm_year": float(asdex_erosion_ref_mm_year),
        "raw_tbr": raw_tbr,
        "calibration_factor": factor,
        "calibrated_tbr": raw_tbr * factor,
        "erosion_curve_rmse_pct": rmse_pct,
        "calibration_triggered": bool(raw_tbr > 1.1),
    }
