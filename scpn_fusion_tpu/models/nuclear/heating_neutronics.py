"""Heating + neutronics candidate contracts (Task-6 lane).

Covers the reference's ``core/heating_neutronics_contracts.py``:
GENRAY-like RF/NBI absorption proxy (``genray_like_heating_proxy:52``),
ARIES-AT fusion-gain proxy (``aries_at_q_proxy:124``), MCNP-lite TBR
projection (``mcnp_lite_tbr:141``), a lightweight stochastic
neutron-transport TBR estimate (``mcnp_lite_transport_tbr:160``), and
the candidate sample/score/refine pipeline
(``quick_candidate:231`` / ``refine_candidate_tbr:311``).

JAX-native design decisions:

* the heating proxy evaluates ALL rays at once as an
  ``(n_rays, n_steps)`` tensor — launch phases, pitches, survival
  ``cumprod`` along the path axis, resonance kernels, and reflection
  masks are one fused program (the reference loops rays in Python);
* the transport estimate is a **non-analog weight-based Monte Carlo**:
  a fixed particle array advances through a bounded number of
  interaction rounds under ``lax.fori_loop``; the reference's
  stack-based branching at multiplication events
  (two secondaries of weights 0.90w / 0.70w) is replaced by weight
  combination (one particle of weight 1.60w whose direction samples the
  weighted mixture of the two branch distributions).  Capture/leak
  tallies agree in expectation by linearity of transport in weight;
  this is a standard variance-reduction redesign that keeps every
  shape static for XLA;
* candidate scoring rides this repo's differentiable 0D design chain
  (``models/physics/design_scan.evaluate_design``) and volumetric
  blanket surrogate (``models/nuclear/blanket.volumetric_tbr``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.models.nuclear.blanket import BlanketConfig, volumetric_tbr
from scpn_fusion_tpu.models.physics.design_scan import evaluate_design

TBR_EQUIVALENCE_SCALE = 1.45


def require_fraction(name: str, value) -> float:
    out = float(value)
    if not np.isfinite(out) or out < 0.0 or out > 1.0:
        raise ValueError(f"{name} must be finite and in [0, 1].")
    return out


@partial(jax.jit, static_argnames=("n_rays", "n_steps"))
def genray_heating_proxy(
    key: jax.Array,
    *,
    major_radius_m,
    elongation,
    b_t,
    rf_power_mw,
    nbi_power_mw,
    n_rays: int = 96,
    n_steps: int = 120,
) -> dict[str, jnp.ndarray]:
    """Deterministic ray-path RF/NBI absorption proxy, all rays fused
    (reference ``genray_like_heating_proxy:52-123``)."""
    t = jnp.linspace(0.0, 1.0, n_steps)[None, :]            # (1, S)
    i = jnp.arange(n_rays, dtype=t.dtype)[:, None]          # (R, 1)
    launch_phase = 2.0 * jnp.pi * (i + 0.5) / n_rays
    pitch = jax.random.uniform(key, (n_rays, 1), t.dtype, -0.22, 0.22)

    rf_sigma = 0.12 + 0.02 * jnp.maximum(elongation - 1.6, 0.0)
    nbi_sigma = 0.16 + 0.03 * jnp.maximum(2.0 - elongation, 0.0)
    rf_res = 0.34 + 0.03 * jnp.tanh((b_t - 5.8) / 2.0)
    nbi_res = 0.56 + 0.04 * jnp.tanh((major_radius_m - 6.0) / 1.8)

    radius = jnp.clip(1.0 - 0.92 * t + 0.03 * jnp.sin(3.0 * t + launch_phase),
                      0.02, 1.2)
    tor_phase = launch_phase + (1.6 + 0.2 * pitch) * t
    shear_mod = 1.0 + 0.08 * jnp.cos(2.0 * tor_phase)
    density = 0.35 + 0.65 * jnp.clip(1.0 - radius**2, 0.0, 1.0)

    rf_cut = 0.90 + 0.03 * jnp.sin(launch_phase)
    nbi_cut = 0.95 + 0.02 * jnp.cos(launch_phase)
    rf_mask = density > rf_cut
    nbi_mask = density > nbi_cut
    rf_survival = jnp.cumprod(jnp.where(rf_mask, 0.92, 0.996), axis=1)
    nbi_survival = jnp.cumprod(jnp.where(nbi_mask, 0.95, 0.997), axis=1)

    rf_kernel = (jnp.exp(-(((radius - rf_res) / rf_sigma) ** 2))
                 * shear_mod * rf_survival)
    nbi_kernel = (jnp.exp(-(((radius - nbi_res) / nbi_sigma) ** 2))
                  * (1.0 + 0.05 * jnp.sin(1.5 * tor_phase + pitch))
                  * nbi_survival)

    rf_eff = jnp.clip(0.56 + 0.34 * jnp.mean(rf_kernel), 0.35, 0.95)
    nbi_eff = jnp.clip(0.50 + 0.34 * jnp.mean(nbi_kernel), 0.28, 0.93)
    dr = jnp.gradient(radius, axis=1)
    mean_path = jnp.mean(jnp.sum(0.98 + 0.08 * jnp.abs(dr), axis=1) / n_steps)
    return {
        "rf_absorption_eff": rf_eff,
        "nbi_absorption_eff": nbi_eff,
        "absorbed_heating_mw": rf_power_mw * rf_eff + nbi_power_mw * nbi_eff,
        "mean_path_length_norm": mean_path,
        "rf_reflection_rate": jnp.mean(rf_mask.astype(t.dtype)),
        "nbi_reflection_rate": jnp.mean(nbi_mask.astype(t.dtype)),
    }


def aries_at_q_proxy(*, major_radius_m, b_t, ip_ma,
                     absorbed_heating_mw) -> jnp.ndarray:
    """ARIES-AT-like fusion-gain scaling (reference ``:124-140``)."""
    return (5.8 * (major_radius_m / 6.2) ** 0.62
            * (b_t / 5.5) ** 1.20
            * (ip_ma / 12.0) ** 0.92
            * (jnp.maximum(absorbed_heating_mw, 1.0) / 55.0) ** 0.25)


def mcnp_lite_tbr(*, raw_tbr, li6_enrichment, be_multiplier_fraction,
                  reflector_albedo) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Project a raw breeding ratio into the engineering-equivalent TBR
    space used by the campaign gates (reference ``:141-158``)."""
    factor = (1.11
              + 0.22 * require_fraction("be_multiplier_fraction",
                                        be_multiplier_fraction)
              + 0.08 * require_fraction("li6_enrichment", li6_enrichment)
              + 0.05 * require_fraction("reflector_albedo", reflector_albedo))
    return jnp.asarray(raw_tbr) * factor * TBR_EQUIVALENCE_SCALE, \
        jnp.asarray(factor)


@partial(jax.jit, static_argnames=("histories", "max_interactions"))
def mcnp_lite_transport_tbr(
    key: jax.Array,
    *,
    histories: int,
    thickness_cm,
    li6_enrichment,
    be_multiplier_fraction,
    reflector_albedo,
    max_interactions: int = 48,
) -> dict[str, jnp.ndarray]:
    """1D weight-based neutron-transport TBR estimate, fully vectorised
    (reference ``mcnp_lite_transport_tbr:160-229``; non-analog
    multiplication redesign documented in the module docstring)."""
    sigma_cap = 0.055 + 0.11 * jnp.clip(li6_enrichment, 0.0, 1.0)
    sigma_scat = 0.18
    sigma_par = 0.02
    sigma_mult = 0.02 + 0.08 * jnp.clip(be_multiplier_fraction, 0.0, 1.0)
    sigma_tot = sigma_cap + sigma_scat + sigma_par + sigma_mult
    p_cap = sigma_cap / sigma_tot
    p_scat = (sigma_cap + sigma_scat) / sigma_tot
    p_mult = (sigma_cap + sigma_scat + sigma_mult) / sigma_tot
    albedo = jnp.clip(reflector_albedo, 0.0, 1.0)
    thick = jnp.asarray(thickness_cm, jnp.float32) * 1.0
    # Branch-direction mixture for the combined multiplication particle:
    # weights 0.90 (60% forward) and 0.70 (72% forward).
    p_fwd_mult = (0.90 * 0.60 + 0.70 * 0.72) / 1.60

    n = histories
    state0 = (jnp.ones((n,)),                 # weight
              jnp.zeros((n,)),                # x [cm]
              jnp.ones((n,)),                 # direction
              jnp.ones((n,), bool),           # alive
              jnp.zeros(()), jnp.zeros(()), jnp.zeros(()),  # cap/leak/mult
              key)

    def round_(_, st):
        w, x, d, alive, cap, leak, mult, k = st
        k, k1, k2, k3 = jax.random.split(k, 4)
        alive = alive & (w > 1e-3)
        mfp = 1.0 / jnp.maximum(sigma_tot, 1e-9)
        s = -mfp * jnp.log(jnp.maximum(1e-12,
                                       1.0 - jax.random.uniform(k1, (n,))))
        x_new = x + d * s
        # Reflect at the plasma-facing surface.
        d = jnp.where(x_new < 0.0, 1.0, d)
        x_new = jnp.maximum(x_new, 0.0)

        escaped = alive & (x_new > thick)
        u_alb = jax.random.uniform(k2, (n,))
        back_reflected = escaped & (u_alb < albedo)
        leaked = escaped & ~back_reflected
        leak = leak + jnp.sum(jnp.where(leaked, w, 0.0))

        inside = alive & ~escaped
        u = jax.random.uniform(k3, (n, 2))
        ev = u[:, 0]
        captured = inside & (ev < p_cap)
        scattered = inside & (ev >= p_cap) & (ev < p_scat)
        multiplied = inside & (ev >= p_scat) & (ev < p_mult)
        cap = cap + jnp.sum(jnp.where(captured, w, 0.0))
        mult = mult + jnp.sum(jnp.where(multiplied, w, 0.0))

        new_dir = jnp.where(u[:, 1] < jnp.where(multiplied, p_fwd_mult, 0.68),
                            1.0, -1.0)
        w = jnp.where(back_reflected, 0.92 * w,
                      jnp.where(scattered, 0.98 * w,
                                jnp.where(multiplied, 1.60 * w, w)))
        x = jnp.where(back_reflected, thick, x_new)
        d = jnp.where(back_reflected, -1.0,
                      jnp.where(scattered | multiplied, new_dir, d))
        # Survivors: albedo-reflected, scattered, or multiplied particles.
        # Leak, capture, and parasitic absorption all terminate the history
        # (the reference pushes nothing onto the stack for those, :203-225).
        alive = back_reflected | scattered | multiplied
        return (w, x, d, alive, cap, leak, mult, k)

    out = jax.lax.fori_loop(0, max_interactions, round_, state0)
    _, _, _, _, cap, leak, mult, _ = out
    inv = 1.0 / jnp.maximum(float(n), 1e-9)
    return {"tbr_mc": cap * inv, "leakage_rate": leak * inv,
            "multiplication_gain": 1.0 + mult * inv}


def quick_candidate(key: jax.Array, idx: int, *,
                    base_tbr: float = 1.1409,
                    aspect_ratio: float = 3.1,
                    greenwald_fraction: float = 0.85) -> dict[str, float]:
    """Sample and score one heating/neutronics reactor candidate
    (reference ``quick_candidate:231-309``).  The design-chain Q comes
    from this repo's 0D chain (``evaluate_design``) instead of the
    reference's ``GlobalDesignExplorer``."""
    ks = jax.random.split(key, 12)
    u = [float(jax.random.uniform(k, (), jnp.float32, lo, hi))
         for k, (lo, hi) in zip(ks[:10], [
             (4.0, 7.4), (5.0, 8.2), (8.0, 18.5), (1.5, 2.0), (0.20, 0.42),
             (18.0, 42.0), (14.0, 38.0), (0.78, 1.0), (0.35, 0.95),
             (0.20, 0.85)])]
    (major_radius_m, b_t, ip_ma, elongation, triangularity, rf_power_mw,
     nbi_power_mw, li6_enrichment, be_multiplier_fraction,
     reflector_albedo) = u
    blanket_thickness_cm = float(jax.random.uniform(
        ks[10], (), jnp.float32, 220.0, 340.0))

    heating = genray_heating_proxy(
        ks[11], major_radius_m=major_radius_m, elongation=elongation,
        b_t=b_t, rf_power_mw=rf_power_mw, nbi_power_mw=nbi_power_mw)
    a_m = major_radius_m / aspect_ratio
    n_gw19 = 10.0 * ip_ma / (np.pi * a_m**2)
    design = evaluate_design(
        major_radius_m, a_m, b_t, ip_ma,
        greenwald_fraction * n_gw19, rf_power_mw + nbi_power_mw,
        kappa=elongation)

    heating_weight = (0.56 * float(heating["rf_absorption_eff"])
                      + 0.44 * float(heating["nbi_absorption_eff"]))
    q_aries = float(aries_at_q_proxy(
        major_radius_m=major_radius_m, b_t=b_t, ip_ma=ip_ma,
        absorbed_heating_mw=heating["absorbed_heating_mw"]))
    surrogate_q = 4.8 + 0.085 * np.sqrt(max(float(design.q_fusion), 0.0)) \
        * heating_weight * np.sqrt(b_t / 5.5)
    q_proxy = 0.90 * q_aries + 0.10 * surrogate_q + 2.8

    raw_tbr_est = (base_tbr * (blanket_thickness_cm / 260.0) ** 0.11
                   * (1.0 + 0.07 * (elongation - 1.7)))
    tbr_est, tbr_factor = mcnp_lite_tbr(
        raw_tbr=raw_tbr_est, li6_enrichment=li6_enrichment,
        be_multiplier_fraction=be_multiplier_fraction,
        reflector_albedo=reflector_albedo)
    objective = (q_proxy + 18.0 * (float(tbr_est) - 1.05)
                 - 0.45 * abs(q_proxy - q_aries))
    return {
        "candidate_id": float(idx),
        "major_radius_m": major_radius_m, "b_t": b_t, "ip_ma": ip_ma,
        "elongation": elongation, "triangularity": triangularity,
        "rf_power_mw": rf_power_mw, "nbi_power_mw": nbi_power_mw,
        "li6_enrichment": li6_enrichment,
        "be_multiplier_fraction": be_multiplier_fraction,
        "reflector_albedo": reflector_albedo,
        "blanket_thickness_cm": blanket_thickness_cm,
        "rf_absorption_eff": float(heating["rf_absorption_eff"]),
        "nbi_absorption_eff": float(heating["nbi_absorption_eff"]),
        "rf_reflection_rate": float(heating["rf_reflection_rate"]),
        "nbi_reflection_rate": float(heating["nbi_reflection_rate"]),
        "mean_path_length_norm": float(heating["mean_path_length_norm"]),
        "absorbed_heating_mw": float(heating["absorbed_heating_mw"]),
        "q_proxy": float(q_proxy), "q_aries_at_proxy": q_aries,
        "tbr_est": float(tbr_est), "tbr_factor": float(tbr_factor),
        "objective": float(objective),
    }


def refine_candidate_tbr(candidate: dict[str, float],
                         key: jax.Array) -> dict[str, float]:
    """Refine a sampled candidate with the volumetric blanket solve and
    the stochastic transport estimate (reference
    ``refine_candidate_tbr:311-355``)."""
    cfg = BlanketConfig(thickness_cm=float(candidate["blanket_thickness_cm"]),
                        li6_enrichment=float(candidate["li6_enrichment"]))
    vol = volumetric_tbr(
        cfg,
        major_radius_m=float(candidate["major_radius_m"]),
        minor_radius_m=max(1.4, float(candidate["major_radius_m"]) * 0.31),
        elongation=float(candidate["elongation"]),
        radial_cells=8, poloidal_cells=16, toroidal_cells=12,
        incident_flux=1e14)
    raw_tbr = float(vol.tbr)
    tbr_est, tbr_factor = mcnp_lite_tbr(
        raw_tbr=raw_tbr,
        li6_enrichment=float(candidate["li6_enrichment"]),
        be_multiplier_fraction=float(candidate["be_multiplier_fraction"]),
        reflector_albedo=float(candidate["reflector_albedo"]))
    mc = mcnp_lite_transport_tbr(
        key, histories=700,
        thickness_cm=float(candidate["blanket_thickness_cm"]),
        li6_enrichment=float(candidate["li6_enrichment"]),
        be_multiplier_fraction=float(candidate["be_multiplier_fraction"]),
        reflector_albedo=float(candidate["reflector_albedo"]))
    tbr_final = 0.60 * float(tbr_est) + 0.40 * float(mc["tbr_mc"])
    out = dict(candidate)
    out["raw_tbr"] = raw_tbr
    out["tbr_final"] = tbr_final
    out["tbr_factor"] = float(tbr_factor)
    out["tbr_mc"] = float(mc["tbr_mc"])
    out["neutron_leakage_rate"] = float(mc["leakage_rate"])
    out["neutron_multiplication_gain"] = float(mc["multiplication_gain"])
    out["objective"] = (float(candidate["q_proxy"])
                        + 18.0 * (tbr_final - 1.05)
                        - 0.45 * abs(float(candidate["q_proxy"])
                                     - float(candidate["q_aries_at_proxy"])))
    return out
