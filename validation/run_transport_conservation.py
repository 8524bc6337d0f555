#!/usr/bin/env python
"""Multi-ion transport conservation + power-balance contract campaign.

Mirrors the reference's transport contract lanes
(`validation/benchmark_multi_ion_transport_conservation.py` — quasineutral
residual <= 1e-10, physically-sane He-ash trajectory — and
`validation/benchmark_transport_power_balance.py` — auxiliary-heating
power-balance reconstruction) for the compiled 1.5D stepper
(`models/transport/solver.py`).

Lanes (fail-closed):
1. aux_power_balance — volume-integrated heating deposition reconstructs
   the commanded P_aux exactly (the deposition profile is normalised
   against the same discrete volume element, so the identity must hold to
   float rounding) for multi-ion and single-ion modes and both electron
   fractions.
2. quasineutrality — ne == n_D + n_T + 2 n_He + Z_W(Te) n_imp after one
   species step, at machine precision (reference gate 1e-10).
3. he_ash_trajectory — 200-step ITER-like burn: He-ash peak above floor,
   core fuel monotonically consumed, temperatures stay in a physically
   sane band (the reference's recalibrated "honest trajectory" framing).
4. steady_state_energy_balance — after relaxation, |dW/dt| is a small
   fraction of P_aux (the stepper reaches a genuine flux balance rather
   than ratcheting energy).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from scpn_fusion_tpu.models.transport.solver import (
        TransportParams,
        _aux_heating,
        _evolve_species,
        _volume_element,
        initial_state,
        run_transport,
    )
    from scpn_fusion_tpu.models.transport.closures import E_KEV_J
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    lanes = []

    # ── Lane 1: aux heating power-balance reconstruction ──
    metrics, worst = {}, 0.0
    for multi_ion, e_frac in ((True, 0.5), (True, 0.0), (False, 0.0)):
        params = TransportParams(multi_ion=multi_ion,
                                 aux_heating_electron_fraction=e_frac)
        s = initial_state(params, dtype=jnp.float64)
        rho = params.rho(jnp.float64)
        p_aux = 50.0
        s_i, s_e = _aux_heating(params, jnp.asarray(p_aux), s.ne, rho)
        d_v = _volume_element(params, rho)
        ne_si = jnp.clip(s.ne, 0.1, 1e3) * 1e19
        p_rec_w = float(jnp.sum(
            1.5 * (s_i + s_e) * ne_si * E_KEV_J * d_v))
        rel = abs(p_rec_w - p_aux * 1e6) / (p_aux * 1e6)
        tag = f"{'multi' if multi_ion else 'single'}_efrac{e_frac}"
        metrics[f"rel_err_{tag}"] = rel
        worst = max(worst, rel)
    lanes.append(LaneResult(
        name="aux_power_balance",
        status="pass" if worst <= 1e-10 else "fail",
        metrics={**metrics, "p_aux_mw": 50.0},
        thresholds={"rel_err_max": 1e-10},
        notes="volume-integrated (3/2) n_e T-rate deposition vs commanded "
              "P_aux; mirrors benchmark_transport_power_balance.py"))

    # ── Lane 2: quasineutrality at machine precision ──
    params = TransportParams(multi_ion=True)
    s = initial_state(params, dtype=jnp.float64)
    rho = params.rho(jnp.float64)
    s2, _ = _evolve_species(params, s, jnp.asarray(0.01),
                            jnp.asarray(40.0), rho, params.drho)
    te_safe = jnp.clip(s.te, 0.1, 1e3)   # z_w convention: Te at species step
    z_w = jnp.clip(15.0 + 12.0 * jnp.log10(te_safe), 10.0, 50.0)
    qn = s2.ne - jnp.maximum(
        s2.n_d + s2.n_t + 2.0 * s2.n_he + z_w * jnp.maximum(s2.n_imp, 0.0),
        0.1)
    qn_resid = float(jnp.max(jnp.abs(qn)) / jnp.max(s2.ne))
    lanes.append(LaneResult(
        name="quasineutrality",
        status="pass" if qn_resid <= 1e-12 else "fail",
        metrics={"max_rel_residual": qn_resid},
        thresholds={"max_rel_residual": 1e-12},
        notes="ne == n_D + n_T + 2 n_He + Z_W(Te) n_imp after one species "
              "step (reference contract gate 1e-10; f64)"))

    # ── Lane 3: physically sane He-ash burn trajectory ──
    params = TransportParams(multi_ion=True)
    s = initial_state(params, dtype=jnp.float64)
    s = s._replace(ti=s.ti * 0.0 + 8.0 * (1 - params.rho(jnp.float64) ** 2)
                   + 0.1,
                   te=s.te * 0.0 + 8.0 * (1 - params.rho(jnp.float64) ** 2)
                   + 0.1)
    final, traces = run_transport(s, jnp.asarray(0.01), jnp.asarray(40.0),
                                  params, 200)
    he_trace = np.asarray(traces["n_he0"])
    ti_trace = np.asarray(traces["ti0"])
    he_peak = float(he_trace.max())
    fuel_drop = float(np.asarray(s.n_d[1] - final.n_d[1]))
    ti_band_ok = bool((ti_trace > 0.3).all() and (ti_trace < 60.0).all())
    finite_ok = bool(np.isfinite(np.asarray(final.ti)).all()
                     and np.isfinite(np.asarray(final.n_he)).all())
    he_ok = he_peak >= 1e-4 and fuel_drop > 0.0
    lanes.append(LaneResult(
        name="he_ash_trajectory",
        status="pass" if (he_ok and ti_band_ok and finite_ok) else "fail",
        metrics={"he_ash_peak_1e19": he_peak,
                 "core_fuel_drop_1e19": fuel_drop,
                 "ti_core_final_kev": float(ti_trace[-1]),
                 "all_finite": finite_ok},
        thresholds={"he_ash_peak_min": 1e-4, "ti_band_kev": [0.3, 60.0]},
        notes="200-step ITER-like burn at 40 MW: ash accumulates, core "
              "fuel is consumed, trajectory stays in the ~keV band "
              "(reference's recalibrated sane-trajectory contract)"))

    # ── Lane 4: steady-state energy balance ──
    params = TransportParams(multi_ion=False)
    s = initial_state(params, dtype=jnp.float64)
    p_aux = 30.0
    mid, _ = run_transport(s, jnp.asarray(0.005), jnp.asarray(p_aux),
                           params, 3000)
    fin, _ = run_transport(mid, jnp.asarray(0.005), jnp.asarray(p_aux),
                           params, 200)
    rho = params.rho(jnp.float64)
    d_v = _volume_element(params, rho)

    def stored_w(st):
        return float(jnp.sum(1.5 * (st.ne * 1e19) * (st.ti + st.te)
                             * E_KEV_J * d_v))

    w_mid, w_fin = stored_w(mid), stored_w(fin)
    dwdt_w = abs(w_fin - w_mid) / (200 * 0.005)
    frac = dwdt_w / (p_aux * 1e6)
    lanes.append(LaneResult(
        name="steady_state_energy_balance",
        status="pass" if frac <= 0.02 else "fail",
        metrics={"stored_energy_mj": w_fin / 1e6,
                 "dwdt_fraction_of_p_aux": frac},
        thresholds={"dwdt_fraction_of_p_aux": 0.02},
        notes="after 15 s of relaxation the residual dW/dt is <=2% of "
              "P_aux: the CN stepper settles to flux balance instead of "
              "ratcheting energy (reference late-energy-error gate intent)"))

    path = write_report("transport_conservation", lanes)
    print(f"report: {path}")
    return 0 if all(l.status == "pass" for l in lanes) else 1


if __name__ == "__main__":
    raise SystemExit(main())
