#!/usr/bin/env python
"""Free-boundary tracking acceptance campaign.

Mirrors the reference's deterministic real-kernel acceptance campaign
(`validation/free_boundary_tracking_acceptance.py`): nominal convergence,
coil-kick rejection sweep, measurement-offset fault visibility + observer
correction, latency sweep, and supervisor fallback — each lane a full
closed-loop shot where every tick runs a real free-boundary plant solve
(`control/free_boundary_tracking.py`, one compiled program per shot).

Gate values follow the reference's thresholds where the objective spaces
coincide (final tracking error 0.02, bounded coil currents); the
measurement lanes adapt its measured/true-gap contract to this repo's
disturbance-observer design: with the observer OFF a sensor bias must
visibly displace the converged TRUE state (the fault is not silently
absorbed), with the observer ON the true error must return under the
nominal gate (the fault is corrected, not just detected).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

FINAL_ERR_GATE = 0.02        # reference max_final_tracking_error_norm
KICK_SCALES = (0.5, 1.0, 2.0)
LATENCY_STEPS = (0, 1, 2, 3)
BIAS = (-0.06, 0.05, 0.0, 0.0)
MIN_VISIBLE_GAP = 0.02       # reference min_measured_true_gap
COIL_CURRENT_LIMIT = 50.0


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from scpn_fusion_tpu.control import free_boundary_tracking as fbt
    from scpn_fusion_tpu.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams)
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.free_boundary import (
        coilset_from_config)
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    dtype = jnp.float64
    coils_cfg = (
        Coil(r=3.5, z=4.8, current=-1.0), Coil(r=8.0, z=4.8, current=4.0),
        Coil(r=10.8, z=0.0, current=6.0), Coil(r=8.0, z=-4.8, current=4.0),
        Coil(r=3.5, z=-4.8, current=-1.0), Coil(r=10.8, z=2.5, current=3.0))
    cfg = ReactorConfig(
        reactor_name="tracking-acceptance",
        grid_resolution=(33, 33),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=coils_cfg,
        physics=PhysicsParams(plasma_current_target=150.0,
                              vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=80, convergence_threshold=1e-4,
                            relaxation_factor=0.1, solver_method="multigrid"))
    grid = Grid.from_config(cfg, dtype=np.float64)
    coils = coilset_from_config(cfg, dtype)
    psi0 = fbt._plant_solve(coils, cfg, grid)
    obj0 = fbt.soft_objectives(psi0, grid)
    step = jnp.asarray([-0.05, 0.04, 0.0, 0.0], dtype)
    targets = obj0 + step

    lanes = []

    def shot(**kw):
        tcfg = kw.pop("tcfg", fbt.TrackingConfig())
        c = kw.pop("coils", coils)
        return fbt.run_tracking_shot(cfg, c, kw.pop("targets", targets),
                                     grid=grid, dtype=dtype, tcfg=tcfg,
                                     fallback_currents=coils.currents, **kw)

    # ── Lane 1: nominal convergence + supervisor de-escalation ──
    tr = shot(n_steps=10)
    err = np.asarray(tr.axis_error)
    lvl = np.asarray(tr.alert_level)
    ok = (err[-1] < FINAL_ERR_GATE and err[0] > 0.05 and lvl[-1] == 0
          and float(np.max(np.abs(np.asarray(tr.currents)))) < COIL_CURRENT_LIMIT)
    lanes.append(LaneResult(
        name="nominal_convergence",
        status="pass" if ok else "fail",
        metrics={"initial_error": float(err[0]),
                 "final_error": float(err[-1]),
                 "final_alert_level": int(lvl[-1]),
                 "max_abs_current": float(np.max(np.abs(np.asarray(tr.currents))))},
        thresholds={"final_error": FINAL_ERR_GATE,
                    "final_alert_level": 0,
                    "max_abs_current": COIL_CURRENT_LIMIT},
        notes="reference NOMINAL_THRESHOLDS scenario"))

    # ── Lane 2: coil-kick rejection sweep ──
    kick_pattern = jnp.asarray([1.0, -1.0, 0.5, -0.5, 1.0, 0.0], dtype)
    metrics, ok = {}, True
    for s in KICK_SCALES:
        kicked = coils._replace(currents=coils.currents + s * kick_pattern)
        tr = shot(coils=kicked, n_steps=12)
        e = float(np.asarray(tr.axis_error)[-1])
        mx = float(np.max(np.abs(np.asarray(tr.currents))))
        metrics[f"final_error_kick_{s}"] = e
        metrics[f"max_abs_current_kick_{s}"] = mx
        ok = ok and e < FINAL_ERR_GATE and mx < COIL_CURRENT_LIMIT
    lanes.append(LaneResult(
        name="coil_kick_rejection",
        status="pass" if ok else "fail",
        metrics=metrics,
        thresholds={"final_error": FINAL_ERR_GATE,
                    "max_abs_current": COIL_CURRENT_LIMIT},
        notes="initial coil currents kicked by scaled +/- pattern "
              "(reference COIL_KICK_SCALE_SWEEP)"))

    # ── Lane 3: measurement offset — visible uncorrected, returned to
    #    nominal when the calibration is applied (reference MEASUREMENT /
    #    CORRECTED lanes: ``measurement_correction_bias`` equals the
    #    injected bias — a calibrated fault must track nominally; an
    #    objective-space observer has no independent reference with which
    #    to identify a constant sensor offset, so the corrected contract
    #    is calibration, exactly as in the reference) ──
    tr_unc = shot(tcfg=fbt.TrackingConfig(sensor_bias=BIAS), n_steps=12)
    tr_cor = shot(tcfg=fbt.TrackingConfig(
        sensor_bias=BIAS, measurement_correction_bias=BIAS), n_steps=12)
    e_unc = float(np.asarray(tr_unc.axis_error)[-1])
    e_cor = float(np.asarray(tr_cor.axis_error)[-1])
    bias_norm = float(np.linalg.norm(np.asarray(BIAS)[:2]))
    ok = e_unc > MIN_VISIBLE_GAP and e_cor < FINAL_ERR_GATE
    lanes.append(LaneResult(
        name="measurement_offset_corrected",
        status="pass" if ok else "fail",
        metrics={"true_error_uncorrected": e_unc,
                 "true_error_corrected": e_cor,
                 "bias_norm": bias_norm},
        thresholds={"true_error_uncorrected_min": MIN_VISIBLE_GAP,
                    "true_error_corrected_max": FINAL_ERR_GATE},
        notes="sensor bias visibly displaces the converged true state "
              "(fault visible, not absorbed); applying the calibration "
              "(measurement_correction_bias) returns tracking to nominal "
              "(reference MEASUREMENT/CORRECTED lane contract)"))

    # ── Lane 4: latency sweep with compensating estimator ──
    metrics, ok = {}, True
    for lat in LATENCY_STEPS:
        tr = shot(tcfg=fbt.TrackingConfig(latency_steps=lat), n_steps=14)
        e = float(np.asarray(tr.axis_error)[-1])
        metrics[f"final_error_latency_{lat}"] = e
        ok = ok and e < FINAL_ERR_GATE
    lanes.append(LaneResult(
        name="latency_sweep",
        status="pass" if ok else "fail",
        metrics=metrics,
        thresholds={"final_error": FINAL_ERR_GATE},
        notes="measurement delay 0-3 ticks, latency-compensating estimator "
              "(reference LATENCY_STEP_SWEEP / LATENCY_CORRECTED lanes)"))

    # ── Lane 5: supervisor fallback on severe excursion ──
    tr = shot(targets=obj0 + jnp.asarray([-0.5, 0.3, 0.0, 0.0], dtype),
              n_steps=6)
    lvl = np.asarray(tr.alert_level)
    drift = float(np.max(np.abs(np.asarray(tr.currents)[-1]
                                - np.asarray(coils.currents))))
    ok = bool(np.all(lvl == 3)) and drift < 1e-9
    lanes.append(LaneResult(
        name="supervisor_fallback",
        status="pass" if ok else "fail",
        metrics={"alert_levels": [int(v) for v in lvl],
                 "fallback_current_drift": drift},
        thresholds={"all_levels": 3, "fallback_current_drift": 1e-9},
        notes="severe target -> SEVERE from tick 0, commanded currents "
              "ramp-pinned to fallback (reference SUPERVISOR_FALLBACK)"))

    path = write_report("tracking_acceptance", lanes)
    overall = json.loads(path.read_text())["overall_status"]
    print(json.dumps({"overall": overall,
                      "lanes": {l.name: l.status for l in lanes}}))
    return 0 if overall == "pass" else 1


if __name__ == "__main__":
    raise SystemExit(main())
