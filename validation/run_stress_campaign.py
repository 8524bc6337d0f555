#!/usr/bin/env python
"""1000-shot stress-test campaign (reference Step 2.1 parity).

Lane (fail-closed, blocked != pass):
- pid_1000_shot_stress — 1000 randomized flight-sim episodes (sensor
  noise + ELM kicks + ramp transients) as ONE vmapped compiled program.
  Gate: disruption rate 0% (the reference's own headline,
  BASELINE.md "Disruption rate, 1,000-shot sim campaign").  Wall-clock
  for the whole campaign is recorded — the reference runs episodes
  sequentially in Python.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import jax

    from scpn_fusion_tpu.control.flight_sim import FlightSimParams
    from scpn_fusion_tpu.control.stress import StressConfig, run_stress_campaign
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    params = FlightSimParams()
    cfg = StressConfig()
    import statistics

    import numpy as np

    # Timing forces a host fetch around each call.
    res = run_stress_campaign(params, cfg, n_shots=1000, seed=1)
    np.asarray(res.per_shot_disrupted)
    walls = []
    for seed in (2, 3, 4):
        t0 = time.perf_counter()
        res = run_stress_campaign(params, cfg, n_shots=1000, seed=seed)
        np.asarray(res.per_shot_disrupted)
        walls.append(time.perf_counter() - t0)
    wall_s = statistics.median(walls)

    rate = float(res.disruption_rate)
    lanes = [LaneResult(
        name="pid_1000_shot_stress",
        status="pass" if rate <= 0.0 else "fail",
        metrics={
            "disruption_rate": rate,
            "r_err_p50_m": float(res.r_err_p50),
            "r_err_p95_m": float(res.r_err_p95),
            "r_err_p99_m": float(res.r_err_p99),
            "z_err_p95_m": float(res.z_err_p95),
            "campaign_wall_s": round(wall_s, 5),
            "n_shots": 1000,
            "backend": jax.default_backend(),
        },
        thresholds={"disruption_rate": 0.0},
        notes="sensor noise 5 mm + 10 Hz ELM kicks + ramp transients; "
              "all 1000 stochastic episodes run as one vmapped compiled "
              "program (the reference iterates episodes in Python)")]

    path = write_report("stress_campaign", lanes)
    print(f"wrote {path}")
    return 0 if all(lane.status == "pass" for lane in lanes) else 1


if __name__ == "__main__":
    raise SystemExit(main())
