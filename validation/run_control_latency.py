#!/usr/bin/env python
"""Control-latency validation campaign (HIL lane).

Reference parity: ``validation/scpn_end_to_end_latency.py`` +
``control/hil_benchmarks.py`` P50/P95/P99 contract and the metric taxonomy
``control.pid_kernel_step_us`` / ``control.closed_loop_step_us``
(``docs/PERFORMANCE_METRIC_TAXONOMY.md:44-50``).

Lanes (fail-closed, blocked != pass):
1. pid_kernel_step    — jitted PID step dispatch latency
2. scpn_tick          — neuro-symbolic controller tick dispatch latency
3. fused_closed_loop  — amortised per-tick cost of the fused 10k-tick
                        controller+plant scan; threshold 100 us/tick
                        (>10 kHz equivalent, the reference's headline rate)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _build_rz_controller(jnp):
    from scpn_fusion_tpu.scpn import StochasticPetriNet
    from scpn_fusion_tpu.scpn.controller import build_controller

    net = StochasticPetriNet()
    for p in ("eR+", "eR-", "eZ+", "eZ-", "cR+", "cR-", "cZ+", "cZ-"):
        net.add_place(p)
    for t, src, dst in (("tR+", "eR+", "cR+"), ("tR-", "eR-", "cR-"),
                        ("tZ+", "eZ+", "cZ+"), ("tZ-", "eZ-", "cZ-")):
        net.add_transition(t, threshold=0.02)
        net.add_arc(src, t)
        net.add_arc(t, dst)
    return build_controller(
        net.compile(),
        axis_targets=[6.2, 0.0], axis_scales=[0.5, 0.5],
        injections=[("eR+", 0, True, 1.0, 0.0), ("eR-", 0, False, 1.0, 0.0),
                    ("eZ+", 1, True, 1.0, 0.0), ("eZ-", 1, False, 1.0, 0.0)],
        actions=[("cR+", "cR-", 0.5, 5.0, 1e4),
                 ("cZ+", "cZ-", 0.5, 5.0, 1e4)],
        dtype=jnp.float32)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.control.hil import (
        measure_dispatch_latency,
        measure_fused_throughput,
    )
    from scpn_fusion_tpu.control.neuro_closed_loop import (
        ReducedPlantState,
        run_neuro_closed_loop,
    )
    from scpn_fusion_tpu.control.pid import PIDGains, pid_init, pid_step
    from scpn_fusion_tpu.scpn import ControllerConfig
    from scpn_fusion_tpu.scpn.controller import (
        controller_step,
        initial_controller_state,
    )
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    lanes = []

    # Lane 1: PID kernel dispatch
    gains = PIDGains(kp=1.0, ki=0.2, kd=0.05)
    rep = measure_dispatch_latency(
        lambda s, e: pid_step(gains, s, e), (pid_init(), jnp.asarray(0.1)),
        n_samples=100)
    metrics1 = rep.to_dict()
    metrics1["reference_rust_pid_p50_us"] = 0.52
    lanes.append(LaneResult(
        name="pid_kernel_step",
        status="pass" if rep.p50_us < 2000 else "fail",
        metrics=metrics1, thresholds={"p50_us_max": 2000.0},
        notes="measures host->device DISPATCH latency of one jitted call "
              "— NOT control capability. The "
              "reference's 0.52 us Rust PID (BASELINE.md) is an in-process "
              "kernel; the comparable deployment metric here is lane 3's "
              "fused per-tick time, where the controller runs inside the "
              "compiled loop with no per-tick host round-trip."))

    # Lane 2: SCPN controller tick dispatch
    try:
        ctrl = _build_rz_controller(jnp)
        cfg = ControllerConfig(firing_mode="fractional",
                               firing_margin=0.5, dt=1e-3)
        cstate = initial_controller_state(ctrl, cfg)
        obs = jnp.asarray([6.4, 0.1], jnp.float32)
        # Pipelined per-tick dispatch: the synchronous ping-pong measures
        # the host round trip, not the controller; the deployment path at
        # rate is the fused scan (lane 3).
        rep2 = measure_dispatch_latency(
            lambda s, o: controller_step(ctrl, cfg, s, o, jnp.asarray(0)),
            (cstate, obs), n_samples=100, pipelined=True)
        lanes.append(LaneResult(
            name="scpn_tick",
            status="pass" if rep2.p50_us < 5000 else "fail",
            metrics=rep2.to_dict(), thresholds={"p50_us_max": 5000.0},
            notes="pipelined per-call dispatch (the sync ping-pong is "
                  "round-trip-bound and not the control metric)"))
    except Exception as exc:  # noqa: BLE001 - blocked != pass
        lanes.append(LaneResult(name="scpn_tick", status="blocked",
                                metrics={}, thresholds={},
                                notes=f"{type(exc).__name__}: {exc}"))

    # Lane 3: fused closed loop (>10 kHz equivalent)
    n_ticks = 10_000
    ctrl = _build_rz_controller(jnp)
    cfg = ControllerConfig(firing_mode="fractional", firing_margin=0.5,
                           dt=1e-3)
    plant0 = ReducedPlantState(jnp.float32(6.5), jnp.float32(0.3))

    def fused():
        return run_neuro_closed_loop(ctrl, cfg, plant0,
                                     n_ticks=n_ticks, dt=1e-3)

    rep3 = measure_fused_throughput(fused, (), n_ticks=n_ticks,
                                    n_repeats=3)
    lanes.append(LaneResult(
        name="fused_closed_loop",
        status="pass" if rep3.mean_us < 100.0 else "fail",
        metrics={**rep3.to_dict(),
                 "rate_hz_equivalent": 1e6 / max(rep3.mean_us, 1e-9)},
        thresholds={"mean_us_per_tick_max": 100.0},
        notes=f"{n_ticks} controller+plant ticks fused in one scan "
              f"on backend={jax.default_backend()} — the deployment-rate "
              "metric comparable to the reference's in-process kernels "
              "(Rust PID 0.52 us, HIL loop 24.5 us P50, BASELINE.md)"))

    path = write_report("control_latency", lanes)
    print(f"wrote {path}")
    return 0 if all(l.status == "pass" for l in lanes) else 1


if __name__ == "__main__":
    raise SystemExit(main())
