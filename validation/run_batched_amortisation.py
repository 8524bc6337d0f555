#!/usr/bin/env python
"""Batched-forward amortisation + warm/cold compile evidence (VERDICT r2 #3).

Mirrors the reference's batched-forward lane
(``jax_predictive_forward_compiled.py:32`` vmap batch variant;
``artifacts/rung2_mg_preconditioner/batched_forward_amortisation_h100.json``:
B=16/64/256 per-solve 13.6/13.0/14.6 ms on H100, warm-start 164.8 -> 13.0 ms).

Lanes (fail-closed):
1. batched_element_parity — element b of the vmapped batch solve vs
   the single solve at the same inputs.  On-chip f32 the two programs
   tile differently, shifting the convergence-gated stopping iteration
   by +-1 (recorded), so the gate is the fixed-point-accuracy bound;
   the BITWISE trajectory invariant (guarded while-body) is pinned at
   1e-12 on the CPU f64 straggler test.  (Reference gate <= 5.1e-15 is
   on a FIXED-iteration compiled forward — different semantics.)
2. batched_amortisation — per-solve wall-clock at B=1/16/64/256 on the
   available device (recorded) at 129^2:
   the B>=16 per-solve cost must be < 0.5x the B=1 per-solve cost
   (amortisation actually amortises).
3. warm_cold_compile — cold trace+compile wall vs warm cached call for
   the batch program (the reference's 164.8 -> 13.0 ms row).

Timing forces a device->host fetch around each call.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def _make_cfg(n):
    from scpn_fusion_tpu.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
    )
    coils = (
        Coil(r=3.5, z=4.8, current=-1.0), Coil(r=8.0, z=4.8, current=4.0),
        Coil(r=10.8, z=0.0, current=6.0), Coil(r=8.0, z=-4.8, current=4.0),
        Coil(r=3.5, z=-4.8, current=-1.0), Coil(r=10.8, z=2.5, current=3.0),
    )
    return ReactorConfig(
        reactor_name=f"amortise-{n}",
        grid_resolution=(n, n),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=coils,
        physics=PhysicsParams(plasma_current_target=15.0,
                              vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=200, convergence_threshold=1e-4,
                            relaxation_factor=1.0,
                            solver_method="anderson_mg", anderson_depth=4,
                            inner_sweeps=1),
    )


def main() -> int:
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.core import backend as backend_mod
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.parallel.ensemble import solve_equilibrium_batch
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    lanes = []
    backend = jax.default_backend()
    n = 129
    cfg = _make_cfg(n)
    dtype = jnp.float32
    grid = Grid.from_config(cfg, dtype=np.float32)
    base = jnp.asarray([c.current for c in cfg.coils], dtype)
    rng = np.random.default_rng(5)

    def batch_inputs(b):
        pert = 1.0 + 0.05 * jnp.asarray(
            rng.standard_normal((b, base.shape[0])), dtype)
        return base[None, :] * pert, jnp.full((b,), 15.0, dtype)

    # ── Lane 1: element parity.  On-chip f32, the B=16 and B=1 programs
    # tile/layout differently, so per-op float noise shifts the stopping
    # iteration of the convergence-gated solve by +-1 — the solutions
    # then differ at the fixed-point-accuracy scale O(tol/contraction),
    # NOT bitwise.  The bitwise invariant (guarded while-body freezing
    # converged elements: batched trajectory == standalone trajectory)
    # is pinned at 1e-12 on the CPU f64 lane
    # (tests/test_parallel_2d_ensemble.py::test_batch_freeze_guard_with_
    # straggler); here the gate is the convergence-quality bound with
    # iteration counts recorded. ──
    cur_b, tgt_b = batch_inputs(16)
    psi_b, conv_b, iters_b = solve_equilibrium_batch(cfg, grid, cur_b, tgt_b)
    psi_one, conv_one, iters_one = solve_equilibrium_batch(
        cfg, grid, cur_b[3:4], tgt_b[3:4])
    psi_b = np.asarray(psi_b)
    span = float(psi_b[3].max() - psi_b[3].min())
    dev = float(np.max(np.abs(psi_b[3] - np.asarray(psi_one)[0]))) / span
    gate1 = 5e-3
    lanes.append(LaneResult(
        name="batched_element_parity",
        status="pass" if (dev < gate1 and bool(np.all(np.asarray(conv_b)))
                          and bool(np.asarray(conv_one)[0]))
        else "fail",
        metrics={"span_rel_dev_element_vs_single": dev,
                 "iters_in_batch": int(np.asarray(iters_b)[3]),
                 "iters_standalone": int(np.asarray(iters_one)[0]),
                 "batch_all_converged": bool(np.all(np.asarray(conv_b))),
                 "backend": backend, "dtype": str(np.dtype(np.float32))},
        thresholds={"span_rel_dev_element_vs_single": gate1},
        notes="both converged to the same tol; dev bounded by the "
              "fixed-point-accuracy scale (f32 on-chip layout noise "
              "shifts the stopping iteration).  Bitwise trajectory "
              "identity is gated at 1e-12 on the CPU f64 straggler "
              "test (guarded while-body)"))

    # ── Lanes 2+3: amortisation sweep + warm/cold ──
    per_solve = {}
    cold_ms = None
    for b in (1, 16, 64, 256):
        cur, tgt = batch_inputs(b)
        t0 = time.perf_counter()
        out = solve_equilibrium_batch(cfg, grid, cur, tgt)
        np.asarray(out[0])
        cold = 1e3 * (time.perf_counter() - t0)
        if b == 256:
            cold_ms = cold
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = solve_equilibrium_batch(cfg, grid, cur, tgt)
            np.asarray(out[0])
            times.append(time.perf_counter() - t0)
        per_solve[b] = 1e3 * min(times) / b

    amort_ok = (per_solve[16] < 0.5 * per_solve[1]
                and per_solve[64] < 0.5 * per_solve[1]
                and per_solve[256] < 0.5 * per_solve[1])
    lanes.append(LaneResult(
        name="batched_amortisation",
        status="pass" if amort_ok else "fail",
        metrics={f"per_solve_ms_B{b}": round(v, 3)
                 for b, v in per_solve.items()} | {
            "grid": f"{n}x{n}", "backend": backend},
        thresholds={"amortisation_factor_max": 0.5},
        notes="per-solve wall at B=1/16/64/256, 129^2 multigrid-Picard "
              "(reference lane: 13.6/13.0/14.6 ms on H100 at B=16/64/256); "
              "B>=16 must amortise to <0.5x the B=1 cost"))

    warm_ms = per_solve[256] * 256
    lanes.append(LaneResult(
        name="warm_cold_compile",
        status="pass" if (cold_ms is not None and warm_ms < cold_ms)
        else "fail",
        metrics={"cold_trace_compile_ms_B256": round(cold_ms, 1),
                 "warm_cached_ms_B256": round(warm_ms, 1),
                 "speedup": round(cold_ms / max(warm_ms, 1e-9), 2)},
        thresholds={"warm_faster_than_cold": 1.0},
        notes="first-call trace+compile wall vs warm cached call for the "
              "B=256 batch program (reference row: 164.8 -> 13.0 ms)"))

    # ── Lane 4: batched MIXED precision — the reference's batched figures
    # are FP64 (H100); this lane meets them in the same precision class:
    # f64 master iterate + criterion, f32 MG defect correction, vmapped
    # (parallel/ensemble.solve_equilibrium_batch_mixed).  Element parity
    # vs the single mixed solve is f64-tight (no f32 stopping-iteration
    # noise). ──
    if backend_mod.device_info().platform == "gpu":
        from scpn_fusion_tpu.parallel.ensemble import (
            solve_equilibrium_batch_mixed,
        )
        with jax.enable_x64(True):
            grid64 = Grid.from_config(cfg, dtype=np.float64)
            per_solve_mx = {}
            psi_mb = None
            for b in (16, 64):
                cur, tgt = batch_inputs(b)
                cur64 = jnp.asarray(np.asarray(cur), jnp.float64)
                tgt64 = jnp.asarray(np.asarray(tgt), jnp.float64)
                out = solve_equilibrium_batch_mixed(cfg, grid64, cur64,
                                                    tgt64)
                np.asarray(out[0])
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    out = solve_equilibrium_batch_mixed(cfg, grid64, cur64,
                                                        tgt64)
                    np.asarray(out[0])
                    times.append(time.perf_counter() - t0)
                per_solve_mx[b] = 1e3 * min(times) / b
                if b == 16:
                    psi_mb = np.asarray(out[0])
                    conv_mb = bool(np.all(np.asarray(out[1])))
                    cur16, tgt16 = cur64, tgt64
            out1 = solve_equilibrium_batch_mixed(cfg, grid64, cur16[3:4],
                                                 tgt16[3:4])
            span = float(psi_mb[3].max() - psi_mb[3].min())
            dev_mx = float(np.max(np.abs(
                psi_mb[3] - np.asarray(out1[0])[0]))) / span
        ref_per_solve = 13.0
        ok_mx = (conv_mb and dev_mx < 1e-5
                 and per_solve_mx[64] <= ref_per_solve)
        lanes.append(LaneResult(
            name="batched_mixed_amortisation",
            status="pass" if ok_mx else "fail",
            metrics={f"per_solve_ms_B{b}": round(v, 3)
                     for b, v in per_solve_mx.items()} | {
                "span_rel_element_vs_single": dev_mx,
                "all_converged_B16": conv_mb,
                "reference_h100_fp64_per_solve_ms": ref_per_solve},
            thresholds={"per_solve_ms_B64": ref_per_solve,
                        "span_rel_element_vs_single": 1e-5},
            notes="f64-criterion batched solves (f32 only in the MG "
                  "defect correction) vs the reference's FP64 H100 "
                  "batched row 13.6/13.0/14.6 ms — same precision "
                  "class; element parity at the f32-correction scale "
                  "(~1e-6, the batched/unbatched layouts round the "
                  "injected V-cycle differently; the f64 master iterate "
                  "bounds it there — tests/test_parallel_2d_ensemble.py)"))
    else:
        lanes.append(LaneResult(
            name="batched_mixed_amortisation", status="blocked",
            notes="no GPU in this environment"))

    path = write_report("batched_amortisation", lanes)
    print(f"wrote {path}")
    return 0 if all(lane.status == "pass" for lane in lanes
                    if lane.status != "blocked") else 1


if __name__ == "__main__":
    raise SystemExit(main())
