#!/usr/bin/env python
"""Compiled free-boundary predictive forward: warm/cold device timing.

Counterpart of the reference's headline free-boundary artifact
(``artifacts/rung2_mg_preconditioner/warm_start_forward_h100.json`` +
``jax_predictive_forward_compiled.py``): compiled warm 129^2 forward
13.0 ms on a dedicated H100, cold start 164.8 ms, warm without the MG
preconditioner 26.3 ms (BASELINE.md "Equilibrium solvers").  Here the
WHOLE free-boundary solve (coil-flux boundary <-> inner GS solve outer
loop) is one ``lax.while_loop`` (``free_boundary.py:_run_free_boundary``),
so the forward is a single compiled program.  Lanes (fail-closed):

1. warm_forward_129_device — per-solve ON-DEVICE time by solve-count
   slope (T(5 chained solves) - T(1))/4 with per-element coil-current
   perturbations so XLA cannot collapse the chain; every element must
   converge.  Gate: device per-solve <= 26.3 ms (the reference's warm
   H100 figure WITHOUT its MG preconditioner; its full headline 13.0 ms
   is recorded alongside for comparison).
2. cold_vs_warm_compile — cold wall (trace + compile + run) vs warm
   cached wall for the same program; gate: warm at least 3x faster
   (reference row: 164.8 -> 13.0 ms, 12.7x on dedicated hardware; the
   ratio gate is deliberately conservative).

Writes checksummed JSON+MD evidence into validation/reports/.
"""

import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

REF_WARM_MS = 13.0      # H100, with MG preconditioner
REF_WARM_NOMG_MS = 26.3
REF_COLD_MS = 164.8


def main() -> int:
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.core.config import (
        Coil,
        Dimensions,
        PhysicsParams,
        ReactorConfig,
        SolverParams,
    )
    from scpn_fusion_tpu.core import backend as backend_mod
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.free_boundary import (
        coilset_from_config,
        solve_free_boundary,
    )
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    backend = jax.default_backend()
    coils = (
        Coil(r=3.5, z=4.8, current=-1.0), Coil(r=8.0, z=4.8, current=4.0),
        Coil(r=10.8, z=0.0, current=6.0), Coil(r=8.0, z=-4.8, current=4.0),
        Coil(r=3.5, z=-4.8, current=-1.0), Coil(r=10.8, z=2.5, current=3.0),
    )
    def measure(n, max_outer=16, tol=1e-4, dtype=None, mixed_n_refine=0):
        # f32 lanes: the outer criterion is absolute max|dpsi| between
        # successive inner solves; the f32 fixed point is a limit cycle of
        # ~25 ulps of psi_axis (~42 here, ulp 3.8e-6 => cycle ~1e-4), so
        # tol must clear it.  2.5e-4 is ~5e-6 span-relative — same
        # rationale as the 257^2 lane below.  The f64 lane keeps 1e-4 and
        # converges in 3 outer iterations (no cycle at f64 ulp scale).
        dtype = dtype or jnp.float32
        np_dtype = np.float64 if dtype == jnp.float64 else np.float32
        cfg = ReactorConfig(
            reactor_name=f"fb-forward-{n}",
            grid_resolution=(n, n),
            dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0,
                                  Z_max=4.0),
            coils=coils,
            physics=PhysicsParams(plasma_current_target=15.0,
                                  vacuum_permeability=1.0),
            solver=SolverParams(max_iterations=400,
                                convergence_threshold=1e-4,
                                relaxation_factor=1.0,
                                solver_method="anderson_mg",
                                anderson_depth=4),
        )
        grid = Grid.from_config(cfg, dtype=np_dtype)
        coils0 = coilset_from_config(cfg, dtype)

        def forward(currents):
            res = solve_free_boundary(
                cfg, coils0._replace(currents=currents), grid=grid,
                max_outer_iter=max_outer, tol=tol, mu0_green=1.0,
                dtype=dtype, anderson_gram_f32=dtype == jnp.float64,
                mixed_n_refine=mixed_n_refine)
            return (jnp.sum(res.psi), res.outer_iterations, res.converged)

        def psi_one():
            res = solve_free_boundary(
                cfg, coils0, grid=grid, max_outer_iter=max_outer, tol=tol,
                mu0_green=1.0, dtype=dtype,
                anderson_gram_f32=dtype == jnp.float64,
                mixed_n_refine=mixed_n_refine)
            return np.asarray(res.psi)

        @partial(jax.jit, static_argnames=("k",))
        def chain(base_currents, k):
            def one(carry, scale):
                out = forward(base_currents * scale)
                return carry, out

            scales = 1.0 + 0.003 * jnp.arange(k, dtype=dtype)
            _, outs = jax.lax.scan(one, 0, scales)
            return outs

        t0 = time.monotonic()
        sums, _, _ = chain(coils0.currents, 1)
        np.asarray(sums)
        cold_ms = (time.monotonic() - t0) * 1e3

        def wall(k, reps=3):
            np.asarray(chain(coils0.currents, k)[0])     # warm
            ts = []
            for _ in range(reps):
                t0 = time.monotonic()
                np.asarray(chain(coils0.currents, k)[0])
                ts.append(time.monotonic() - t0)
            return min(ts) * 1e3

        w1 = wall(1)
        w5 = wall(5)
        device_ms = max((w5 - w1) / 4.0, 0.0)
        _, iters5, conv5 = chain(coils0.currents, 5)
        return {
            "n": n, "device_ms": device_ms, "w1": w1, "w5": w5,
            "cold_ms": cold_ms,
            "iters": [int(x) for x in np.asarray(iters5)],
            "all_converged": bool(np.all(np.asarray(conv5))),
            "psi": psi_one,
        }

    lanes = []
    m129 = measure(129, tol=2.5e-4)
    ok1 = m129["all_converged"] and 0.0 < m129["device_ms"] <= REF_WARM_NOMG_MS
    lanes.append(LaneResult(
        name="warm_forward_129_device",
        status="pass" if ok1 else "fail",
        metrics={"device_per_solve_ms": round(m129["device_ms"], 3),
                 "wall_1_solve_ms": round(m129["w1"], 1),
                 "wall_5_solve_ms": round(m129["w5"], 1),
                 "outer_iterations": m129["iters"],
                 "all_converged": m129["all_converged"],
                 "backend": backend,
                 "reference_h100_warm_ms": REF_WARM_MS,
                 "reference_h100_warm_no_mg_ms": REF_WARM_NOMG_MS},
        thresholds={"device_per_solve_ms": REF_WARM_NOMG_MS},
        notes=("whole free-boundary solve = ONE while_loop program; "
               "per-solve time by solve-count slope.  "
               "DTYPE DISCLOSURE: f32 here vs the reference's FP64 H100 "
               "figure (the float64 lane follows).  "
               "Outer tol 2.5e-4 (~5e-6 span-rel): the f32 fixed point "
               "is a ~25-ulp limit cycle (measured 2026-08-19), 1e-4 "
               "sits on its boundary; the f64 lane holds tol=1e-4"),
    ))

    # ── f64 apples-to-apples lane: the reference's 13.0 ms is FP64 on a
    # dedicated H100; this lane runs the SAME solve in f64 on the GPU.
    if backend_mod.device_info().platform == "gpu":
        with jax.enable_x64(True):
            m64 = measure(129, dtype=jnp.float64)
        ok64 = m64["all_converged"] and 0.0 < m64["device_ms"] <= REF_WARM_MS
        lanes.append(LaneResult(
            name="warm_forward_129_device_f64",
            status="pass" if ok64 else "fail",
            metrics={"device_per_solve_ms": round(m64["device_ms"], 3),
                     "wall_1_solve_ms": round(m64["w1"], 1),
                     "outer_iterations": m64["iters"],
                     "all_converged": m64["all_converged"],
                     "reference_h100_fp64_warm_ms": REF_WARM_MS,
                     "beat_factor": round(REF_WARM_MS
                                          / max(m64["device_ms"], 1e-9), 2)},
            thresholds={"device_per_solve_ms": REF_WARM_MS},
            notes=("FULL-f64 free-boundary forward (f32-Gram Anderson) "
                   "vs the reference's FP64 H100 13.0 ms — same "
                   "precision, same 129^2 problem class, slope-timed"),
        ))
        # ── mixed-precision lane (beyond the reference): f64 outer loop,
        # boundary flux, and convergence criterion; each inner elliptic is
        # f64-defect -> f32-V-cycle correction (mixed_n_refine rounds,
        # models/equilibrium/mixed_precision.py).  Same f64 convergence
        # semantics as the lane above at near-f32 device cost; accuracy
        # gated HERE by span-rel parity against the full-f64 fixed point
        # (plus tests/test_free_boundary.py::test_mixed_precision_matches
        # _full_f64 on CPU x64).
        with jax.enable_x64(True):
            mmx = measure(129, dtype=jnp.float64, mixed_n_refine=2)
            psi_64 = m64["psi"]()
            psi_mx = mmx["psi"]()
        span = float(psi_64.max() - psi_64.min())
        parity = float(np.max(np.abs(psi_64 - psi_mx))) / span
        okmx = (mmx["all_converged"] and parity < 1e-5
                and 0.0 < mmx["device_ms"] <= REF_WARM_MS)
        lanes.append(LaneResult(
            name="warm_forward_129_device_mixed",
            status="pass" if okmx else "fail",
            metrics={"device_per_solve_ms": round(mmx["device_ms"], 3),
                     "outer_iterations": mmx["iters"],
                     "all_converged": mmx["all_converged"],
                     "span_rel_parity_vs_f64": parity,
                     "reference_h100_fp64_warm_ms": REF_WARM_MS,
                     "beat_factor": round(REF_WARM_MS
                                          / max(mmx["device_ms"], 1e-9), 2)},
            thresholds={"device_per_solve_ms": REF_WARM_MS,
                        "span_rel_parity_vs_f64": 1e-5},
            notes=("mixed-precision forward: f64 master iterate + "
                   "criterion, f32 MG defect correction (2 rounds) — "
                   "f64-class answer (parity gate) at ~2x the f32 lane's "
                   "cost, vs the reference's FP64 H100 13.0 ms"),
        ))
    else:
        lanes.append(LaneResult(
            name="warm_forward_129_device_f64", status="blocked",
            notes="no GPU in this environment"))
        lanes.append(LaneResult(
            name="warm_forward_129_device_mixed", status="blocked",
            notes="no GPU in this environment"))

    # Beyond the reference: the same compiled forward at 257^2 (the
    # reference ships no free-boundary number above 129^2).
    # Outer tol is absolute on max|dpsi| (psi span ~50 here): 3e-4 is
    # ~6e-6 span-relative, matched to the f32 inner-solve noise floor at
    # this resolution.
    m257 = measure(257, max_outer=40, tol=3e-4)
    ok3 = m257["all_converged"] and m257["device_ms"] > 0.0
    lanes.append(LaneResult(
        name="warm_forward_257_device",
        status="pass" if ok3 else "fail",
        metrics={"device_per_solve_ms": round(m257["device_ms"], 3),
                 "outer_iterations": m257["iters"],
                 "all_converged": m257["all_converged"],
                 "backend": backend},
        thresholds={},
        notes="no reference artifact exists at this resolution; recorded "
              "as capability headroom",
    ))

    cold_ms, w1 = m129["cold_ms"], m129["w1"]
    warm_ratio = cold_ms / max(w1, 1e-9)
    ok2 = warm_ratio >= 3.0
    lanes.append(LaneResult(
        name="cold_vs_warm_compile",
        status="pass" if ok2 else "fail",
        metrics={"cold_wall_ms": round(cold_ms, 1),
                 "warm_wall_ms": round(w1, 1),
                 "speedup": round(warm_ratio, 2),
                 "reference_cold_ms": REF_COLD_MS,
                 "reference_warm_ms": REF_WARM_MS},
        thresholds={"speedup": 3.0},
        notes="reference row: 164.8 -> 13.0 ms (12.7x) on dedicated "
              "hardware",
    ))

    write_report("free_boundary_forward", lanes)
    return 0 if all(ln.status == "pass" for ln in lanes
                    if ln.status != "blocked") else 1


if __name__ == "__main__":
    sys.exit(main())
