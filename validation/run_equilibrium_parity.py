#!/usr/bin/env python
"""Equilibrium parity validation campaign.

Lanes (fail-closed, blocked != pass):
1. solovev_analytic      — exact-solution recovery + O(h^2) convergence
2. geqdsk_reconstruction — DIII-D/SPARC public-fixture envelope (the
                           fixtures are synthetic; see tests/test_eqdsk_solve)
3. numpy_twin_parity     — compiled solver vs NumPy twin span-rel deviation

Writes checksummed JSON+MD evidence into validation/reports/.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def main() -> int:
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.core import backend as backend_mod
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.solovev import SolovevParams
    from scpn_fusion_tpu.ops import multigrid as mg
    from scpn_fusion_tpu.ops.stencil import apply_dirichlet
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    lanes = []
    # On the GPU the lanes run the device's f32 production precision.
    on_gpu = backend_mod.device_info().platform == "gpu"
    dtype = jnp.float32 if on_gpu else jnp.float64

    # ── Lane 1: Solov'ev analytic ──
    params = SolovevParams()

    def solovev_err(n):
        grid = Grid.from_bounds(n, n, 3.0, 9.0, -3.0, 3.0,
                                dtype=np.float32 if on_gpu else np.float64)
        psi_exact = params.psi(grid.RR, grid.ZZ).astype(dtype)
        src = params.source(grid.RR).astype(dtype)
        psi0 = apply_dirichlet(jnp.zeros_like(psi_exact), psi_exact)
        out = mg.mg_solve(psi0, src, grid.R, grid.dR, grid.dZ, n_cycles=30)
        span = float(jnp.max(psi_exact) - jnp.min(psi_exact))
        return float(jnp.max(jnp.abs(out - psi_exact))) / span

    e65 = solovev_err(65)
    e129 = solovev_err(129)
    # f32 floors near 1e-6 span-rel; gates per-precision.
    gate = 2e-4 if not on_gpu else 2e-3
    # Order check cannot be resolved once the fine-grid error sits at the
    # f32 rounding floor (~1e-5 span-rel); below that floor the
    # solve is as exact as the precision allows.
    order_ok = (e65 / max(e129, 1e-12)) > 2.5 or e129 < 1e-5
    lanes.append(LaneResult(
        name="solovev_analytic",
        status="pass" if (e65 < gate and order_ok) else "fail",
        metrics={"span_rel_err_65": e65, "span_rel_err_129": e129,
                 "convergence_ratio": e65 / max(e129, 1e-12)},
        thresholds={"span_rel_err_65": gate},
        notes=f"dtype={jnp.dtype(dtype).name}, backend={jax.default_backend()}",
    ))

    # ── Lane 2: GEQDSK fixture reconstruction ──
    ref_data = Path("/root/reference/validation/reference_data")
    cases = [("diiid/diiid_hmode_2MA.geqdsk", 0.25),
             ("diiid/diiid_lmode_1MA.geqdsk", 0.30),
             ("sparc/sparc_1300.eqdsk", 0.25)]
    if not ref_data.exists():
        lanes.append(LaneResult(
            name="geqdsk_reconstruction", status="blocked",
            notes="reference fixture data not mounted"))
    else:
        from scpn_fusion_tpu.io import read_geqdsk
        from scpn_fusion_tpu.models.equilibrium.eqdsk_solve import solve_from_geqdsk
        metrics, thresholds, ok = {}, {}, True
        for rel, gate_v in cases:
            eq = read_geqdsk(ref_data / rel)
            res = solve_from_geqdsk(eq, max_iter=400,
                                    dtype=jnp.float32 if on_gpu else jnp.float64)
            rmse = float(res.span_rel_rmse)
            key = rel.split("/")[-1]
            metrics[f"{key}.span_rel_rmse"] = rmse
            metrics[f"{key}.converged"] = bool(res.converged)
            thresholds[f"{key}.span_rel_rmse"] = gate_v
            ok = ok and bool(res.converged) and rmse < gate_v
        lanes.append(LaneResult(
            name="geqdsk_reconstruction",
            status="pass" if ok else "fail",
            metrics=metrics, thresholds=thresholds,
            notes=("repo-specific ENVELOPE gate on the naive vacuum-outside "
                   "profile-source re-solve; the reference gates psi NRMSE "
                   "at 0.05 (benchmark_sparc_geqdsk_rmse.py:31) — that "
                   "strict parity lives in run_real_shot_accuracy.py "
                   "(measured-external-source lane, all 5 SPARC files "
                   "under 0.0031 NRMSE); this lane only regression-guards "
                   "the simple solver path")))

    # ── Lane 3: NumPy-twin parity on the full nonlinear solve ──
    from scpn_fusion_tpu.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams)
    from scpn_fusion_tpu.models.equilibrium import solve_equilibrium
    from scpn_fusion_tpu.models.equilibrium.vacuum import vacuum_psi_from_config
    from scpn_fusion_tpu.utils import npref

    coils = (Coil(r=3.5, z=4.8, current=-1.0), Coil(r=8.0, z=4.8, current=4.0),
             Coil(r=10.8, z=0.0, current=6.0), Coil(r=8.0, z=-4.8, current=4.0),
             Coil(r=3.5, z=-4.8, current=-1.0), Coil(r=10.8, z=2.5, current=3.0))
    cfg = ReactorConfig(
        reactor_name="parity-65",
        grid_resolution=(65, 65),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=coils,
        physics=PhysicsParams(plasma_current_target=15.0, vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=600, convergence_threshold=1e-4,
                            relaxation_factor=0.1, solver_method="multigrid"))
    res = solve_equilibrium(cfg, dtype=dtype)
    grid = Grid.from_config(cfg, dtype=np.float64)
    psi_bc = np.asarray(vacuum_psi_from_config(
        Grid.from_config(cfg, dtype=np.float64), cfg), dtype=np.float64)
    np_res = npref.solve_equilibrium_np(
        np.asarray(grid.R, np.float64), np.asarray(grid.Z, np.float64),
        psi_bc, 15.0, mu0=1.0, max_iter=600, tol=1e-4, alpha=0.1)
    span = np_res["psi"].max() - np_res["psi"].min()
    dev = float(np.max(np.abs(np.asarray(res.psi, np.float64) - np_res["psi"])) / span)
    gate3 = 1e-3 if on_gpu else 1e-6
    lanes.append(LaneResult(
        name="numpy_twin_parity",
        status="pass" if (bool(res.converged) and np_res["converged"]
                          and dev < gate3) else "fail",
        metrics={"span_rel_deviation": dev,
                 "jax_iterations": int(res.iterations),
                 "numpy_iterations": int(np_res["iterations"])},
        thresholds={"span_rel_deviation": gate3}))

    path = write_report("equilibrium_parity", lanes,
                        out_dir=Path(__file__).parent / "reports")
    import json
    payload = json.loads(path.read_text())
    print(f"report: {path}")
    print(f"overall: {payload['overall_status']}")
    for lane in payload["lanes"]:
        print(f"  {lane['name']}: {lane['status']}")
    return 0 if payload["overall_status"] == "pass" else 1


if __name__ == "__main__":
    raise SystemExit(main())
