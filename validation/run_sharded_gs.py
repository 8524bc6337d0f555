#!/usr/bin/env python
"""Sharded Grad-Shafranov validation campaign (multi-chip evidence).

Lanes (fail-closed, blocked != pass):
1. shard_count_invariance_1d — the Z-slab sharded SOR program must reach
   the same field for n_shards in {1, 2, 4, 8} (global checkerboard
   parity preserved across shard counts; VERDICT r1 weak #6: no
   validation-level campaign exercised the sharded solve).
2. shard_count_invariance_2d — the 2D-tiled program (4x2 process grid)
   must match the 1-shard result.
3. sharded_scaling_shape     — per-sweep wall-clock vs shard count on the
   virtual CPU mesh.  This is a SHAPE diagnostic (virtual devices share
   host cores, so speedup is not expected); recorded honestly as such.
   The single-device perf datapoint is bench.py.
4. sharded_vs_plain_program  — n_shards=1 through the shard_map program
   vs the plain single-device sweep path: the distributed-program
   overhead and numerical identity on one device.

Runs on the 8-virtual-device CPU mesh (platform forced before backend
init).  Writes checksummed JSON+MD evidence into validation/reports/.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def main() -> int:
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.ops.stencil import gs_operator, sor_sweeps
    from scpn_fusion_tpu.parallel.halo import make_z_mesh, sharded_sor_solve
    from scpn_fusion_tpu.parallel.halo2d import (
        make_2d_mesh,
        sharded_sor_solve_2d,
    )
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    lanes = []
    dtype = jnp.float64
    n_devices = len(jax.devices())
    if n_devices < 8:
        lanes.append(LaneResult(
            name="shard_count_invariance_1d", status="blocked",
            notes=f"needs 8 virtual devices, got {n_devices}"))
        write_report("sharded_gs", lanes)
        return 1

    # Problem: manufactured GS solve on a 256x258 grid (NZ divisible by
    # every Z shard count tested, NR divisible by any 2D process-grid split).
    nz, nr = 256, 256
    grid = Grid.from_bounds(nr, nz, 2.0, 10.0, -4.0, 4.0, dtype=np.float64)
    rr, zz = np.asarray(grid.RR), np.asarray(grid.ZZ)
    psi_exact = jnp.asarray(np.exp(-((rr - 6.0) ** 2 + zz**2) / 3.0), dtype)
    src = gs_operator(psi_exact, grid.R, grid.dR, grid.dZ)
    rng = np.random.default_rng(7)
    psi0 = jnp.asarray(np.asarray(psi_exact)
                       + 0.05 * rng.standard_normal(grid.shape), dtype)
    omega = jnp.asarray(1.7, dtype)
    n_sweeps = 200
    span = float(jnp.max(psi_exact) - jnp.min(psi_exact))

    # ── Lane 1 + 3: shard-count invariance + scaling shape (1D Z-slab) ──
    results = {}
    timings = {}
    for n_sh in (1, 2, 4, 8):
        mesh = make_z_mesh(n_sh)
        out, res = sharded_sor_solve(
            psi0, src, grid.R, omega, mesh=mesh, axis="z",
            d_r=grid.dR, d_z=grid.dZ, n_sweeps=n_sweeps, nz_total=grid.NZ)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out, res = sharded_sor_solve(
            psi0, src, grid.R, omega, mesh=mesh, axis="z",
            d_r=grid.dR, d_z=grid.dZ, n_sweeps=n_sweeps, nz_total=grid.NZ)
        jax.block_until_ready(out)
        timings[n_sh] = (time.perf_counter() - t0) / n_sweeps * 1e3
        results[n_sh] = np.asarray(out)

    max_dev = max(
        float(np.max(np.abs(results[n] - results[1]))) / span
        for n in (2, 4, 8))
    err_vs_exact = float(np.max(np.abs(
        results[8] - np.asarray(psi_exact)))) / span
    gate_dev = 1e-10   # identical algorithm across shard counts (f64)
    lanes.append(LaneResult(
        name="shard_count_invariance_1d",
        status="pass" if max_dev < gate_dev else "fail",
        metrics={"max_span_rel_deviation_vs_1shard": max_dev,
                 "err_vs_manufactured_span_rel": err_vs_exact,
                 "n_sweeps": n_sweeps, "grid": f"{nz}x{nr}"},
        thresholds={"max_span_rel_deviation_vs_1shard": gate_dev},
        notes="global checkerboard parity preserved across Z-slab shard "
              "counts 1/2/4/8; x64 CPU mesh"))

    lanes.append(LaneResult(
        name="sharded_scaling_shape",
        status="pass" if all(np.isfinite(list(timings.values()))) else "fail",
        metrics={f"ms_per_sweep_{n}shards": round(t, 4)
                 for n, t in timings.items()},
        notes="virtual devices share host cores — recorded as program-"
              "shape evidence, NOT a speedup claim; the real-chip perf "
              "datapoint is bench.py (driver lane)"))

    # ── Lane 2: 2D tiling invariance ──
    mesh2 = make_2d_mesh(8)   # optimal_process_grid(8) -> (4, 2)
    out2d, _ = sharded_sor_solve_2d(
        psi0, src, grid.R, omega, mesh=mesh2,
        d_r=grid.dR, d_z=grid.dZ, n_sweeps=n_sweeps,
        nz_total=grid.NZ, nr_total=grid.NR)
    jax.block_until_ready(out2d)
    dev_2d = float(np.max(np.abs(np.asarray(out2d) - results[1]))) / span
    lanes.append(LaneResult(
        name="shard_count_invariance_2d",
        status="pass" if dev_2d < gate_dev else "fail",
        metrics={"span_rel_deviation_vs_1shard": dev_2d,
                 "process_grid": "x".join(str(v) for v in mesh2.shape.values()) if hasattr(mesh2.shape, "values") else str(mesh2.shape)},
        thresholds={"span_rel_deviation_vs_1shard": gate_dev},
        notes="2D Cartesian tiling (halo2d) vs single-shard reference"))

    # ── Lane 4: sharded program (1 shard) vs plain sweep path ──
    plain = sor_sweeps(psi0, src, grid.R, grid.dR, grid.dZ, 1.7,
                       n_sweeps)
    jax.block_until_ready(plain)
    t0 = time.perf_counter()
    plain = sor_sweeps(psi0, src, grid.R, grid.dR, grid.dZ, 1.7,
                       n_sweeps)
    jax.block_until_ready(plain)
    t_plain = (time.perf_counter() - t0) / n_sweeps * 1e3
    dev_plain = float(np.max(np.abs(np.asarray(plain) - results[1]))) / span
    overhead = timings[1] / max(t_plain, 1e-9)
    lanes.append(LaneResult(
        name="sharded_vs_plain_program",
        status="pass" if dev_plain < gate_dev else "fail",
        metrics={"span_rel_deviation": dev_plain,
                 "ms_per_sweep_plain": round(t_plain, 4),
                 "ms_per_sweep_shardmap_1shard": round(timings[1], 4),
                 "shardmap_overhead_ratio": round(overhead, 3)},
        thresholds={"span_rel_deviation": gate_dev},
        notes="numerical identity of the distributed program at "
              "n_shards=1 + its dispatch overhead vs the plain XLA path"))

    path = write_report("sharded_gs", lanes)
    print(f"wrote {path}")
    return 0 if all(lane.status == "pass" for lane in lanes) else 1


if __name__ == "__main__":
    raise SystemExit(main())
