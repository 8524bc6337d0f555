#!/usr/bin/env python
"""Benchmark: one converged 513x513 Grad-Shafranov equilibrium on the GPU.

The solve is the FMG Anderson-MG-Picard cascade (129^2 and 257^2 at a
loose 1e-3, then 513^2 at 1e-4, each level warm-started from the last) in
float32 on the synthetic 6-coil machine of :func:`bench_config`.  Time is
the host clock around one call that ends in ``block_until_ready``: the
median and the slowest of ``--reps`` calls after one warm-up call, whose
trace and compile time is reported apart.  ``vs_baseline`` divides the
NumPy twin's time for the same cascade on the host by the median.

Needs a GPU: with none it fails and prints no result.  Run with
``python bench.py``.  Prints ONE JSON line.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)) or ".")

import numpy as np  # noqa: E402

LEVELS = (129, 257, 513)
COARSE_TOL = 1e-3


def bench_config(n: int = 513):
    """The benchmark's machine: six PF coils around an 8 m x 8 m box."""
    from scpn_fusion_tpu.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
    )

    coils = (
        Coil(r=3.5, z=4.8, current=-1.0), Coil(r=8.0, z=4.8, current=4.0),
        Coil(r=10.8, z=0.0, current=6.0), Coil(r=8.0, z=-4.8, current=4.0),
        Coil(r=3.5, z=-4.8, current=-1.0), Coil(r=10.8, z=2.5, current=3.0),
    )
    return ReactorConfig(
        reactor_name=f"bench-{n}",
        grid_resolution=(n, n),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=coils,
        physics=PhysicsParams(plasma_current_target=15.0, vacuum_permeability=1.0),
        solver=SolverParams(
            # Anderson-accelerated multigrid-Picard: same fixed point as
            # plain multigrid-Picard (span-rel dev at the 1e-4
            # convergence-tolerance scale) in a handful of outer
            # iterations.  relaxation 1.0: the undamped Picard map already
            # contracts and the type-II AA mixer cuts it further.
            max_iterations=600, convergence_threshold=1e-4,
            relaxation_factor=1.0, solver_method="anderson_mg",
            anderson_depth=4,
            # (1,2) pre/post smoothing: the benchmark's own choice; the
            # package default stays (3,3) (ROADMAP D4).
            mg_pre_smooth=1, mg_post_smooth=2,
        ),
    )


def device_kernels(trace_dir: str) -> dict:
    """Kernel events on the GPU planes of the newest profiler trace under
    ``trace_dir``: ``{line name: [count, total device ms]}``."""
    import glob

    import jax

    path = max(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True),
               key=os.path.getmtime)
    out = {}
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            out[f"{plane.name}|{line.name}"] = [
                len(events), sum(e.duration_ns for e in events) / 1e6]
    return out


def pieces(reps: int, trace_dir: str) -> None:
    """What XLA makes of the V-cycle at 129^2, 257^2, 513^2 and 2049^2,
    the Picard source step at 513^2 and one whole 513^2 solve, float32,
    benchmark smoothing.  Prints one JSON line per
    piece: median and slowest host-clock time per call around
    ``block_until_ready``, and the kernel events of one traced call."""
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.profiles import (
        plasma_current_density, profile_coeffs_from_physics,
    )
    from scpn_fusion_tpu.models.equilibrium.topology import analyze_topology
    from scpn_fusion_tpu.ops.multigrid import vcycle

    def case(n):
        cfg = bench_config(n)
        grid = Grid.from_config(cfg, dtype=np.float32)
        rr, zz = np.asarray(grid.RR), np.asarray(grid.ZZ)
        psi = jnp.asarray(np.exp(-((rr - 6.0) ** 2 + zz ** 2) / 3.0),
                          jnp.float32)
        return cfg, grid, psi

    def timed(name, fn, *args):
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(1e3 * (time.perf_counter() - t0))
        sub = os.path.join(trace_dir, name)
        with jax.profiler.trace(sub):
            jax.block_until_ready(fn(*args))
        print(json.dumps({"piece": name, "median_ms": float(np.median(ts)),
                          "max_ms": max(ts), "n": reps,
                          "kernels": device_kernels(sub)}), flush=True)

    for n in (129, 257, 513, 2049):
        cfg, grid, psi = case(n)
        sol = cfg.solver
        fn = jax.jit(lambda p, s, g=grid, sol=sol: vcycle(
            p, s, g.R, g.dR, g.dZ, pre_smooth=sol.mg_pre_smooth,
            post_smooth=sol.mg_post_smooth, min_grid=sol.mg_min_grid))
        timed(f"vcycle_{n}", fn, psi, -psi)

    cfg, grid, psi = case(513)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, jnp.float32)

    @jax.jit
    def source(p):
        topo = analyze_topology(p, grid.ZZ, grid.dR, grid.dZ, grid.Z_min)
        j = plasma_current_density(
            p, topo.psi_axis, topo.psi_boundary, grid.RR, h_mode=False,
            p_coeffs=p_c, ff_coeffs=ff_c, mu0=1.0,
            i_target=jnp.float32(15.0), d_r=grid.dR, d_z=grid.dZ)
        return -grid.RR * j

    timed("picard_source_513", source, psi)

    # One whole 513^2 solve from the vacuum start: kernels per outer
    # iteration are the traced kernel events over ``iterations``.
    from scpn_fusion_tpu.models.equilibrium import solve_equilibrium

    def solve():
        res = solve_equilibrium(cfg, dtype=jnp.float32)
        return res.psi, res.iterations

    print(json.dumps({"piece": "solve_513_iterations",
                      "iterations": int(solve()[1])}))
    timed("solve_513", solve)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--pieces", metavar="TRACE_DIR",
                    help="time the V-cycle and source step alone instead, "
                         "writing profiler traces under TRACE_DIR")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.core import backend
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
        _solve_fixed_boundary,
    )
    from scpn_fusion_tpu.models.equilibrium.profiles import (
        profile_coeffs_from_physics,
    )
    from scpn_fusion_tpu.models.equilibrium.vacuum import vacuum_psi_from_config
    from scpn_fusion_tpu.ops.multigrid import prolongate_bilinear
    from scpn_fusion_tpu.utils import npref

    device = backend.require_gpu()
    backend.enable_compile_cache()
    if args.pieces:
        print(json.dumps({"device": device.as_dict()}))
        pieces(args.reps, args.pieces)
        return 0

    cfg = bench_config(LEVELS[-1])
    cfgs = {m: dataclasses.replace(cfg, grid_resolution=(m, m)) for m in LEVELS}
    grids = {m: Grid.from_config(cfgs[m], dtype=np.float32) for m in LEVELS}
    bcs = {m: vacuum_psi_from_config(grids[m], cfgs[m]).astype(jnp.float32)
           for m in LEVELS}
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, jnp.float32)
    sol = cfg.solver

    def level(m, psi_init, i_t, tol, skip_seed):
        return _solve_fixed_boundary(
            grids[m], psi_init, bcs[m], i_t, p_c, ff_c,
            jnp.asarray(tol, jnp.float32), jnp.asarray(jnp.inf, jnp.float32),
            jnp.asarray(sol.relaxation_factor, jnp.float32),
            jnp.asarray(sol.sor_omega, jnp.float32),
            solver_method=sol.solver_method,
            max_iter=sol.max_iterations, h_mode=False,
            inner_sweeps=sol.inner_sweeps,
            anderson_m=sol.anderson_depth, mu0=1.0,
            use_gs_criterion=False, skip_seed=skip_seed,
            mg_pre_smooth=sol.mg_pre_smooth,
            mg_post_smooth=sol.mg_post_smooth,
            mg_min_grid=sol.mg_min_grid)

    @jax.jit
    def cascade(i_t):
        r1 = level(129, bcs[129], i_t, COARSE_TOL, False)
        r2 = level(257, prolongate_bilinear(r1.psi, 257, 257), i_t,
                   COARSE_TOL, True)
        r3 = level(513, prolongate_bilinear(r2.psi, 513, 513), i_t,
                   sol.convergence_threshold, True)
        return r3.psi, r3.iterations, r1.converged & r2.converged & r3.converged

    i_t = jnp.asarray(cfg.physics.plasma_current_target, jnp.float32)
    t0 = time.perf_counter()
    psi, iters, conv = jax.block_until_ready(cascade(i_t))
    first_s = time.perf_counter() - t0
    if not bool(conv):
        raise RuntimeError("benchmark solve did not converge")

    times_ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(cascade(i_t))
        times_ms.append(1e3 * (time.perf_counter() - t0))
    median_ms = float(np.median(times_ms))

    # NumPy twin: the same FMG Anderson-MG cascade on the host, float64.
    t0 = time.perf_counter()
    np_psi0 = None
    for m in LEVELS:
        g = Grid.from_config(cfgs[m], dtype=np.float64)
        np_res = npref.solve_equilibrium_np(
            np.asarray(g.R, np.float64), np.asarray(g.Z, np.float64),
            np.asarray(vacuum_psi_from_config(g, cfgs[m]), np.float64),
            cfg.physics.plasma_current_target, mu0=1.0,
            max_iter=sol.max_iterations,
            tol=sol.convergence_threshold if m == LEVELS[-1] else COARSE_TOL,
            alpha=sol.relaxation_factor, anderson_m=sol.anderson_depth,
            psi0=np_psi0)
        if m != LEVELS[-1]:
            np_psi0 = npref.prolongate_bilinear_np(
                np_res["psi"], 2 * m - 1, 2 * m - 1)
    np_ms = 1e3 * (time.perf_counter() - t0)

    ref = np_res["psi"]
    span_rel = float(np.max(np.abs(np.asarray(psi, np.float64) - ref))
                     / (ref.max() - ref.min()))
    print(json.dumps({
        "metric": "gs_converged_513_ms",
        "value": round(median_ms, 3),
        "unit": "ms",
        "max_ms": round(max(times_ms), 3),
        "n": args.reps,
        "first_call_s": round(first_s, 3),
        "fine_iterations": int(iters),
        "span_rel_dev_vs_numpy": span_rel,
        "vs_baseline": round(np_ms / median_ms, 2),
        "device": device.as_dict(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
