#!/usr/bin/env python
"""Cross-implementation GS-kernel parity: C++ / NumPy / JAX CPU / JAX GPU.

Counterpart of the reference's polyglot solver comparison
(``benchmarks/polyglot_gs_solver_comparison.py``: the SAME GS case solved
by the Python, Rust, Go and Julia ports and cross-checked).  This repo's
implementation inventory is C++ (``native/gs_runtime.cpp``, the reference
HPC-bridge analogue), the NumPy twin (``utils/npref.py``), and the JAX/XLA
path (``ops/stencil.py``) on CPU f64 and GPU f32 — Go/Julia are
out-of-scope per SURVEY section 2.11, and this lane covers the same
intent: independent implementations of the same kernel agreeing on the
same problem.

Problem: manufactured solution on a 65x65 (R, Z) grid — psi_exact a
smooth Gaussian, source = GS*[psi_exact], Dirichlet boundary from
psi_exact — so every implementation solves the identical well-posed
elliptic problem with a known answer.

Lanes (fail-closed):

1. ``sweep_trajectory_parity`` — ONE red-black SOR sweep from the same
   perturbed state: C++ vs NumPy vs JAX-CPU must agree to 1e-13 span-rel
   (identical update ordering, f64; the strong polyglot-style check).
2. ``converged_cross_implementation`` — each implementation runs SOR to
   residual convergence; pairwise span-rel deviation <= 1e-8 AND every
   implementation's error vs psi_exact within 1.5x of the best (no
   implementation converges to a different fixed point).
3. ``gpu_f32_parity`` — the XLA SOR sweep compiled for the GPU runs the
   same sweep count in f32 as the NumPy twin in f64; span-rel deviation
   <= 1e-5.  Blocked (not passed) without a GPU; the C++ lane is skipped
   honestly when no toolchain exists.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def _problem(n=65):
    r_1d = np.linspace(2.0, 10.0, n)
    z_1d = np.linspace(-4.0, 4.0, n)
    d_r = float(r_1d[1] - r_1d[0])
    d_z = float(z_1d[1] - z_1d[0])
    rr, zz = np.meshgrid(r_1d, z_1d)
    psi_exact = np.exp(-((rr - 6.0) ** 2 + zz**2) / 3.0)
    return r_1d, d_r, d_z, psi_exact


def main() -> int:
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.core import backend as backend_mod
    from scpn_fusion_tpu.native import runtime as native_rt
    from scpn_fusion_tpu.utils import npref
    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    lanes = []

    r_1d, d_r, d_z, psi_exact = _problem()
    source = npref.gs_operator_np(psi_exact, r_1d, d_r, d_z)
    rng = np.random.default_rng(42)
    psi0 = psi_exact + 0.1 * rng.standard_normal(psi_exact.shape)
    psi0[0, :] = psi_exact[0, :]
    psi0[-1, :] = psi_exact[-1, :]
    psi0[:, 0] = psi_exact[:, 0]
    psi0[:, -1] = psi_exact[:, -1]
    span = float(psi_exact.max() - psi_exact.min())

    native_ok = native_rt.is_available()

    def native_sweeps(n_sweeps, omega=1.6):
        solver = native_rt.NativeGSSolver(r_1d, d_r, d_z, nz=psi0.shape[0])
        solver.set_state(psi0, source)
        solver.set_boundary(psi_exact)
        solver.sweeps(n_sweeps, omega=omega)
        return solver.psi

    def numpy_sweeps(n_sweeps, omega=1.6):
        out = psi0.copy()
        for _ in range(n_sweeps):
            out = npref.sor_step_np(out, source, r_1d, d_r, d_z, omega)
        return out

    def jax_cpu_sweeps(n_sweeps, omega=1.6):
        import jax.numpy as jnp

        from scpn_fusion_tpu.ops.stencil import sor_step
        with jax.default_device(jax.devices("cpu")[0]):
            out = jnp.asarray(psi0, jnp.float64)
            s = jnp.asarray(source, jnp.float64)
            r = jnp.asarray(r_1d, jnp.float64)
            for _ in range(n_sweeps):
                out = sor_step(out, s, r, d_r, d_z,
                               jnp.asarray(omega, jnp.float64))
            return np.asarray(out, np.float64)

    # ── 1. one-sweep trajectory parity (f64, identical ordering) ─────
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    one_np = numpy_sweeps(1)
    one_jx = jax_cpu_sweeps(1)
    dev_jx = float(np.max(np.abs(one_np - one_jx))) / span
    metrics = {"numpy_vs_jax_cpu_span_rel": dev_jx}
    dev_cpp = None
    if native_ok:
        one_cpp = native_sweeps(1)
        dev_cpp = float(np.max(np.abs(one_np - one_cpp))) / span
        metrics["numpy_vs_cpp_span_rel"] = dev_cpp
    else:
        metrics["numpy_vs_cpp_span_rel"] = "skipped (no C++ toolchain)"
    ok = dev_jx < 1e-13 and (dev_cpp is None or dev_cpp < 1e-13)
    lanes.append(LaneResult(
        name="sweep_trajectory_parity",
        status="pass" if ok else "fail",
        metrics=metrics,
        thresholds={"span_rel": 1e-13},
        notes="one red-black SOR sweep from the identical state: same "
              "update ordering across implementations (the reference's "
              "polyglot trajectory check)"))

    # ── 2. converged solves agree on the fixed point ──────────────────
    n_conv = 4000
    sols = {"numpy": numpy_sweeps(n_conv), "jax_cpu": jax_cpu_sweeps(n_conv)}
    if native_ok:
        sols["cpp"] = native_sweeps(n_conv)
    errs = {k: float(np.max(np.abs(v - psi_exact))) / span
            for k, v in sols.items()}
    pair_dev = {}
    keys = sorted(sols)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            pair_dev[f"{a}_vs_{b}"] = (
                float(np.max(np.abs(sols[a] - sols[b]))) / span)
    best = min(errs.values())
    ok = (all(d < 1e-8 for d in pair_dev.values())
          and all(e <= 1.5 * best + 1e-12 for e in errs.values()))
    lanes.append(LaneResult(
        name="converged_cross_implementation",
        status="pass" if ok else "fail",
        metrics={**{f"err_vs_exact_{k}": v for k, v in errs.items()},
                 **{f"dev_{k}": v for k, v in pair_dev.items()},
                 "implementations": keys},
        thresholds={"pairwise_span_rel": 1e-8,
                    "err_vs_exact": "<= 1.5x best implementation"},
        notes=f"{n_conv} SOR sweeps to the discrete fixed point; every "
              "implementation lands on the same solution of the same "
              "manufactured problem"))

    # ── 3. GPU f32 XLA sweep vs the f64 consensus ─────────────────────
    if backend_mod.device_info().platform == "gpu":
        from scpn_fusion_tpu.ops.stencil import sor_sweeps
        n_sw = 400
        ref = numpy_sweeps(n_sw)
        out = sor_sweeps(
            jnp.asarray(psi0, jnp.float32), jnp.asarray(source, jnp.float32),
            jnp.asarray(r_1d, jnp.float32), d_r, d_z,
            1.6, n_sw)
        dev = float(np.max(np.abs(np.asarray(out, np.float64) - ref))) / span
        ok = dev < 1e-5
        lanes.append(LaneResult(
            name="gpu_f32_parity",
            status="pass" if ok else "fail",
            metrics={"span_rel_dev_vs_numpy_f64": dev, "n_sweeps": n_sw},
            thresholds={"span_rel_dev_vs_numpy_f64": 1e-5},
            notes="XLA red-black sweep compiled for the GPU, f32, vs the "
                  "f64 NumPy twin, same sweep count"))
    else:
        lanes.append(LaneResult(
            name="gpu_f32_parity", status="blocked",
            notes="no GPU in this environment"))

    path = write_report("implementation_parity", lanes)
    print(f"wrote {path}")
    return 0 if all(l.status == "pass" for l in lanes
                    if l.status != "blocked") else 1


if __name__ == "__main__":
    raise SystemExit(main())
