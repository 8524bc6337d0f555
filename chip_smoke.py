#!/usr/bin/env python
"""Run the equilibrium main path once on an NVIDIA GPU and check its answers.

    python chip_smoke.py              # phases 1-6 on one card
    python chip_smoke.py --multichip  # the cross-device paths on four cards

The default run, in this order:

6. the card-only tests (``pytest -m gpu``), in a child process that ends
   before this process first touches the card;
1. the ITER-like machine config at 129^2: float64 on the GPU against the
   same program on the CPU, and float32 against float64;
2. the 513^2 FMG cascade of the benchmark config, the same comparisons;
3. the 129^2 float64 free-boundary forward, alone (against the CPU) and
   as a B=16 batch with coil currents perturbed by 5% (each element
   against its standalone solve);
4. one 2049^2 float64 FMG solve gated on a GS residual below 3e-5;
5. nonlinear gyrokinetics at (32, 32, 32, 32, 16) in complex128: two
   steps against the CPU, then eight more.

The CPU reference runs under ``jax.default_matmul_precision("highest")``.
Phase 1 also runs its float32 solve with TF32 forced as the default
matmul precision; it must not move.

``--multichip`` runs only the cross-device paths of
``__graft_entry__.multichip_checks`` over four cards, each against the
single-device solve.

Prints the card's name and power limit first, then one line per check
(converged, iterations, deviation beside its tolerance, the phase's
compile seconds and the device's peak bytes in use), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, without that line, when a check fails, when there is no
GPU, or when the package is not beside this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ITER_CONFIG = ROOT / "validation" / "configs" / "iter_config.json"

# float32 against float64, span-relative: on an H100 the converged float32
# solves land 1.4e-5 (513^2 FMG) to 5.3e-5 (ITER 129^2) from float64, and
# the gate sits at twice the larger.  Forced TF32 landed inside it too
# (3.3e-5 at 513^2): the TF32 gates are F32_PRECISION_TOL and the
# Anderson-mix test among the card-only tests.
F32_TOL = 1e-4
# The float32 ITER solve with TF32 forced as the default matmul precision
# against the same solve at the default, span-relative.  The Anderson
# contractions are pinned to full precision and the coil-flux contraction
# gave the same bits under TF32, so only float32 noise may separate them.
F32_PRECISION_TOL = 1e-6
# float64 on the GPU against float64 on the CPU, span-relative: only the
# order of reductions differs.
F64_TOL = 1e-9
GS_TOL_LARGE = 3e-5      # phase 4: float64 GS-residual RMS gate
GK_TOL = 1e-10           # phase 5: complex128 GK state, relative to max |f|


def span_dev(a, ref) -> float:
    """max |a - ref| over the span of ``ref``."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / (ref.max() - ref.min()))


def check(name: str, ok: bool, *, converged=None, iterations=None,
          dev=None, tol=None, note: str = "") -> dict:
    return {"check": name, "ok": bool(ok),
            "converged": None if converged is None else bool(converged),
            "iterations": iterations, "dev": dev, "tol": tol, "note": note}


def as_check(r: dict) -> dict:
    """A record of ``__graft_entry__.multichip_checks`` as a check."""
    return check(r["name"], r["ok"], converged=r["converged"],
                 iterations=r["iterations"], dev=r["dev"], tol=r["tol"])


def _iters(x):
    return int(np.asarray(x))


def on_cpu(fn):
    """Run ``fn`` on the CPU at matmul precision "highest" and bring its
    result to the host."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        return jax.device_get(fn())


def compare_f64(name: str, res, ref, tol_scale: float,
                its=None, its_ref=None) -> dict:
    """GPU float64 against CPU float64: the same iteration counts (one per
    cascade level, or the solve's own) and a deviation <= F64_TOL.  If
    reduction order moved a stopping iteration by one, the gate becomes
    the convergence-tolerance scale ``tol_scale`` and the record says so."""
    its = [_iters(res.iterations)] if its is None else its
    its_ref = [_iters(ref.iterations)] if its_ref is None else its_ref
    dev = span_dev(res.psi, ref.psi)
    if its == its_ref:
        return check(name, bool(res.converged) and dev <= F64_TOL,
                     converged=res.converged, iterations=its, dev=dev,
                     tol=F64_TOL)
    moved_by_one = all(abs(a - b) <= 1 for a, b in zip(its, its_ref))
    return check(name, bool(res.converged) and moved_by_one
                 and dev <= tol_scale, converged=res.converged,
                 iterations=its, dev=dev, tol=tol_scale,
                 note=f"stopping iteration moved by reduction order: "
                      f"cpu={its_ref}")


def iter_config(n: int | None = None):
    import scpn_fusion_tpu as sft

    cfg = sft.load_config(ITER_CONFIG)
    if n is not None:
        cfg = dataclasses.replace(cfg, grid_resolution=(n, n))
    return cfg


def phase_iter(n: int | None = None) -> list[dict]:
    """Phase 1: the committed ITER-like config (129^2 unless ``n``), and
    its float32 solve again with TF32 forced as the default precision."""
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.models.equilibrium import solve_equilibrium

    cfg = iter_config(n)
    r64 = solve_equilibrium(cfg, dtype=jnp.float64)
    ref = on_cpu(lambda: solve_equilibrium(cfg, dtype=jnp.float64))
    r32 = solve_equilibrium(cfg, dtype=jnp.float32)
    with jax.default_matmul_precision("tensorfloat32"):
        r_tf32 = solve_equilibrium(cfg, dtype=jnp.float32)
    dev_tf32 = span_dev(r_tf32.psi, r32.psi)
    return [
        compare_f64("iter_f64_gpu_vs_cpu", r64, ref,
                    10 * cfg.solver.convergence_threshold),
        check("iter_f32_vs_f64", bool(r32.converged)
              and span_dev(r32.psi, r64.psi) <= F32_TOL,
              converged=r32.converged, iterations=_iters(r32.iterations),
              dev=span_dev(r32.psi, r64.psi), tol=F32_TOL),
        check("iter_f32_forced_tf32", bool(r_tf32.converged)
              and dev_tf32 <= F32_PRECISION_TOL,
              converged=r_tf32.converged,
              iterations=_iters(r_tf32.iterations), dev=dev_tf32,
              tol=F32_PRECISION_TOL,
              note=f"against the default-precision float32 solve; "
                   f"{span_dev(r_tf32.psi, r64.psi):.3e} from float64"),
    ]


def phase_fmg(n: int = 513, min_coarse: int = 129) -> list[dict]:
    """Phase 2: the benchmark config's FMG cascade ending at ``n``^2
    (129^2 -> 257^2 -> 513^2, the levels ``bench.py`` runs)."""
    import jax.numpy as jnp

    from bench import bench_config
    from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
        solve_equilibrium_fmg,
    )

    cfg = bench_config(n)
    r64, info64 = solve_equilibrium_fmg(cfg, min_coarse=min_coarse,
                                        dtype=jnp.float64)
    ref, info_ref = on_cpu(lambda: solve_equilibrium_fmg(
        cfg, min_coarse=min_coarse, dtype=jnp.float64))
    r32, info32 = solve_equilibrium_fmg(cfg, min_coarse=min_coarse,
                                        dtype=jnp.float32)
    return [
        compare_f64("fmg_f64_gpu_vs_cpu", r64, ref,
                    10 * cfg.solver.convergence_threshold,
                    [d["iterations"] for d in info64],
                    [d["iterations"] for d in info_ref]),
        check("fmg_f32_vs_f64", all(d["converged"] for d in info32)
              and span_dev(r32.psi, r64.psi) <= F32_TOL,
              converged=r32.converged, iterations=_iters(r32.iterations),
              dev=span_dev(r32.psi, r64.psi), tol=F32_TOL,
              note=f"level iterations={[d['iterations'] for d in info32]}"),
    ]


def phase_free_boundary(n: int = 129, batch: int = 16) -> list[dict]:
    """Phase 3: the float64 free-boundary forward and a batched ensemble."""
    import jax.numpy as jnp

    from bench import bench_config
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.free_boundary import (
        solve_free_boundary,
    )
    from scpn_fusion_tpu.parallel.ensemble import solve_equilibrium_batch

    cfg = bench_config(n)
    f64 = jnp.float64

    def forward():
        return solve_free_boundary(cfg, max_outer_iter=16, tol=1e-4,
                                   mu0_green=1.0, dtype=f64)

    fb = forward()
    fb_ref = on_cpu(forward)
    it, it_ref = _iters(fb.outer_iterations), _iters(fb_ref.outer_iterations)
    dev = span_dev(fb.psi, fb_ref.psi)
    out = [check("free_boundary_f64_gpu_vs_cpu",
                 bool(fb.converged) and it == it_ref and dev <= F64_TOL,
                 converged=fb.converged, iterations=it, dev=dev, tol=F64_TOL,
                 note=f"outer iterations cpu={it_ref}")]

    grid = Grid.from_config(cfg, dtype=np.float64)
    base = jnp.asarray([c.current for c in cfg.coils], f64)
    rng = np.random.default_rng(5)
    currents = base[None, :] * (1.0 + 0.05 * jnp.asarray(
        rng.standard_normal((batch, base.shape[0])), f64))
    targets = jnp.full((batch,), cfg.physics.plasma_current_target, f64)
    psi_b, conv_b, it_b = solve_equilibrium_batch(cfg, grid, currents,
                                                  targets)
    psi_b, conv_b, it_b = (np.asarray(psi_b), np.asarray(conv_b),
                           np.asarray(it_b))
    devs, same_iters = [], True
    for i in range(batch):
        psi_1, _, it_1 = solve_equilibrium_batch(
            cfg, grid, currents[i:i + 1], targets[i:i + 1])
        devs.append(span_dev(psi_b[i], np.asarray(psi_1)[0]))
        same_iters &= int(np.asarray(it_1)[0]) == int(it_b[i])
    out.append(check(
        f"batch{batch}_element_vs_standalone",
        bool(conv_b.all()) and same_iters and max(devs) <= F64_TOL,
        converged=conv_b.all(), iterations=[int(x) for x in it_b],
        dev=max(devs), tol=F64_TOL,
        note=f"iterations identical to standalone: {same_iters}"))
    return out


def phase_large(n: int = 2049, min_coarse: int = 129) -> list[dict]:
    """Phase 4: one large float64 FMG solve, gated on the GS residual.
    Its 129^2-513^2 levels are the same programs as phase 2's float64
    cascade, so only the 1025^2 and 2049^2 levels compile anew."""
    import jax.numpy as jnp

    from bench import bench_config
    from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
        solve_equilibrium_fmg,
    )

    cfg = bench_config(n)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, gs_residual_threshold=GS_TOL_LARGE))
    res, info = solve_equilibrium_fmg(cfg, min_coarse=min_coarse,
                                      dtype=jnp.float64)
    # The solver's own gate: the in-loop GS residual of the last iterate.
    # The post-loop residual, recomputed with the source of the returned
    # flux, carries one more Picard lag and is reported beside it.
    hist = np.asarray(res.gs_residual_history)
    gs = float(hist[_iters(res.iterations) - 1])
    return [check(f"fmg_{n}_f64_gs_residual",
                  bool(res.converged) and gs < GS_TOL_LARGE,
                  converged=res.converged, iterations=_iters(res.iterations),
                  dev=gs, tol=GS_TOL_LARGE,
                  note=f"post-loop residual {float(res.gs_residual):.3e}; "
                       f"level iterations={[d['iterations'] for d in info]}")]


def phase_gk(dims=(32, 32, 32, 32, 16), calls: int = 5) -> list[dict]:
    """Phase 5: nonlinear gyrokinetics in a complex128 state: two steps
    against the CPU, then ``calls`` - 1 more calls of the same two-step
    program, each continuing from the last state."""
    from scpn_fusion_tpu.models.gyrokinetics.nonlinear import (
        NonlinearGKConfig, run_nonlinear_gk,
    )

    n_kx, n_ky, n_theta, n_vpar, n_mu = dims
    cfg = NonlinearGKConfig(
        n_kx=n_kx, n_ky=n_ky, n_theta=n_theta, n_vpar=n_vpar, n_mu=n_mu,
        n_steps=2, save_interval=1, dtype="complex128")

    state, _ = run_nonlinear_gk(cfg, seed=7)
    ref, _ = on_cpu(lambda: run_nonlinear_gk(cfg, seed=7))
    f2, f_ref = np.asarray(state.f), np.asarray(ref.f)
    dev = float(np.max(np.abs(f2 - f_ref)) / np.max(np.abs(f_ref)))
    for _ in range(calls - 1):
        state, _ = run_nonlinear_gk(cfg, state=state)
    f_long = np.asarray(state.f)
    steps = 2 * calls
    return [
        check("gk_2_steps_gpu_vs_cpu", dev <= GK_TOL, iterations=2,
              dev=dev, tol=GK_TOL),
        check(f"gk_{steps}_steps_finite", bool(np.all(np.isfinite(f_long))),
              iterations=steps, note=f"state {f_long.shape} {f_long.dtype}"),
    ]


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, summed from its
    monitoring events."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def run_phase(name: str, fn, clock: CompileClock) -> bool:
    """Run one phase, print one line per check; a raised error fails it."""
    c0, t0 = clock.total, time.perf_counter()
    try:
        records = fn()
    except Exception as exc:  # noqa: BLE001 — reported, and fails the run
        traceback.print_exc()
        records = [check(name, False, note=f"raised {exc!r}")]
    compile_s = clock.total - c0
    wall_s = time.perf_counter() - t0
    peak = peak_bytes()
    for r in records:
        print(f"[{name}] " + json.dumps(
            {**r, "compile_s": round(compile_s, 2), "wall_s": round(wall_s, 2),
             "peak_bytes": peak}, default=str), flush=True)
    return all(r["ok"] for r in records)


def card_lines() -> list[str]:
    """``nvidia-smi``'s name and power limit of each card; raises when
    there is no card to query."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi lists no GPU")
    return lines


def card_tests() -> bool:
    """Phase 6: the ``gpu``-marked tests, in a child that holds the card
    alone while this process stays off JAX."""
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    t0 = time.perf_counter()
    # The card-only tests live in one file.  Collecting the others would
    # fail where another installed package owns the top-level name
    # ``tests`` (they import each other as ``tests.<module>``).
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rs",
         "-p", "no:cacheprovider", "tests/test_gpu_card.py"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    tail = (proc.stdout.strip().splitlines() or [""])[-1]
    ok = (proc.returncode == 0 and "passed" in tail
          and "skipped" not in tail)
    print("[card_tests] " + json.dumps({
        "check": "pytest -m gpu", "ok": ok, "rc": proc.returncode,
        "summary": tail, "wall_s": round(time.perf_counter() - t0, 2)}),
        flush=True)
    if not ok:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n",
              file=sys.stderr)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the cross-device paths, on four cards")
    args = ap.parse_args(argv)

    if importlib.util.find_spec("scpn_fusion_tpu") is None:
        print("chip_smoke: the scpn_fusion_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    try:
        cards = card_lines()
    except (OSError, subprocess.SubprocessError, RuntimeError) as exc:
        print(f"chip_smoke: no GPU to query: {exc!r}", file=sys.stderr)
        return 2
    for line in cards:
        print(f"card: {line}", flush=True)

    ok = True
    if not args.multichip:
        ok &= card_tests()

    import jax

    jax.config.update("jax_enable_x64", True)
    from scpn_fusion_tpu.core import backend

    try:
        device = backend.require_gpu(4 if args.multichip else 1)
    except RuntimeError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    backend.enable_compile_cache()
    print(f"device: {json.dumps(device.as_dict())}", flush=True)
    clock = CompileClock()

    if args.multichip:
        import __graft_entry__ as graft
        from bench import bench_config

        # The configs of phases 1, 3 and 5, so the single-device
        # references are the programs the default run compiles.  One line
        # per check as it ends, so a run cut short shows how far it got.
        for run in graft.multichip_checks(4, iter_config(), bench_config(129),
                                          gk_dims=(32, 32, 32, 32, 16)):
            print(f"[multichip] start {run.__name__}", flush=True)
            ok &= run_phase("multichip", lambda run=run: [as_check(run())],
                            clock)
    else:
        for name, fn in (("iter_129", phase_iter),
                         ("fmg_513", phase_fmg),
                         ("free_boundary_129", phase_free_boundary),
                         ("fmg_2049", phase_large),
                         ("gk_nonlinear", phase_gk)):
            ok &= run_phase(name, fn, clock)

    if not ok:
        print("chip_smoke: a check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device.as_dict()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
