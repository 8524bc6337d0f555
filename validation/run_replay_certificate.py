#!/usr/bin/env python
"""Deterministic replay certificate.

Counterpart of the reference's ``validation/replay_certificate.py``
(seeded episode -> component sha256 hashes -> combined hash,
double-run verified, committed certificate re-verified on every run).
Episodes span four subsystems, each a single compiled program:

* equilibrium  — 65^2 Solov'ev multigrid solve (x64), hash of psi
* phase        — 4-layer Kuramoto/UPDE monitor, 500 ticks, hash of the
                 global order-parameter trace
* control      — fault-tolerant closed-loop shot with two mid-shot coil
                 losses, hash of the error-norm trace
* transport    — 50 Aurora-parity finite-volume D+V steps, hash of the
                 final charge-state densities

Lanes (fail-closed):

1. double_run_determinism — all component hashes identical across two
   in-process runs with cleared jit caches.
2. committed_certificate_match — the combined hash equals the committed
   certificate (``validation/configs/replay_certificate.json``); a
   missing certificate is BLOCKED, not pass (run with --init once).
3. cross_process_replay — a fresh subprocess (different
   PYTHONHASHSEED) reproduces the combined hash bit-for-bit.

Writes checksummed JSON+MD evidence into validation/reports/.
"""

import hashlib
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

CERT_PATH = Path(__file__).resolve().parent / "configs" / \
    "replay_certificate.json"
SCHEMA = "scpn-fusion-tpu.replay-certificate.v1"


def _hash_array(values) -> str:
    canonical = np.ascontiguousarray(np.asarray(values, np.float64))
    return hashlib.sha256(canonical.tobytes()).hexdigest()


def run_episodes() -> dict:
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.control.fault_tolerant import (
        ACTUATOR_LOSS,
        run_fault_tolerant_shot,
    )
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.solovev import SolovevParams
    from scpn_fusion_tpu.models.phase.knm import KnmSpec
    from scpn_fusion_tpu.models.phase.monitor import init_monitor, run_monitor
    from scpn_fusion_tpu.models.transport.aurora_parity import (
        radial_transport_step,
    )
    from scpn_fusion_tpu.ops import multigrid as mg
    from scpn_fusion_tpu.ops.stencil import apply_dirichlet

    hashes = {}

    # Episode 1: equilibrium.
    params = SolovevParams()
    grid = Grid.from_bounds(65, 65, 3.0, 9.0, -3.0, 3.0, dtype=np.float64)
    psi_exact = params.psi(grid.RR, grid.ZZ)
    src = params.source(grid.RR)
    psi0 = apply_dirichlet(jnp.zeros_like(psi_exact), psi_exact)
    psi = mg.mg_solve(psi0, src, grid.R, grid.dR, grid.dZ, n_cycles=20)
    hashes["equilibrium_psi"] = _hash_array(psi)

    # Episode 2: phase monitor.
    k = 0.8 * np.ones((4, 4)) + 0.4 * np.eye(4)
    spec = KnmSpec(k=k)
    state, arrays = init_monitor(spec, n_per=32, seed=42)
    _, trace = run_monitor(state, arrays, n_ticks=500)
    hashes["phase_r_global"] = _hash_array(trace.r_global)

    # Episode 3: fault-tolerant control shot.
    rng = np.random.default_rng(7)
    jac = jnp.asarray(rng.standard_normal((4, 6)))
    target = jnp.asarray([1.0, -0.5, 0.3, 0.8])
    shot = run_fault_tolerant_shot(
        jac, target,
        fault_times=jnp.asarray([40, 70, -1]),
        fault_kinds=jnp.asarray([ACTUATOR_LOSS, ACTUATOR_LOSS, 0]),
        fault_indices=jnp.asarray([1, 4, -1]),
        n_steps=150)
    hashes["control_error_norm"] = _hash_array(shot.error_norm)

    # Episode 4: impurity transport march.
    nr, nz = 24, 5
    radius = jnp.asarray(np.linspace(0.05, 0.6, nr))
    prof = np.exp(-((np.linspace(0.05, 0.6, nr) - 0.3) / 0.08) ** 2)
    density = jnp.asarray(np.tile(prof[:, None], (1, nz))
                          * (1.0 + np.arange(nz)))
    d = jnp.ones((nr, nz)) * 1.0
    v = jnp.ones((nr, nz)) * -2.0
    out = density
    for _ in range(50):
        out = radial_transport_step(out, d, v, radius, 1e-4)
    hashes["transport_density"] = _hash_array(out)

    return hashes


def combined_hash(component_hashes: dict) -> str:
    canonical = json.dumps(component_hashes, sort_keys=True).encode()
    return hashlib.sha256(canonical).hexdigest()


def _configure_jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def main() -> int:
    _configure_jax()
    import jax

    from scpn_fusion_tpu.utils.evidence import LaneResult, write_report

    if "--emit-combined" in sys.argv:
        print(combined_hash(run_episodes()))
        return 0

    lanes = []

    # Cross-process replay with a different hash seed.  The child runs
    # first, while this process has not yet initialised a JAX backend, so
    # the two never hold a device at the same time.
    env = dict(os.environ, PYTHONHASHSEED="12345")
    proc = subprocess.run(
        [sys.executable, __file__, "--emit-combined"],
        capture_output=True, text=True, env=env, timeout=900)
    sub_hash = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""

    h1 = run_episodes()
    jax.clear_caches()
    h2 = run_episodes()
    identical = h1 == h2
    lanes.append(LaneResult(
        name="double_run_determinism",
        status="pass" if identical else "fail",
        metrics={"components": h1, "identical": identical},
        thresholds={},
        notes="component hashes across two in-process runs with cleared "
              "jit caches",
    ))

    comb = combined_hash(h1)
    if "--init" in sys.argv or not CERT_PATH.is_file():
        if "--init" in sys.argv:
            CERT_PATH.parent.mkdir(parents=True, exist_ok=True)
            CERT_PATH.write_text(json.dumps({
                "schema": SCHEMA,
                "combined_sha256": comb,
                "components": h1,
                "environment": {
                    "python": platform.python_version(),
                    "platform": platform.platform(),
                    "jax": jax.__version__,
                    "dtype_policy": "cpu x64 episodes",
                },
            }, indent=2) + "\n")
        lanes.append(LaneResult(
            name="committed_certificate_match",
            status="blocked" if "--init" not in sys.argv else "pass",
            metrics={"combined_sha256": comb,
                     "initialised": "--init" in sys.argv},
            notes=("certificate written; commit it so future runs verify"
                   if "--init" in sys.argv else
                   f"no committed certificate at {CERT_PATH}; "
                   "run with --init once"),
        ))
    else:
        cert = json.loads(CERT_PATH.read_text())
        match = cert.get("combined_sha256") == comb
        mismatched = [k for k, v in cert.get("components", {}).items()
                      if h1.get(k) != v]
        lanes.append(LaneResult(
            name="committed_certificate_match",
            status="pass" if match else "fail",
            metrics={"combined_sha256": comb,
                     "committed_sha256": cert.get("combined_sha256"),
                     "mismatched_components": mismatched},
            thresholds={},
            notes="combined hash vs the committed replay certificate",
        ))

    xp_ok = proc.returncode == 0 and sub_hash == comb
    lanes.append(LaneResult(
        name="cross_process_replay",
        status="pass" if xp_ok else "fail",
        metrics={"subprocess_hash": sub_hash, "parent_hash": comb,
                 "returncode": proc.returncode},
        thresholds={},
        notes="fresh interpreter, different PYTHONHASHSEED, run before "
              "the parent initialises JAX (one process on the device at a "
              "time), must reproduce the combined hash bit-for-bit",
    ))

    write_report("replay_certificate", lanes)
    return 0 if all(ln.status == "pass" for ln in lanes
                    if ln.status != "blocked") else 1


if __name__ == "__main__":
    sys.exit(main())
