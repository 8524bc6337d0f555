#!/usr/bin/env python
"""Example 4 — Distributed equilibrium solve on a device mesh.

Runs the full Anderson-accelerated multigrid-Picard Grad-Shafranov solve
with the elliptic inner solve Z-slab-sharded over a 4-device
``jax.sharding.Mesh`` (halo exchange via ``lax.ppermute`` inside
``shard_map``, replicated multigrid coarse levels), and checks span-rel
parity against the single-device solve.  On a 4-GPU host the same program
runs over NVLink; here it uses 4 virtual CPU devices so the example runs
anywhere (reference counterpart: ``mpi_domain.rs: distributed_gs_solve``).

Run:  python examples/04_sharded_mesh_solve.py
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp                        # noqa: E402
import numpy as np                             # noqa: E402

from scpn_fusion_tpu.core.config import (      # noqa: E402
    Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
)
from scpn_fusion_tpu.models.equilibrium import solve_equilibrium  # noqa: E402
from scpn_fusion_tpu.parallel.halo import make_z_mesh             # noqa: E402
from scpn_fusion_tpu.parallel.sharded_solve import (              # noqa: E402
    solve_equilibrium_sharded,
)


def main() -> None:
    cfg = ReactorConfig(
        reactor_name="example-sharded",
        grid_resolution=(129, 129),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=(
            Coil(r=3.5, z=4.8, current=-1.0), Coil(r=8.0, z=4.8, current=4.0),
            Coil(r=10.8, z=0.0, current=6.0), Coil(r=8.0, z=-4.8, current=4.0),
            Coil(r=3.5, z=-4.8, current=-1.0), Coil(r=10.8, z=2.5, current=3.0),
        ),
        physics=PhysicsParams(plasma_current_target=15.0,
                              vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=600, convergence_threshold=1e-4,
                            relaxation_factor=0.8, solver_method="anderson_mg",
                            anderson_depth=4, inner_sweeps=1),
    )

    ref = solve_equilibrium(cfg, dtype=jnp.float64)
    print(f"single device : converged={bool(ref.converged)} in "
          f"{int(ref.iterations)} iterations")

    for n_dev in (2, 4):
        mesh = make_z_mesh(n_dev)
        res = solve_equilibrium_sharded(cfg, mesh, dtype=jnp.float64)
        span = float(jnp.max(ref.psi) - jnp.min(ref.psi))
        dev = float(jnp.max(jnp.abs(res.psi - ref.psi))) / span
        print(f"{n_dev}-device mesh: converged={bool(res.converged)} in "
              f"{int(res.iterations)} iterations, span-rel dev vs single "
              f"device {dev:.2e}")
        assert bool(res.converged) and dev < 1e-10

    print("OK: the mesh-sharded solve CONVERGES with bitwise-class parity")


if __name__ == "__main__":
    main()
