"""scpn_fusion_tpu — a JAX plasma-physics and control framework.

A from-scratch JAX/XLA rebuild of the capabilities of
``anulum/scpn-fusion-core`` (reference layer map in ``SURVEY.md``): the fixed-
and free-boundary Grad-Shafranov equilibrium solver, the 1.5D integrated
transport stepper, kinetic/MHD time-steppers, and the Petri-net -> SNN
neuro-symbolic controller — all designed accelerator-first:

* physics state is a pytree; solvers are pure functions under ``jax.jit``
* iteration happens in ``lax.while_loop`` / ``lax.scan`` on-device
  (no host round-trips inside the hot loop)
* elliptic stencil sweeps and multigrid transfers are plain ``jax.numpy``
  stencils that XLA fuses
* coil Green's functions are precomputed response matrices consumed as
  batched matmuls
* scale-out is ``jax.sharding`` + ``shard_map`` over a device mesh with
  ``ppermute`` halo exchange (replacing the reference's MPI-shaped
  ``mpi_domain.rs``)

The reference's Python/Rust/C++ architecture (mixins, subprocess CLI, ctypes
bridges, PyO3 bindings) is deliberately NOT ported; see SURVEY.md §7.
"""

__version__ = "0.1.0"

from scpn_fusion_tpu.core.config import (  # noqa: F401
    Coil,
    Dimensions,
    PhysicsParams,
    ProfileParams,
    ReactorConfig,
    SolverParams,
    load_config,
)
from scpn_fusion_tpu.core.grid import Grid  # noqa: F401
