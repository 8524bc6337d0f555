"""Vacuum (external coil) poloidal flux via toroidal Green's functions.

accelerator-first design: instead of looping over coils on the host
(reference ``fusion_kernel.py:218-251``, ``fusion_kernel_free_boundary.py:83``),
all coils are evaluated at once — ``vmap`` over the coil axis, summed on
device.  For repeated solves with changing currents, ``coil_response_table``
precomputes the per-coil grid response G[c, z, r] once per geometry so the
vacuum field for new currents is a single tensor contraction (one matmul),
which is also the differentiable path for coil-current optimisation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.config import ReactorConfig
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.core.special import green_coil_psi


def coil_response_table(
    grid: Grid,
    coil_r: jnp.ndarray,
    coil_z: jnp.ndarray,
    mu0: float,
) -> jnp.ndarray:
    """Per-coil unit-current flux response on the full grid.

    Returns ``G`` of shape ``(n_coils, NZ, NR)`` with
    ``psi_vac = einsum('c,czr->zr', I_eff, G)``.
    """
    rr, zz = grid.RR, grid.ZZ

    def one_coil(rc, zc):
        return green_coil_psi(rc, zc, rr, zz, mu0)

    return jax.vmap(one_coil)(coil_r, coil_z)


def vacuum_psi_from_table(table: jnp.ndarray, currents_eff: jnp.ndarray) -> jnp.ndarray:
    """Vacuum flux as a contraction of the response table with effective
    (current * turns) coil currents — the hot differentiable path."""
    return jnp.einsum("c,czr->zr", currents_eff, table)


def vacuum_psi(
    grid: Grid,
    coil_r: jnp.ndarray,
    coil_z: jnp.ndarray,
    currents_eff: jnp.ndarray,
    mu0: float,
) -> jnp.ndarray:
    """Vacuum poloidal flux on the (NZ, NR) grid from an arbitrary coil set."""
    table = coil_response_table(grid, coil_r, coil_z, mu0)
    return vacuum_psi_from_table(table, currents_eff)


def coil_arrays_from_config(cfg: ReactorConfig, dtype=jnp.float32):
    """Split the static coil list into traced (r, z, I*turns) arrays.

    The dtype is canonicalized (f64 -> f32 when x64 is off) so a
    f64-described grid never triggers the silent-truncation warning when
    x64 is off.
    """
    from scpn_fusion_tpu.core.dtypes import canonical

    dtype = canonical(dtype)
    if not cfg.coils:
        z = jnp.zeros((0,), dtype)
        return z, z, z
    r = jnp.asarray([c.r for c in cfg.coils], dtype)
    z = jnp.asarray([c.z for c in cfg.coils], dtype)
    i_eff = jnp.asarray([c.current * c.turns for c in cfg.coils], dtype)
    return r, z, i_eff


def vacuum_psi_from_config(grid: Grid, cfg: ReactorConfig) -> jnp.ndarray:
    """Vacuum field for the config's coil set (zero if no coils).

    Note: the reference's *fixed-boundary* kernel defaults
    ``physics.vacuum_permeability`` to 1.0 when computing the vacuum field
    (``fusion_kernel.py:230``); we use the configured value for consistency.
    """
    if not cfg.coils:
        return grid.zeros()
    mu0 = float(cfg.physics.vacuum_permeability)
    r, z, i_eff = coil_arrays_from_config(cfg, grid.dtype)
    return vacuum_psi(grid, r, z, i_eff, mu0)
