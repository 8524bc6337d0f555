"""2D Cartesian tile decomposition with halo exchange over a device mesh.

JAX-native equivalent of the reference's 2D tiling layer
(``fusion-core/src/mpi_domain.rs:380-739``: ``CartesianTile``,
``decompose_2d``, ``serial_halo_exchange_2d``, ``distributed_gs_solve`` with
``optimal_process_grid``): the psi grid is sharded over a 2D
``Mesh(("tz", "tr"))``; each red-black half-sweep exchanges one halo row with
the Z neighbours and one halo column with the R neighbours via
``lax.ppermute`` (4 collectives per half-sweep), and global reductions ride
``psum`` over both axes.  Checkerboard parity is computed from global
(row, col) offsets, so the distributed sweep is numerically identical to the
monolithic one — the reference's tile == monolithic invariant.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scpn_fusion_tpu.ops.stencil import stencil_coeffs


def optimal_process_grid(n_devices: int) -> tuple[int, int]:
    """Most-square factorisation pz x pr = n (reference
    ``optimal_process_grid``, ``mpi_domain.rs:1009``)."""
    best = (1, n_devices)
    for pz in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % pz == 0:
            best = (pz, n_devices // pz)
    return best


def make_2d_mesh(n_devices: int | None = None,
                 axes: tuple[str, str] = ("tz", "tr")) -> Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    pz, pr = optimal_process_grid(n)
    return Mesh(np.array(devs[:n]).reshape(pz, pr), axes)


@partial(
    jax.jit,
    static_argnames=("mesh", "d_r", "d_z", "n_sweeps", "nz_total", "nr_total"),
)
def sharded_sor_solve_2d(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    omega: jnp.ndarray,
    *,
    mesh: Mesh,
    d_r: float,
    d_z: float,
    n_sweeps: int,
    nz_total: int,
    nr_total: int,
):
    """Red-black SOR on a 2D-tiled grid; returns (psi, last-sweep L2 delta)."""
    az, ar = mesh.axis_names
    pz, pr = mesh.shape[az], mesh.shape[ar]
    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    a_e_f = jnp.zeros_like(r_1d).at[1:-1].set(a_e)
    a_w_f = jnp.zeros_like(r_1d).at[1:-1].set(a_w)

    def shard_fn(psi_l, src_l, a_e_l, a_w_l, omega_l):
        iz_t = jax.lax.axis_index(az)
        ir_t = jax.lax.axis_index(ar)
        lz, lr = psi_l.shape
        row_off = iz_t * lz
        col_off = ir_t * lr
        # Local slices of the R coefficients for this tile's columns.
        ae_tile = jax.lax.dynamic_slice(a_e_l, (col_off,), (lr,))
        aw_tile = jax.lax.dynamic_slice(a_w_l, (col_off,), (lr,))

        down = [(i, i + 1) for i in range(pz - 1)]
        up = [(i + 1, i) for i in range(pz - 1)]
        right = [(i, i + 1) for i in range(pr - 1)]
        left = [(i + 1, i) for i in range(pr - 1)]

        def pad_with_halos(p):
            top = jax.lax.ppermute(p[-1, :], az, down)
            bot = jax.lax.ppermute(p[0, :], az, up)
            p_z = jnp.concatenate([top[None, :], p, bot[None, :]], axis=0)
            lft = jax.lax.ppermute(p_z[:, -1], ar, right)
            rgt = jax.lax.ppermute(p_z[:, 0], ar, left)
            return jnp.concatenate([lft[:, None], p_z, rgt[:, None]], axis=1)

        def half(p, parity):
            pp = pad_with_halos(p)
            gs = (
                ae_tile[None, :] * pp[1:-1, 2:]
                + aw_tile[None, :] * pp[1:-1, :-2]
                + a_ns * (pp[:-2, 1:-1] + pp[2:, 1:-1])
                - src_l
            ) / a_c
            iz = jax.lax.broadcasted_iota(jnp.int32, (lz, lr), 0) + row_off
            ir = jax.lax.broadcasted_iota(jnp.int32, (lz, lr), 1) + col_off
            interior = ((iz >= 1) & (iz <= nz_total - 2)
                        & (ir >= 1) & (ir <= nr_total - 2))
            par_ok = ((iz + ir) % 2) == parity
            mask = (interior & par_ok).astype(p.dtype)
            return p + mask * omega_l * (gs - p)

        def sweep(i, carry):
            p, _ = carry
            prev = p
            p = half(p, 0)
            p = half(p, 1)
            d = jax.lax.psum(jnp.sum((p - prev) ** 2), az)
            d = jax.lax.psum(d, ar)
            return p, jnp.sqrt(d)

        return jax.lax.fori_loop(
            0, n_sweeps, sweep, (psi_l, jnp.asarray(0.0, psi_l.dtype)))

    spec_grid = P(az, ar)
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec_grid, spec_grid, P(), P(), P()),
        out_specs=(spec_grid, P()),
    )
    psi_s = jax.device_put(psi, NamedSharding(mesh, spec_grid))
    src_s = jax.device_put(source, NamedSharding(mesh, spec_grid))
    return fn(psi_s, src_s, a_e_f, a_w_f, omega)
