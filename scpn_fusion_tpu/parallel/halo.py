"""Spatial domain decomposition over the device mesh: Z-slab halo exchange.

JAX-native replacement for the reference's MPI-shaped (but serially executed)
decomposition layer (``fusion-core/src/mpi_domain.rs:48-1367``: ``decompose_z``,
``pack_halo_rows``/``apply_halo_rows``, ``serial_halo_exchange``,
``distributed_gs_solve``): here the psi grid is sharded across a
``jax.sharding.Mesh`` axis and halo rows move over ICI via ``lax.ppermute``
inside ``shard_map``.  Reductions (residual norms, convergence flags) are
``lax.psum`` collectives, replacing ``mpi_domain.rs``'s ``l2_norm_delta`` /
``gs_residual_l2``.

The red-black sweep keeps *global* checkerboard parity: each shard computes
its global row offset from ``lax.axis_index``, so the distributed sweep is
numerically identical to the single-device sweep (the reference pins the same
invariant: tile-run == monolithic-run to 1e-12,
``gk_domain_decomposition.py`` / ``test_gk_domain_decomposition.py:145``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scpn_fusion_tpu.ops.stencil import stencil_coeffs


def make_z_mesh(n_devices: int | None = None, axis: str = "z") -> Mesh:
    """1D device mesh over the Z (slab) axis.

    Raises (rather than silently truncating) when the backend exposes fewer
    devices than requested — a 1-chip backend cannot host an 8-way slab mesh
    (ADVICE.md r1 high).
    """
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if len(devs) < n:
        raise RuntimeError(
            f"make_z_mesh: requested {n} devices, backend has {len(devs)} "
            f"({devs[0].platform}); force the CPU host platform with "
            "--xla_force_host_platform_device_count before first JAX use"
        )
    return Mesh(np.array(devs[:n]), (axis,))


def _halo_exchange(psi_local: jnp.ndarray, axis: str, n_shards: int):
    """Exchange one halo row with each Z neighbour via ppermute.

    Returns (top_halo, bot_halo) rows of shape (NR,).  Edge shards receive
    zeros, which is harmless: the global boundary rows are Dirichlet-frozen
    and never read their outer halo.
    """
    down = [(i, i + 1) for i in range(n_shards - 1)]   # my last row -> lower neighbour's top halo
    up = [(i + 1, i) for i in range(n_shards - 1)]     # my first row -> upper neighbour's bottom halo
    top_halo = jax.lax.ppermute(psi_local[-1, :], axis, down)
    bot_halo = jax.lax.ppermute(psi_local[0, :], axis, up)
    return top_halo, bot_halo


def _local_half_sweep(
    psi_pad: jnp.ndarray,
    source_local: jnp.ndarray,
    a_e: jnp.ndarray,
    a_w: jnp.ndarray,
    a_ns: float,
    a_c: float,
    omega,
    parity: int,
    row_offset: jnp.ndarray,
    nz_total: int,
):
    """One red/black half-sweep on a halo-padded local slab.

    ``psi_pad`` has shape (L+2, NR): one halo row above and below the local
    block.  Returns the updated local block (L, NR).
    """
    local = psi_pad[1:-1, :]
    nr = local.shape[1]
    l_rows = local.shape[0]

    gs = (
        a_e[None, :] * psi_pad[1:-1, 2:]
        + a_w[None, :] * psi_pad[1:-1, :-2]
        + a_ns * (psi_pad[:-2, 1:-1] + psi_pad[2:, 1:-1])
        - source_local[:, 1:-1]
    ) / a_c

    iz_local = jax.lax.broadcasted_iota(jnp.int32, (l_rows, nr - 2), 0)
    ir = jax.lax.broadcasted_iota(jnp.int32, (l_rows, nr - 2), 1) + 1
    iz_global = iz_local + row_offset
    par_ok = ((iz_global + ir) % 2) == parity
    interior = (iz_global >= 1) & (iz_global <= nz_total - 2)
    mask = (par_ok & interior).astype(local.dtype)

    old = local[:, 1:-1]
    updated = old + mask * omega * (gs - old)
    return local.at[:, 1:-1].set(updated)


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "d_r", "d_z", "n_sweeps", "nz_total"),
)
def sharded_sor_solve(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    omega: jnp.ndarray,
    *,
    mesh: Mesh,
    axis: str,
    d_r: float,
    d_z: float,
    n_sweeps: int,
    nz_total: int,
):
    """Distributed red-black SOR: Z-slab sharded sweeps with halo exchange.

    Parameters
    ----------
    psi, source : (NZ, NR) arrays — will be sharded along Z over ``mesh``.
    r_1d : (NR,) replicated R coordinates.
    n_sweeps : sweeps to run entirely on-device (2 halo exchanges per sweep).

    Returns
    -------
    (psi_out, res_l2) — the solved field (same sharding) and the global L2
    update norm of the last sweep (replicated scalar, via ``psum``).
    """
    n_shards = mesh.shape[axis]
    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    # Pad coefficient arrays back to full NR for easy slicing inside shards.
    a_e_f = jnp.zeros_like(r_1d).at[1:-1].set(a_e)
    a_w_f = jnp.zeros_like(r_1d).at[1:-1].set(a_w)

    def shard_fn(psi_l, src_l, a_e_l, a_w_l, omega_l):
        my = jax.lax.axis_index(axis)
        l_rows = psi_l.shape[0]
        row_offset = my * l_rows

        def one_sweep(i, carry):
            p, _ = carry
            prev = p

            def half(p_in, parity):
                top, bot = _halo_exchange(p_in, axis, n_shards)
                p_pad = jnp.concatenate([top[None, :], p_in, bot[None, :]], axis=0)
                return _local_half_sweep(
                    p_pad, src_l, a_e_l[1:-1], a_w_l[1:-1], a_ns, a_c,
                    omega_l, parity, row_offset, nz_total)

            p = half(p, 0)
            p = half(p, 1)
            d_local = jnp.sum((p - prev) ** 2)
            d_global = jax.lax.psum(d_local, axis)
            return p, jnp.sqrt(d_global)

        psi_out, res = jax.lax.fori_loop(
            0, n_sweeps, one_sweep, (psi_l, jnp.asarray(0.0, psi_l.dtype)))
        return psi_out, res

    spec_grid = P(axis, None)
    spec_rep = P()
    from jax import shard_map

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec_grid, spec_grid, spec_rep, spec_rep, spec_rep),
        out_specs=(spec_grid, spec_rep),
    )
    psi_s = jax.device_put(psi, NamedSharding(mesh, spec_grid))
    src_s = jax.device_put(source, NamedSharding(mesh, spec_grid))
    return fn(psi_s, src_s, a_e_f, a_w_f, omega)
