"""Grad-Shafranov elliptic (GS*) stencil operations, XLA-native.

The GS* operator in cylindrical (R, Z) coordinates is

    Delta* psi = d2psi/dR2 - (1/R) dpsi/dR + d2psi/dZ2

discretised with central differences on a uniform (Z, R) grid, giving the
five-point stencil with R-dependent east/west coefficients

    a_E = 1/dR^2 - 1/(2 R dR),   a_W = 1/dR^2 + 1/(2 R dR),
    a_NS = 1/dZ^2,               a_C = 2/dR^2 + 2/dZ^2,

matching the reference's Jacobi/SOR sub-solvers
(``fusion_kernel_iterative_solver.py:54-161``) and multigrid free functions
(``multigrid_solve.py``).  The solved equation is ``Delta* psi = S`` with
``S = -mu0 R J_phi`` and Dirichlet boundaries.

Everything here is a pure function of arrays + static floats: safe under
``jit``/``vmap``/``grad``/``shard_map``.  Sweep loops use ``lax.fori_loop`` so
an arbitrary sweep count compiles to one on-device loop; this
module is the portable reference implementation and the autodiff path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NUMERIC_CAP = 1e12  # matches the reference's numeric sanitize cap semantics


def stencil_coeffs(r_1d: jnp.ndarray, d_r: float, d_z: float):
    """Return (a_E, a_W, a_NS, a_C) for the toroidal 5-point stencil.

    ``a_E``/``a_W`` are 1D over R (broadcast over Z rows); ``a_NS``/``a_C``
    are scalars.
    """
    r_safe = jnp.maximum(r_1d, 1e-10)
    inv_dr2 = 1.0 / (d_r * d_r)
    a_e = inv_dr2 - 1.0 / (2.0 * r_safe * d_r)
    a_w = inv_dr2 + 1.0 / (2.0 * r_safe * d_r)
    a_ns = 1.0 / (d_z * d_z)
    a_c = 2.0 * inv_dr2 + 2.0 / (d_z * d_z)
    return a_e, a_w, a_ns, a_c


def gs_operator(psi: jnp.ndarray, r_1d: jnp.ndarray, d_r: float, d_z: float) -> jnp.ndarray:
    """Apply the discrete GS* operator on interior points (edges -> 0).

    Returns an array of the same shape with L[psi] on the interior and zeros
    on the boundary ring.
    """
    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    interior = (
        a_e[None, :] * psi[1:-1, 2:]
        + a_w[None, :] * psi[1:-1, :-2]
        + a_ns * (psi[:-2, 1:-1] + psi[2:, 1:-1])
        - a_c * psi[1:-1, 1:-1]
    )
    out = jnp.zeros_like(psi)
    return out.at[1:-1, 1:-1].set(interior)


def gs_residual(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
) -> jnp.ndarray:
    """Residual r = S - L[psi] on interior points (zero on boundary)."""
    lap = gs_operator(psi, r_1d, d_r, d_z)
    res = source - lap
    return res.at[0, :].set(0.0).at[-1, :].set(0.0).at[:, 0].set(0.0).at[:, -1].set(0.0)


def gs_residual_rms(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
) -> jnp.ndarray:
    """RMS of the interior GS residual (convergence diagnostic)."""
    res = gs_residual(psi, source, r_1d, d_r, d_z)
    n_int = (psi.shape[0] - 2) * (psi.shape[1] - 2)
    return jnp.sqrt(jnp.sum(res * res) / n_int)


def apply_dirichlet(psi: jnp.ndarray, psi_bc: jnp.ndarray) -> jnp.ndarray:
    """Copy boundary-ring values of ``psi_bc`` onto ``psi`` (pure version of
    the reference's in-place ``_apply_boundary_conditions``)."""
    return (
        psi.at[0, :].set(psi_bc[0, :])
        .at[-1, :].set(psi_bc[-1, :])
        .at[:, 0].set(psi_bc[:, 0])
        .at[:, -1].set(psi_bc[:, -1])
    )


def jacobi_step(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
) -> jnp.ndarray:
    """One damped-free Jacobi iteration (boundaries unchanged)."""
    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    new_interior = (
        a_e[None, :] * psi[1:-1, 2:]
        + a_w[None, :] * psi[1:-1, :-2]
        + a_ns * (psi[:-2, 1:-1] + psi[2:, 1:-1])
        - source[1:-1, 1:-1]
    ) / a_c
    new_interior = jnp.clip(new_interior, -NUMERIC_CAP, NUMERIC_CAP)
    return psi.at[1:-1, 1:-1].set(new_interior)


def _interior_parity_mask(shape: tuple[int, int], parity: int, dtype) -> jnp.ndarray:
    """Checkerboard mask over interior global indices (iz + ir) % 2 == parity."""
    nz, nr = shape
    iz = jax.lax.broadcasted_iota(jnp.int32, (nz - 2, nr - 2), 0) + 1
    ir = jax.lax.broadcasted_iota(jnp.int32, (nz - 2, nr - 2), 1) + 1
    return ((iz + ir) % 2 == parity).astype(dtype)


def sor_step(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
    omega: float = 1.6,
) -> jnp.ndarray:
    """One full red-black SOR sweep (two half-sweeps) with the toroidal stencil.

    True Gauss-Seidel ordering: the black half-sweep sees the updated red
    points, matching the reference's convergence behaviour
    (``fusion_kernel_iterative_solver.py:97-161``) — not Jacobi-in-disguise.
    """
    a_e, a_w, a_ns, a_c = stencil_coeffs(r_1d[1:-1], d_r, d_z)

    def half_sweep(p: jnp.ndarray, parity: int) -> jnp.ndarray:
        gs = (
            a_e[None, :] * p[1:-1, 2:]
            + a_w[None, :] * p[1:-1, :-2]
            + a_ns * (p[:-2, 1:-1] + p[2:, 1:-1])
            - source[1:-1, 1:-1]
        ) / a_c
        old = p[1:-1, 1:-1]
        mask = _interior_parity_mask(p.shape, parity, p.dtype)
        updated = old + mask * omega * (gs - old)
        updated = jnp.clip(updated, -NUMERIC_CAP, NUMERIC_CAP)
        return p.at[1:-1, 1:-1].set(updated)

    psi = half_sweep(psi, 0)  # red
    psi = half_sweep(psi, 1)  # black
    return psi


@partial(jax.jit, static_argnames=("d_r", "d_z", "omega", "n_sweeps"))
def sor_sweeps(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
    omega: float,
    n_sweeps: int,
) -> jnp.ndarray:
    """``n_sweeps`` red-black SOR sweeps as one on-device loop."""
    def body(_, p):
        return sor_step(p, source, r_1d, d_r, d_z, omega)
    return jax.lax.fori_loop(0, n_sweeps, body, psi)


def jacobi_sweeps(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
    n_sweeps: int,
) -> jnp.ndarray:
    """``n_sweeps`` Jacobi iterations as one on-device loop."""
    def body(_, p):
        return jacobi_step(p, source, r_1d, d_r, d_z)
    return jax.lax.fori_loop(0, n_sweeps, body, psi)
