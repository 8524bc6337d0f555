"""Geometric multigrid for the GS* operator, XLA-native.

Compiled re-design of the reference's recursive NumPy V-cycle
(``core/multigrid_solve.py:57-335``): the level hierarchy is *unrolled at
trace time* (all shapes static), so one ``jit`` of ``vcycle`` compiles the
entire V-cycle — restriction, coarse solves, prolongation, smoothing — into a
single on-device XLA program with no host involvement.  Grid sizes follow the
reference's coarsening rule ``n_c = (n_f + 1) // 2`` (exact for 2^k + 1
grids) and the same full-weighting / bilinear transfer stencils, red-black
Gauss-Seidel smoother (omega = 1.0 by default: over-relaxation smooths
poorly), and sign convention: the coarse-grid right-hand side is
``source - L[psi]`` so the correction is *added*.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.ops.stencil import gs_residual, sor_step


def _downsample_even(x: jnp.ndarray, nz_c: int, nr_c: int) -> jnp.ndarray:
    """x[2i, 2j] as pad to even extent + reshape + plain index: the even
    entries land on a non-strided index, so XLA emits one fused copy."""
    pad_z = 2 * nz_c - x.shape[0]
    pad_r = 2 * nr_c - x.shape[1]
    xp = jnp.pad(x, ((0, pad_z), (0, pad_r)))
    return xp.reshape(nz_c, 2, nr_c, 2)[:, 0, :, 0]


def restrict_full_weight(fine: jnp.ndarray) -> jnp.ndarray:
    """Full-weighting restriction (fine -> coarse, 9-point stencil).

    Boundary rows/columns are injected directly.  Coarse shape is
    ``((nz+1)//2, (nr+1)//2)``.  Implemented as a 3x3 weighted sum via
    shifted slices followed by even-point downsampling — no strided memory
    ops (see ``_downsample_even``).
    """
    nz_f, nr_f = fine.shape
    nz_c, nr_c = (nz_f + 1) // 2, (nr_f + 1) // 2

    # 9-point full weighting of the interior, evaluated everywhere via pad.
    fp = jnp.pad(fine, 1)
    c = fp[1:-1, 1:-1]
    n_ = fp[2:, 1:-1]
    s_ = fp[:-2, 1:-1]
    e_ = fp[1:-1, 2:]
    w_ = fp[1:-1, :-2]
    ne = fp[2:, 2:]
    nw = fp[2:, :-2]
    se = fp[:-2, 2:]
    sw = fp[:-2, :-2]
    weighted = (4.0 * c + 2.0 * (n_ + s_ + e_ + w_) + (ne + nw + se + sw)) / 16.0

    c_int = _downsample_even(weighted, nz_c, nr_c)
    c_inj = _downsample_even(fine, nz_c, nr_c)

    # Boundary ring: direct injection; interior: full weighting.
    iz = jax.lax.broadcasted_iota(jnp.int32, (nz_c, nr_c), 0)
    ir = jax.lax.broadcasted_iota(jnp.int32, (nz_c, nr_c), 1)
    ring = (iz == 0) | (iz == nz_c - 1) | (ir == 0) | (ir == nr_c - 1)
    return jnp.where(ring, c_inj, c_int)


def prolongate_bilinear(coarse: jnp.ndarray, nz_f: int, nr_f: int) -> jnp.ndarray:
    """Bilinear prolongation (coarse -> fine) for 2^k+1-compatible grids.

    Interleaves the four phase planes (coincident / horizontal-mid /
    vertical-mid / centre) via stack+reshape instead of strided scatter.
    """
    c = coarse
    c_r = jnp.pad(c[:, 1:], ((0, 0), (0, 1)))      # right neighbour (zero past edge)
    c_d = jnp.pad(c[1:, :], ((0, 1), (0, 0)))      # down neighbour
    c_dr = jnp.pad(c[1:, 1:], ((0, 1), (0, 1)))    # down-right

    p00 = c
    p01 = 0.5 * (c + c_r)
    p10 = 0.5 * (c + c_d)
    p11 = 0.25 * (c + c_r + c_d + c_dr)

    # (kc, 2, kc, 2) -> (2kc, 2kc): [..., 0, ..., 0] = p00 etc.
    row0 = jnp.stack([p00, p01], axis=-1)          # (kc, kc, 2)
    row1 = jnp.stack([p10, p11], axis=-1)
    t = jnp.stack([row0, row1], axis=1)            # (kc, 2, kc, 2)
    fine_full = t.reshape(2 * c.shape[0], 2 * c.shape[1])
    return fine_full[:nz_f, :nr_f]


def smooth(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
    omega: float,
    n_sweeps: int,
) -> jnp.ndarray:
    """Red-black SOR smoother: ``n_sweeps`` full sweeps."""
    for _ in range(n_sweeps):
        psi = sor_step(psi, source, r_1d, d_r, d_z, omega)
    return psi


def _vcycle_impl(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
    omega: float,
    pre_smooth: int,
    post_smooth: int,
    min_grid: int,
    coarse_sweeps: int,
) -> jnp.ndarray:
    nz, nr = psi.shape
    if min_grid >= nz or min_grid >= nr:
        # Coarsest level: "direct" solve by many smoothing sweeps.
        return smooth(psi, source, r_1d, d_r, d_z, omega, coarse_sweeps)

    psi = smooth(psi, source, r_1d, d_r, d_z, omega, pre_smooth)

    # Coarse-grid RHS: r = source - L[psi]  (the error equation L[e] = r).
    defect = gs_residual(psi, source, r_1d, d_r, d_z)
    d_coarse = restrict_full_weight(defect)
    r_coarse = r_1d[::2]

    e_coarse = _vcycle_impl(
        jnp.zeros_like(d_coarse), d_coarse, r_coarse,
        d_r * 2.0, d_z * 2.0, omega, pre_smooth, post_smooth,
        min_grid, coarse_sweeps,
    )

    psi = psi + prolongate_bilinear(e_coarse, nz, nr)
    return smooth(psi, source, r_1d, d_r, d_z, omega, post_smooth)


@partial(jax.jit, static_argnames=(
    "d_r", "d_z", "omega", "pre_smooth", "post_smooth", "min_grid",
    "coarse_sweeps"))
def vcycle(
    psi: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
    *,
    omega: float = 1.0,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    min_grid: int = 5,
    coarse_sweeps: int = 50,
) -> jnp.ndarray:
    """One geometric-multigrid V-cycle for ``Delta* psi = source``.

    Dirichlet boundary values of ``psi`` are preserved exactly: smoothing and
    corrections only touch interior points (the correction's boundary ring is
    zero because the defect is zero there).
    """
    return _vcycle_impl(psi, source, r_1d, d_r, d_z, omega,
                        pre_smooth, post_smooth, min_grid, coarse_sweeps)


def mg_solve(
    psi0: jnp.ndarray,
    source: jnp.ndarray,
    r_1d: jnp.ndarray,
    d_r: float,
    d_z: float,
    *,
    n_cycles: int = 20,
    omega: float = 1.0,
    pre_smooth: int = 3,
    post_smooth: int = 3,
    min_grid: int = 5,
) -> jnp.ndarray:
    """Run ``n_cycles`` V-cycles (standalone converged MG solve,
    reference ``multigrid_solve.py:352``)."""
    def body(_, p):
        return _vcycle_impl(p, source, r_1d, d_r, d_z, omega,
                            pre_smooth, post_smooth, min_grid, 50)
    return jax.lax.fori_loop(0, n_cycles, body, psi0)
