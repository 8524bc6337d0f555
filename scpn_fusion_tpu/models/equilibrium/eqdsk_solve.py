"""GEQDSK-driven fixed-boundary equilibrium reconstruction.

The accuracy-parity lane of the framework (reference analogue:
``core/jax_free_boundary_gs.py`` general sampled-profile source +
``validation/benchmark_sparc_geqdsk_rmse.py`` / DIII-D full-domain forward
validation, RESULTS.md "Real-Shot Validation" psi RMS 1.91 %): given an EFIT
G-EQDSK file, rebuild psi on the file's own grid by solving

    Delta* psi = -mu0 R J_phi,   J_phi = R p'(psi_N) + FF'(psi_N) / (mu0 R)

with p', FF' *sampled from the file* (differentiable linear interpolation on
the uniform psi_N grid), Dirichlet boundary from the file's psirz ring, and
the plasma current renormalised to the file's Ip.  The span-relative RMSE
against the file's psirz is the reconstruction metric.

Whole solve is one jitted Picard loop (multigrid inner solve).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.io.geqdsk import GEqdsk
from scpn_fusion_tpu.ops.multigrid import _vcycle_impl
from scpn_fusion_tpu.ops.stencil import apply_dirichlet, gs_residual_rms

MU0 = 4.0e-7 * np.pi


class EqdskSolveResult(NamedTuple):
    psi: jnp.ndarray
    j_phi: jnp.ndarray
    converged: jnp.ndarray
    iterations: jnp.ndarray
    residual: jnp.ndarray
    span_rel_rmse: jnp.ndarray      # vs the file's psirz, full domain
    span_rel_rmse_core: jnp.ndarray  # psi_N <= 0.95 region only


def _sampled_profile(psi_n: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """Linear interpolation of a profile sampled on uniform psi_N in [0, 1]."""
    n = table.shape[0]
    x = jnp.clip(psi_n, 0.0, 1.0) * (n - 1)
    i0 = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    frac = x - i0
    return table[i0] * (1.0 - frac) + table[i0 + 1] * frac


@partial(jax.jit, static_argnames=("grid", "max_iter", "n_inner_cycles"))
def _solve_eqdsk_impl(
    grid: Grid,
    psi_ref: jnp.ndarray,
    pprime: jnp.ndarray,
    ffprime: jnp.ndarray,
    i_target: jnp.ndarray,
    sibry: jnp.ndarray,
    alpha: jnp.ndarray,
    tol: jnp.ndarray,
    *,
    max_iter: int,
    n_inner_cycles: int,
) -> EqdskSolveResult:
    r_1d = grid.R
    rr = grid.RR
    d_r, d_z = grid.dR, grid.dZ
    dtype = psi_ref.dtype

    psi_bc = psi_ref  # Dirichlet ring values come from the file itself.

    def source_from(psi):
        psi_axis = jnp.max(psi)
        # LCFS flux: the file's sibry (the EFIT separatrix value); the axis
        # flux tracks the evolving solution.
        denom = sibry - psi_axis
        denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        psi_n = (psi - psi_axis) / denom
        inside = (psi_n >= 0.0) & (psi_n < 1.0)
        pp = _sampled_profile(psi_n, pprime)
        ffp = _sampled_profile(psi_n, ffprime)
        j_phi = jnp.where(inside, rr * pp + ffp / (MU0 * rr), 0.0)
        i_cur = jnp.sum(j_phi) * d_r * d_z
        scale = jnp.where(jnp.abs(i_cur) > 1e-12, i_target / i_cur, 0.0)
        return j_phi * scale

    class Carry(NamedTuple):
        k: jnp.ndarray
        psi: jnp.ndarray
        diff: jnp.ndarray
        converged: jnp.ndarray

    def body(c: Carry) -> Carry:
        j_phi = source_from(c.psi)
        src = -MU0 * rr * j_phi
        psi_new = c.psi
        for _ in range(n_inner_cycles):
            psi_new = _vcycle_impl(psi_new, src, r_1d, d_r, d_z,
                                   1.0, 3, 3, 5, 50)
        psi_new = apply_dirichlet(psi_new, psi_bc)
        diff = jnp.mean(jnp.abs(psi_new - c.psi))
        psi_next = (1.0 - alpha) * c.psi + alpha * psi_new
        return Carry(c.k + 1, psi_next, diff, diff < tol)

    def cond(c: Carry) -> jnp.ndarray:
        return (c.k < max_iter) & (~c.converged) & jnp.isfinite(c.diff)

    init = Carry(jnp.int32(0), psi_ref, jnp.asarray(1e30, dtype), jnp.bool_(False))
    final = jax.lax.while_loop(cond, body, init)

    j_phi = source_from(final.psi)
    span = jnp.max(psi_ref) - jnp.min(psi_ref)
    err = final.psi - psi_ref
    rmse = jnp.sqrt(jnp.mean(err**2)) / span

    psi_axis = jnp.max(psi_ref)
    denom = sibry - psi_axis
    psi_n_ref = (psi_ref - psi_axis) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    core = psi_n_ref <= 0.95
    n_core = jnp.maximum(jnp.sum(core), 1)
    rmse_core = jnp.sqrt(jnp.sum(jnp.where(core, err**2, 0.0)) / n_core) / span

    return EqdskSolveResult(
        psi=final.psi, j_phi=j_phi, converged=final.converged,
        iterations=final.k, residual=final.diff,
        span_rel_rmse=rmse, span_rel_rmse_core=rmse_core)


def solve_from_geqdsk(
    eq: GEqdsk,
    *,
    max_iter: int = 300,
    alpha: float = 0.1,
    tol: float | None = None,
    n_inner_cycles: int = 1,
    dtype=None,
) -> EqdskSolveResult:
    """Reconstruct the equilibrium of a G-EQDSK file on its own grid.

    ``dtype`` defaults to f64 where x64 is enabled and f32 otherwise.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    grid = Grid.from_bounds(
        eq.nw, eq.nh,
        eq.rleft, eq.rleft + eq.rdim,
        eq.zmid - eq.zdim / 2, eq.zmid + eq.zdim / 2,
        dtype=np.dtype(np.float64 if dtype == jnp.float64 else np.float32),
    )
    psi_ref = jnp.asarray(eq.psirz, dtype)
    span = float(eq.psirz.max() - eq.psirz.min())
    if tol is None:
        tol = 1e-5 * span
    return _solve_eqdsk_impl(
        grid, psi_ref,
        jnp.asarray(eq.pprime, dtype),
        jnp.asarray(eq.ffprime, dtype),
        jnp.asarray(eq.current, dtype),
        jnp.asarray(eq.sibry, dtype),
        jnp.asarray(alpha, dtype),
        jnp.asarray(tol, dtype),
        max_iter=max_iter,
        n_inner_cycles=n_inner_cycles,
    )
