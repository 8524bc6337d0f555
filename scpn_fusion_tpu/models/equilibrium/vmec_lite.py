"""VMEC-lite: fixed-boundary spectral 3D equilibrium relaxation.

JAX port of the reference's reduced-order VMEC-style solver
(``core/vmec_lite.py:33-280``; Hirshman & Whitson 1983 at reduced order):
(R_mn, Z_mn) Fourier coefficients on a radial s-grid relax under radial
curvature tension with a q^2 dp/ds Shafranov-shift drive on the (0,0) mode,
fixed boundary, adaptive residual-monotone steps.  accelerator-first: the per-mode
Python loops become whole-array operations, the relaxation runs inside one
``lax.while_loop`` (adaptive step via a bounded backtracking ``fori``), and
the solve is differentiable end-to-end w.r.t. boundary shape and profiles —
3D shape optimisation by ``jax.grad``, which the reference cannot do.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class SpectralBasis:
    """Fourier basis over (m, n) mode pairs (static layout)."""

    m_pol: int = 3
    n_tor: int = 2
    n_fp: int = 1

    @property
    def mn_modes(self) -> tuple:
        modes = []
        for m in range(self.m_pol + 1):
            n_min = -self.n_tor if m > 0 else 0
            for n in range(n_min, self.n_tor + 1):
                modes.append((m, n))
        return tuple(modes)

    @property
    def n_modes(self) -> int:
        return len(self.mn_modes)

    def mode_index(self, m: int, n: int) -> int:
        return self.mn_modes.index((m, n))

    def evaluate(self, coeffs: jnp.ndarray, theta: jnp.ndarray,
                 zeta: jnp.ndarray, is_sin: bool = False) -> jnp.ndarray:
        """Evaluate sum_mn c_mn {cos|sin}(m theta - n n_fp zeta)."""
        m = jnp.asarray([mm for mm, _ in self.mn_modes], coeffs.dtype)
        n = jnp.asarray([nn for _, nn in self.mn_modes], coeffs.dtype)
        angle = (m[:, None] * theta.reshape(-1)[None, :]
                 - self.n_fp * n[:, None] * zeta.reshape(-1)[None, :])
        basis = jnp.sin(angle) if is_sin else jnp.cos(angle)
        return (coeffs @ basis).reshape(theta.shape)


class VMECResult(NamedTuple):
    r_mn: jnp.ndarray      # (n_s, n_modes)
    z_mn: jnp.ndarray
    b_mn: jnp.ndarray
    residual: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray


def tokamak_boundary(r0: float, a: float, kappa: float, delta: float,
                     basis: SpectralBasis):
    """Low-order Fourier boundary for a shaped axisymmetric tokamak
    (reference ``AxisymmetricTokamakBoundary.from_parameters``)."""
    r_b = {(0, 0): r0, (1, 0): a, (2, 0): -delta * a / 2.0}
    z_b = {(1, 0): kappa * a}
    r_vec = np.zeros(basis.n_modes)
    z_vec = np.zeros(basis.n_modes)
    for (m, n), v in r_b.items():
        if (m, n) in basis.mn_modes:
            r_vec[basis.mode_index(m, n)] = v
    for (m, n), v in z_b.items():
        if (m, n) in basis.mn_modes:
            z_vec[basis.mode_index(m, n)] = v
    return jnp.asarray(r_vec), jnp.asarray(z_vec)


@partial(jax.jit, static_argnames=("basis", "n_s", "max_iter", "differentiable"))
def solve_vmec_lite(
    basis: SpectralBasis,
    r_boundary: jnp.ndarray,   # (n_modes,)
    z_boundary: jnp.ndarray,
    pressure: jnp.ndarray,     # (n_s,)
    iota: jnp.ndarray,         # (n_s,)
    *,
    n_s: int = 21,
    max_iter: int = 100,
    tol: float = 1e-4,
    differentiable: bool = False,
) -> VMECResult:
    """Spectral steepest-descent relaxation (whole solve under jit).

    ``differentiable=True`` runs a fixed ``max_iter`` iterations under
    ``fori_loop`` (no early exit) so ``jax.grad`` can flow through the solve
    — lax.while_loop is not reverse-differentiable.
    """
    dtype = r_boundary.dtype
    s_grid = jnp.linspace(0.0, 1.0, n_s, dtype=dtype)
    idx_00 = basis.mode_index(0, 0)
    m_arr = jnp.asarray([m for m, _ in basis.mn_modes], dtype)

    # Initial guess: s^(m/2) interpolation from axis to boundary; (0,0)
    # mode constant at the boundary major radius.
    shape = s_grid[:, None] ** (m_arr[None, :] / 2.0)
    r_mn = shape * r_boundary[None, :]
    z_mn = shape * z_boundary[None, :]
    r_mn = r_mn.at[:, idx_00].set(r_boundary[idx_00])
    z_mn = z_mn.at[:, idx_00].set(0.0)

    ds = s_grid[1] - s_grid[0]
    dp_ds_full = jnp.gradient(pressure) / ds
    q_prof = 1.0 / jnp.maximum(jnp.abs(iota), 0.01)
    r00_bound = jnp.maximum(jnp.abs(r_boundary[idx_00]), 1e-3)

    def forces(r, z):
        f_r = jnp.zeros_like(r)
        f_z = jnp.zeros_like(z)
        lap_r = (r[2:] - 2.0 * r[1:-1] + r[:-2]) * 2.0
        lap_z = (z[2:] - 2.0 * z[1:-1] + z[:-2]) * 2.0
        f_r = f_r.at[1:-1].set(lap_r)
        f_z = f_z.at[1:-1].set(lap_z)
        shaf = q_prof[1:-1] ** 2 * dp_ds_full[1:-1] / r00_bound * 1e-6
        f_r = f_r.at[1:-1, idx_00].add(-shaf)
        res = jnp.max(jnp.abs(f_r)) + jnp.max(jnp.abs(f_z))
        return f_r, f_z, res

    class Carry(NamedTuple):
        k: jnp.ndarray
        r: jnp.ndarray
        z: jnp.ndarray
        lr: jnp.ndarray
        residual: jnp.ndarray
        converged: jnp.ndarray

    def body(c: Carry) -> Carry:
        f_r, f_z, res = forces(c.r, c.z)

        def try_step(i, st):
            step, accepted, best_r, best_z = st
            r_try = c.r.at[1:-1].add(
                jnp.where(accepted, 0.0, step) * f_r[1:-1])
            z_try = c.z.at[1:-1].add(
                jnp.where(accepted, 0.0, step) * f_z[1:-1])
            _, _, res_try = forces(r_try, z_try)
            ok = (~accepted) & jnp.isfinite(res_try) & (res_try <= res)
            best_r = jnp.where(ok, r_try, best_r)
            best_z = jnp.where(ok, z_try, best_z)
            return (step * 0.5, accepted | ok, best_r, best_z)

        step0 = c.lr
        _, accepted, new_r, new_z = jax.lax.fori_loop(
            0, 10, try_step, (step0, jnp.bool_(False), c.r, c.z))
        lr = jnp.where(accepted, jnp.minimum(c.lr * 1.1, 0.2), c.lr * 0.5)
        return Carry(c.k + 1, new_r, new_z, lr, res, res < tol)

    def cond(c: Carry) -> jnp.ndarray:
        return (c.k < max_iter) & (~c.converged)

    init = Carry(jnp.int32(0), r_mn, z_mn, jnp.asarray(0.1, dtype),
                 jnp.asarray(1e30, dtype), jnp.bool_(False))
    if differentiable:
        final = jax.lax.fori_loop(0, max_iter, lambda i, c: body(c), init)
    else:
        final = jax.lax.while_loop(cond, body, init)

    # B-field spectral estimate (1/R toroidal + iota poloidal shaping).
    r00_s = jnp.maximum(jnp.abs(final.r[:, idx_00]), 1e-6)
    b_mn = -final.r / r00_s[:, None]
    m_is_1 = (m_arr == 1.0)
    b_mn = b_mn + jnp.where(
        m_is_1[None, :],
        iota[:, None] * jnp.abs(final.z) / r00_s[:, None], 0.0)
    b_mn = b_mn.at[:, idx_00].set(1.0)

    return VMECResult(final.r, final.z, b_mn, final.residual, final.k,
                      final.converged)


def flux_surface_rz(basis: SpectralBasis, result: VMECResult, s_index: int,
                    n_theta: int = 64, zeta: float = 0.0):
    """Evaluate one flux surface (R, Z)(theta) at fixed toroidal angle."""
    theta = jnp.linspace(0.0, 2.0 * jnp.pi, n_theta)
    zeta_arr = jnp.full_like(theta, zeta)
    r = basis.evaluate(result.r_mn[s_index], theta, zeta_arr, is_sin=False)
    z = basis.evaluate(result.z_mn[s_index], theta, zeta_arr, is_sin=True)
    return r, z
