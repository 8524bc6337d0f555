"""Vessel eddy-current circuits + RZIP rigid-plasma vertical response.

JAX-native equivalent of the reference's vessel/RZIP stack
(``core/vessel_model.py:32-160``, ``control/rzip_model.py:27-380``):

* Vessel: toroidal filaments as a struct-of-arrays circuit
  M dI/dt + R I = -dPhi_ext/dt, advanced by one backward-Euler solve per
  step; the O(n^2) mutual-inductance assembly is a single broadcast over
  the filament arrays (no per-pair Python loops).
* RZIP: rigid vertical-displacement state space
  x = [Z, dZ/dt, I_1..I_n], destabilising force K = n mu0 Ip^2/(4 pi R0),
  with the plasma-filament coupling dM/dz computed by ``jax.grad`` of the
  analytic mutual inductance (the reference uses a 1e-4 finite difference).
* VerticalStabilityAnalysis: midplane n-index from psi, passive margin,
  additive-lag feedback-gain sizing.
* LQR voltage controller: gain from the shared CARE solver
  (``control/hinf.solve_care_ode``) instead of SciPy.

Growth rates / closed-loop eigenvalues use host NumPy ``eigvals`` on the
tiny (n+2) matrices — nonsymmetric eig is unsupported on accelerator backends
and this is offline analysis, not a hot path.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.control.hinf import solve_care_ode
from scpn_fusion_tpu.core.special import ellipe, ellipk

MU_0 = 4.0e-7 * math.pi


class Vessel(NamedTuple):
    """Struct-of-arrays toroidal filament set (wall and/or active coils)."""

    r: jnp.ndarray           # (n,) filament major radius [m]
    z: jnp.ndarray           # (n,)
    resistance: jnp.ndarray  # (n,) loop resistance [Ohm]
    inductance: jnp.ndarray  # (n,) self-inductance [H]


def mutual_inductance(r1, z1, r2, z2):
    """Mutual inductance of two coaxial toroidal loops,
    M = mu0 sqrt(R1 R2) [(2 - k^2) K - 2 E] / k  (broadcasts; smooth in z
    so ``jax.grad`` gives exact dM/dz)."""
    denom = (r1 + r2) ** 2 + (z1 - z2) ** 2
    k2 = jnp.clip(4.0 * r1 * r2 / jnp.maximum(denom, 1e-30), 1e-9, 0.999999)
    return (MU_0 * jnp.sqrt(r1 * r2)
            * ((2.0 - k2) * ellipk(k2) - 2.0 * ellipe(k2)) / jnp.sqrt(k2))


def mutual_matrix(v: Vessel) -> jnp.ndarray:
    """(n, n) circuit inductance matrix: pairwise mutuals, self on diagonal."""
    m = mutual_inductance(v.r[:, None], v.z[:, None],
                          v.r[None, :], v.z[None, :])
    n = v.r.shape[0]
    eye = jnp.eye(n, dtype=v.r.dtype)
    return m * (1.0 - eye) + jnp.diag(v.inductance)


@jax.jit
def vessel_step(v: Vessel, currents: jnp.ndarray, dphi_ext_dt: jnp.ndarray,
                dt) -> jnp.ndarray:
    """Backward-Euler circuit step: (M + dt R) I' = M I - dt dPhi_ext/dt."""
    m = mutual_matrix(v)
    lhs = m + dt * jnp.diag(v.resistance)
    rhs = m @ currents - dt * dphi_ext_dt
    return jnp.linalg.solve(lhs, rhs)


def psi_vessel(v: Vessel, currents: jnp.ndarray, r_obs: jnp.ndarray,
               z_obs: jnp.ndarray) -> jnp.ndarray:
    """Poloidal flux at observation points from the filament currents
    (Green contraction; flux per rad = M/(2 pi) * I)."""
    shape = r_obs.shape
    rf = r_obs.reshape(-1)
    zf = z_obs.reshape(-1)
    g = mutual_inductance(rf[:, None], zf[:, None],
                          v.r[None, :], v.z[None, :]) / (2.0 * jnp.pi)
    return (g @ currents).reshape(shape)


class RZIPStateSpace(NamedTuple):
    a: jnp.ndarray   # (2+n, 2+n)
    b: jnp.ndarray   # (2+n, n_coils)
    c: jnp.ndarray   # (1, 2+n)
    d: jnp.ndarray   # (1, n_coils)


@partial(jax.jit, static_argnames=("n_wall",))
def build_rzip_state_space(
    wall_and_coils: Vessel,     # wall filaments first, then active coils
    *,
    n_wall: int,
    r0: float,
    ip_ma: float,
    n_index: float,
    m_eff: float = 1.0,
) -> RZIPStateSpace:
    """Continuous-time rigid vertical-motion model (reference
    ``RZIPModel.build_state_space``), assembled without per-circuit loops.

    dZ'/dt = (-K Z + sum_k C_k I_k)/m_eff,   K = n mu0 Ip^2/(4 pi R0)
    M dI/dt = V - R I - C dZ/dt,             C_k = Ip dM_pk/dz.
    """
    v = wall_and_coils
    n_circ = v.r.shape[0]
    n_coils = n_circ - n_wall
    ip = ip_ma * 1e6
    dtype = v.r.dtype

    k_force = n_index * MU_0 * ip**2 / (4.0 * jnp.pi * r0)

    # Exact dM/dz of the plasma-filament mutual at the filament position.
    def dm_dz(rk, zk):
        return jax.grad(lambda zp: mutual_inductance(r0, zp, rk, zk))(0.0)

    c_vec = jax.vmap(dm_dz)(v.r, v.z) * ip          # (n_circ,)

    m = mutual_matrix(v)
    m_inv = jnp.linalg.inv(m)
    m_inv_r = m_inv * v.resistance[None, :]          # M^-1 @ diag(R)
    m_inv_c = m_inv @ c_vec

    n_states = 2 + n_circ
    a = jnp.zeros((n_states, n_states), dtype)
    a = a.at[0, 1].set(1.0)
    a = a.at[1, 0].set(-k_force / m_eff)
    a = a.at[1, 2:].set(c_vec / m_eff)
    a = a.at[2:, 1].set(-m_inv_c)
    a = a.at[2:, 2:].set(-m_inv_r)

    b = jnp.zeros((n_states, n_coils), dtype)
    b = b.at[2:, :].set(m_inv[:, n_wall:])
    c = jnp.zeros((1, n_states), dtype).at[0, 0].set(1.0)
    d = jnp.zeros((1, n_coils), dtype)
    return RZIPStateSpace(a, b, c, d)


def vertical_growth_rate(ss: RZIPStateSpace) -> float:
    """Max real eigenvalue of A [1/s] (host eig on the tiny matrix)."""
    return float(np.max(np.real(np.linalg.eigvals(np.asarray(ss.a)))))


def vertical_growth_time_ms(ss: RZIPStateSpace) -> float:
    gamma = vertical_growth_rate(ss)
    return float("inf") if gamma <= 0.0 else 1000.0 / gamma


def compute_n_index(psi: jnp.ndarray, r: jnp.ndarray, z: jnp.ndarray,
                    r0: float) -> jnp.ndarray:
    """Midplane vertical-stability index n = -(R0/Bz) dBz/dR from a psi map
    (reference ``VerticalStabilityAnalysis.compute_n_index``)."""
    dr = r[1] - r[0]
    z0_idx = jnp.argmin(jnp.abs(z))
    psi_mid = psi[z0_idx, :]
    bz = _gradient_1d(psi_mid, dr) / r
    dbz_dr = _gradient_1d(bz, dr)
    r0_idx = jnp.argmin(jnp.abs(r - r0))
    bz_local = bz[r0_idx]
    return -(r0 / jnp.where(jnp.abs(bz_local) < 1e-12, 1e-12, bz_local)
             ) * dbz_dr[r0_idx]


def _gradient_1d(f, dx):
    """Second-order gradient with one-sided second-order edges (jnp.gradient
    has no edge_order=2)."""
    interior = (f[2:] - f[:-2]) / (2.0 * dx)
    left = (-3.0 * f[0] + 4.0 * f[1] - f[2]) / (2.0 * dx)
    right = (3.0 * f[-1] - 4.0 * f[-2] + f[-3]) / (2.0 * dx)
    return jnp.concatenate([left[None], interior, right[None]])


def passive_stability_margin(n_index: float, tau_wall: float) -> float:
    """Contract-parity proxy: the margin is the n-index itself."""
    return n_index


def required_feedback_gain(gamma: float, tau_wall: float,
                           tau_controller: float) -> float:
    """Additive-lag sizing rule g_min = gamma (tau_wall + tau_ctrl)."""
    if not (math.isfinite(gamma) and math.isfinite(tau_wall)
            and math.isfinite(tau_controller)):
        raise ValueError("gamma, tau_wall, tau_controller must be finite")
    if gamma <= 0 or tau_wall <= 0 or tau_controller <= 0:
        raise ValueError("gamma, tau_wall, tau_controller must be positive")
    return gamma * (tau_wall + tau_controller)


def rzip_lqr_gain(ss: RZIPStateSpace, kp: float = 10.0, kd: float = 10.0,
                  *, dt: float = 1e-4, n_steps: int = 20000) -> jnp.ndarray:
    """LQR voltage-controller gain K = R^-1 B^T P via the shared CARE
    integrator (reference ``RZIPController.__init__`` uses SciPy ARE).
    Q weights [Z, dZ/dt]; R = I."""
    a, b = ss.a, ss.b
    n = a.shape[0]
    q = jnp.zeros((n, n), a.dtype).at[0, 0].set(max(kp, 1.0)) \
                                  .at[1, 1].set(max(kd, 1.0))
    s = b @ b.T      # R = I -> B R^-1 B^T
    p = solve_care_ode(a, s, q, dt=dt, n_steps=n_steps)
    return b.T @ p


def rzip_voltage_command(k_gain: jnp.ndarray, z_meas, dz_dt) -> jnp.ndarray:
    """u = -K x with only (Z, dZ/dt) measured; circuit states assumed 0."""
    x = jnp.zeros((k_gain.shape[1],), k_gain.dtype)
    x = x.at[0].set(z_meas).at[1].set(dz_dt)
    return -(k_gain @ x)


def closed_loop_eigenvalues(ss: RZIPStateSpace,
                            k_gain: jnp.ndarray) -> np.ndarray:
    """Eigenvalues of A - B K (host eig; stability smoke checks)."""
    a_cl = np.asarray(ss.a) - np.asarray(ss.b) @ np.asarray(k_gain)
    return np.linalg.eigvals(a_cl)
