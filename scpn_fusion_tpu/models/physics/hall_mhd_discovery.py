"""Reduced 2D Hall-MHD discovery sandbox: tearing drive, sweeps, threshold.

JAX-native port of the reference's ``core/hall_mhd_discovery.py:103-447``
(``HallMHD``): doubly-periodic pseudo-spectral reduced Hall-MHD for
(phi, psi) with magnetic flutter, the Hall term (rho_s^2 [J, psi]),
hyper-viscosity, 2/3-rule dealiasing, an optional static current-sheet
background ``psi_0 = A cos(x)`` as the tearing-mode drive, RK2 stepping,
zonal-flow diagnostics, an (eta, nu) growth-rate parameter sweep, and the
bisection search for the marginal resistivity of the driven sheet.

Where the reference steps one simulation at a time with host NumPy FFTs,
every trajectory here is a ``lax.scan`` over jnp FFTs, and the parameter
sweep ``vmap``s the WHOLE grid of driven simulations into one compiled
program (the reference's nested Python loops).  The bisection threshold is
a ``fori_loop`` of full simulations — also one program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

GRID = 64
L_BOX = 2.0 * jnp.pi
DT = 5.0e-3
RHO_S = 0.1      # Hall scale (Larmor radius)
BETA = 0.01      # plasma beta


class HallMHDState(NamedTuple):
    phi_k: jnp.ndarray     # complex (N, N)
    psi_k: jnp.ndarray     # complex (N, N)


def _spectral_setup(n: int):
    k = jnp.fft.fftfreq(n, d=float(L_BOX) / (2.0 * jnp.pi * n))
    kx, ky = jnp.meshgrid(k, k)
    k2 = (kx**2 + ky**2).at[0, 0].set(1.0)
    kmax = jnp.max(k)
    mask = jnp.where(k2 < (2.0 / 3.0 * kmax) ** 2, 1.0, 0.0)
    return kx, ky, k2, mask


def init_hall_mhd(key, n: int = GRID, *, background_amplitude=0.0,
                  noise: float = 1e-3) -> HallMHDState:
    """Seeded random initial perturbation (reference ``__init__:118-152``)."""
    _, _, _, mask = _spectral_setup(n)
    k1, k2_ = jax.random.split(key)
    phi_k = jnp.fft.fft2(noise * jax.random.normal(k1, (n, n))) * mask
    psi_k = jnp.fft.fft2(noise * jax.random.normal(k2_, (n, n))) * mask
    return HallMHDState(phi_k, psi_k)


def background_flux_k(n: int, amplitude) -> jnp.ndarray:
    """Static current sheet ``psi_0 = A cos(x)`` (tearing drive)."""
    _, _, _, mask = _spectral_setup(n)
    x = jnp.linspace(0.0, float(L_BOX), n, endpoint=False)
    xx, _ = jnp.meshgrid(x, x)
    return jnp.fft.fft2(amplitude * jnp.cos(xx)) * mask


def _bracket(a_k, b_k, kx, ky, mask):
    """Dealiased spectral Poisson bracket [A, B] (reference ``:167-190``)."""
    dxa = jnp.fft.ifft2(1j * kx * a_k)
    dya = jnp.fft.ifft2(1j * ky * a_k)
    dxb = jnp.fft.ifft2(1j * kx * b_k)
    dyb = jnp.fft.ifft2(1j * ky * b_k)
    return jnp.fft.fft2(dxa * dyb - dya * dxb) * mask


def _rhs(state: HallMHDState, psi0_k, eta, nu, kx, ky, k2, mask):
    """dU/dt = -[phi,U] + beta [J_tot, psi_tot] - nu k^4 U;
    dpsi/dt = -[phi, psi_tot] + rho_s^2 [J_tot, psi_tot] - eta k^2 psi
    (only the perturbation is resistively dissipated; reference
    ``dynamics:192-236``)."""
    phi, psi = state
    psi_tot = psi + psi0_k
    u = -k2 * phi
    j_tot = -k2 * psi_tot

    c_phi_u = _bracket(phi, u, kx, ky, mask)
    c_j_psi = _bracket(j_tot, psi_tot, kx, ky, mask)
    c_phi_psi = _bracket(phi, psi_tot, kx, ky, mask)

    du = -c_phi_u + BETA * c_j_psi - nu * k2**2 * u
    dpsi = -c_phi_psi + RHO_S**2 * c_j_psi - eta * k2 * psi
    dphi = (-du / k2).at[0, 0].set(0.0)
    return HallMHDState(dphi, dpsi)


class HallMHDTrace(NamedTuple):
    total_energy: jnp.ndarray    # (n_steps,)
    zonal_energy: jnp.ndarray    # (n_steps,)
    final: HallMHDState


@partial(jax.jit, static_argnames=("n_steps", "n"))
def run_hall_mhd(
    state0: HallMHDState,
    *,
    eta=1e-4,
    nu=1e-4,
    background_amplitude=0.0,
    n_steps: int = 200,
    n: int = GRID,
    dt: float = DT,
) -> HallMHDTrace:
    """RK2 trajectory as one scan (reference ``step:238-263``)."""
    kx, ky, k2, mask = _spectral_setup(n)
    psi0_k = background_flux_k(n, background_amplitude)
    zonal_mask = (jnp.abs(ky) < 1e-9) & (jnp.abs(kx) > 1e-9)

    def step(s, _):
        d1 = _rhs(s, psi0_k, eta, nu, kx, ky, k2, mask)
        mid = HallMHDState(s.phi_k + 0.5 * dt * d1.phi_k,
                           s.psi_k + 0.5 * dt * d1.psi_k)
        d2 = _rhs(mid, psi0_k, eta, nu, kx, ky, k2, mask)
        s = HallMHDState(s.phi_k + dt * d2.phi_k, s.psi_k + dt * d2.psi_k)
        tot = jnp.sum(jnp.abs(s.phi_k) ** 2)
        zon = jnp.sum(jnp.where(zonal_mask, jnp.abs(s.phi_k) ** 2, 0.0))
        return s, (tot, zon)

    final, (tot, zon) = jax.lax.scan(step, state0, None, length=n_steps)
    return HallMHDTrace(tot, zon, final)


def _late_growth(energy: jnp.ndarray, tail: int) -> jnp.ndarray:
    """Mean late-time log-slope (reference ``:294-300``)."""
    e = jnp.maximum(energy[-tail:], 1e-30)
    return jnp.mean(jnp.diff(jnp.log(e)))


@partial(jax.jit, static_argnames=("n_points", "sim_steps", "n"))
def parameter_sweep(
    key,
    eta_range=(1e-5, 1e-3),
    nu_range=(1e-5, 1e-3),
    *,
    n_points: int = 5,
    sim_steps: int = 200,
    background_amplitude=1.0,
    n: int = GRID,
):
    """(eta, nu) growth-rate map — the reference's nested host loops
    (``parameter_sweep:265-304``) as ONE vmapped program over the grid.
    Returns (etas, nus, growth) flattened over the n_points^2 grid."""
    etas = jnp.linspace(eta_range[0], eta_range[1], n_points)
    nus = jnp.linspace(nu_range[0], nu_range[1], n_points)
    ee, nn = jnp.meshgrid(etas, nus, indexing="ij")
    state0 = init_hall_mhd(key, n, background_amplitude=background_amplitude)

    def one(eta, nu):
        tr = run_hall_mhd(state0, eta=eta, nu=nu,
                          background_amplitude=background_amplitude,
                          n_steps=sim_steps, n=n)
        return _late_growth(tr.total_energy, 10)

    growth = jax.vmap(one)(ee.reshape(-1), nn.reshape(-1))
    return ee.reshape(-1), nn.reshape(-1), growth


@partial(jax.jit, static_argnames=("n_bisect", "sim_steps", "n"))
def find_tearing_threshold(
    key,
    eta_range=(1e-6, 1e-2),
    *,
    n_bisect: int = 10,
    sim_steps: int = 500,
    background_amplitude=1.0,
    n: int = GRID,
):
    """Geometric-mean bisection for the marginal resistivity of the driven
    current sheet (reference ``find_tearing_threshold:306-345``): growth
    above the marginal eta is suppressed by resistive dissipation of the
    perturbation.  An empirical sandbox threshold, not a literature-parity
    tearing-rate claim (same disclosure as the reference).  One compiled
    ``fori_loop`` of full simulations."""
    state0 = init_hall_mhd(key, n, background_amplitude=background_amplitude)

    def body(_, bounds):
        lo, hi = bounds
        mid = jnp.sqrt(lo * hi)
        tr = run_hall_mhd(state0, eta=mid,
                          background_amplitude=background_amplitude,
                          n_steps=sim_steps, n=n)
        growth = _late_growth(tr.total_energy, 20)
        still_growing = growth > 0.0
        return (jnp.where(still_growing, mid, lo),
                jnp.where(still_growing, hi, mid))

    lo, hi = jax.lax.fori_loop(
        0, n_bisect, body,
        (jnp.asarray(eta_range[0]), jnp.asarray(eta_range[1])))
    return {"threshold_eta": jnp.sqrt(lo * hi), "lo": lo, "hi": hi}
