"""Nonlinear 5D flux-tube gyrokinetic solver (delta-f, pseudo-spectral).

JAX-native equivalent of the reference's nonlinear GK stack
(``core/gk_nonlinear.py:40`` over the ``_gk_nonlinear_{types,setup,
operators,time}.py`` mixins, and its JAX twin ``core/jax_gk_nonlinear.py``).
Same physics contract — perturbed distribution f(s, kx, ky, theta, v_par,
mu) evolved by the gyrokinetic Vlasov equation with

* quasineutrality field solve with Padé gyro-screening Gamma0 = 1/(1+b),
  adiabatic-electron or kinetic-electron closure (+ Ampère A_par and
  perpendicular pressure-balance B_par in the electromagnetic mode),
* dealiased (2/3-rule) pseudo-spectral ExB Poisson bracket,
* 4th-order centred parallel streaming with ballooning kx-connection at the
  theta boundary,
* curvature + grad-B magnetic drifts from the local geometry,
* toroidal branch drive omega_* (density + temperature gradients),
* Krook (``-nu k_perp^2 f``) or conservative pitch/energy collision model,
* k_perp^(2p) hyperdiffusion and optional zonal (Rosenbluth-Hinton) damping,

— but a different architecture: instead of a stateful class with NumPy
loops per species, everything here is a pure function over a precomputed
:class:`GKGrids` pytree; one RK4 step is a single fused jitted program (all
species batched in one array), the whole trajectory is a ``lax.scan``, and
multi-chip scaling shards velocity space over the device mesh
(``parallel/gk_shard.py``) with ``psum`` for the velocity moments — the
JAX-native replacement for the reference's rank-tile decomposition
(``core/gk_domain_decomposition.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.dtypes import canonical, default_float
import numpy as np


@dataclasses.dataclass(frozen=True)
class NonlinearGKConfig:
    """Grid + physics parameters (reference ``_gk_nonlinear_types.py:22``)."""

    n_kx: int = 16
    n_ky: int = 16
    n_theta: int = 32
    n_vpar: int = 16
    n_mu: int = 8
    n_species: int = 2

    dt: float = 0.05
    n_steps: int = 200
    save_interval: int = 10

    box_lx: float = 80.0
    box_ly: float = 62.83
    vpar_max: float = 3.0
    mu_max: float = 9.0

    dealias: bool = True
    hyper_order: int = 4
    hyper_coeff: float = 0.1
    cfl_factor: float = 0.5
    cfl_adapt: bool = True

    collisions: bool = True
    nu_collision: float = 0.01
    collision_model: str = "krook"          # "krook" | "conservative"
    nonlinear: bool = True
    kinetic_electrons: bool = False
    mass_ratio_me_mi: float = 1.0 / 400.0
    electromagnetic: bool = False
    beta_e: float = 0.01
    zonal_damping_rate: float = 0.0

    # Local geometry (s-alpha defaults; full Miller via `geometry=`)
    r_major: float = 2.78
    a_minor: float = 1.0
    b0: float = 2.0
    q: float = 1.4
    s_hat: float = 0.78

    # Normalised gradients R/L_x
    r_l_ti: float = 6.9
    r_l_te: float = 6.9
    r_l_ne: float = 2.2

    dtype: str = "complex64"


class GKGrids(NamedTuple):
    """Everything precomputed once per config; closed over by the stepper."""

    kx: jnp.ndarray            # (n_kx,)
    ky: jnp.ndarray            # (n_ky,)
    kperp2: jnp.ndarray        # (n_kx, n_ky)
    dealias_mask: jnp.ndarray  # (n_kx, n_ky)
    theta: jnp.ndarray         # (n_theta,)
    d_theta: jnp.ndarray       # scalar
    vpar: jnp.ndarray          # (n_vpar,)
    mu: jnp.ndarray            # (n_mu,)
    d_vpar: jnp.ndarray
    d_mu: jnp.ndarray
    maxwellian: jnp.ndarray    # (n_vpar, n_mu)  e^{-E}/pi^{3/2}
    energy: jnp.ndarray        # (n_vpar, n_mu)  E = vpar^2/2 + mu (B=1 ref)
    b_dot_grad: jnp.ndarray    # (n_theta,)
    b_ratio: jnp.ndarray       # (n_theta,) B(theta)/B0
    kappa_n: jnp.ndarray       # (n_theta,)
    kappa_g: jnp.ndarray       # (n_theta,)
    ball_phase_fwd: jnp.ndarray  # (n_kx, n_ky) e^{+i s_hat ky x}
    ball_phase_bwd: jnp.ndarray
    rho_ratio_i: jnp.ndarray   # scalar
    rho_ratio_e: jnp.ndarray   # scalar
    vth_ratio_e: jnp.ndarray   # scalar sqrt(m_i/m_e)


class GKState(NamedTuple):
    f: jnp.ndarray             # (S, n_kx, n_ky, n_theta, n_vpar, n_mu) complex
    time: jnp.ndarray          # scalar


class GKTrace(NamedTuple):
    times: jnp.ndarray         # (n_saves,)
    q_ion: jnp.ndarray         # (n_saves,) gyro-Bohm heat flux
    q_elec: jnp.ndarray
    phi_rms: jnp.ndarray
    zonal_rms: jnp.ndarray
    free_energy: jnp.ndarray


def build_grids(cfg: NonlinearGKConfig, geometry=None) -> GKGrids:
    """Precompute spectral grids, velocity grids, geometry, phases."""
    fdt = jnp.float32 if cfg.dtype == "complex64" else jnp.float64
    kx = 2.0 * np.pi * np.fft.fftfreq(cfg.n_kx, d=cfg.box_lx / cfg.n_kx)
    ky = 2.0 * np.pi * np.fft.fftfreq(cfg.n_ky, d=cfg.box_ly / cfg.n_ky)
    kperp2 = kx[:, None] ** 2 + ky[None, :] ** 2
    if cfg.dealias:
        mask = ((np.abs(kx[:, None]) <= np.max(np.abs(kx)) * 2.0 / 3.0)
                & (np.abs(ky[None, :]) <= np.max(np.abs(ky)) * 2.0 / 3.0))
    else:
        mask = np.ones_like(kperp2, dtype=bool)

    theta = np.linspace(-np.pi, np.pi, cfg.n_theta, endpoint=False)
    d_theta = theta[1] - theta[0]
    vpar = np.linspace(-cfg.vpar_max, cfg.vpar_max, cfg.n_vpar)
    mu = np.linspace(0.0, cfg.mu_max, cfg.n_mu)
    d_vpar = vpar[1] - vpar[0] if cfg.n_vpar > 1 else 1.0
    d_mu = mu[1] - mu[0] if cfg.n_mu > 1 else 1.0
    energy = 0.5 * vpar[:, None] ** 2 + mu[None, :]
    maxwellian = np.exp(-energy) / np.pi ** 1.5

    if geometry is not None:
        b_ratio = np.asarray(geometry.b_mag) / np.asarray(geometry.b_mag)[0]
        b_dot_grad = np.asarray(geometry.b_dot_grad_theta)
        kappa_n = np.asarray(geometry.kappa_n)
        kappa_g = np.asarray(geometry.kappa_g)
    else:
        # s-alpha circular: B ~ 1/(1 + eps cos theta), bhat.grad = 1/(qR)
        eps = 0.5 * cfg.a_minor / cfg.r_major
        b_ratio = 1.0 / (1.0 + eps * np.cos(theta))
        b_dot_grad = np.full_like(theta, 1.0 / (cfg.q * cfg.r_major))
        kappa_n = (np.cos(theta) + cfg.s_hat * theta * np.sin(theta)) \
            / cfg.r_major
        kappa_g = np.sin(theta) / cfg.r_major

    x = np.arange(cfg.n_kx) * cfg.box_lx / cfg.n_kx
    ball_fwd = np.exp(1j * cfg.s_hat * ky[None, :] * x[:, None])

    return GKGrids(
        kx=jnp.asarray(kx, fdt), ky=jnp.asarray(ky, fdt),
        kperp2=jnp.asarray(kperp2, fdt),
        dealias_mask=jnp.asarray(mask, fdt),
        theta=jnp.asarray(theta, fdt), d_theta=jnp.asarray(d_theta, fdt),
        vpar=jnp.asarray(vpar, fdt), mu=jnp.asarray(mu, fdt),
        d_vpar=jnp.asarray(d_vpar, fdt), d_mu=jnp.asarray(d_mu, fdt),
        maxwellian=jnp.asarray(maxwellian, fdt),
        energy=jnp.asarray(energy, fdt),
        b_dot_grad=jnp.asarray(b_dot_grad, fdt),
        b_ratio=jnp.asarray(b_ratio, fdt),
        kappa_n=jnp.asarray(kappa_n, fdt),
        kappa_g=jnp.asarray(kappa_g, fdt),
        ball_phase_fwd=jnp.asarray(ball_fwd, jnp.complex64
                                   if cfg.dtype == "complex64"
                                   else jnp.complex128),
        ball_phase_bwd=jnp.asarray(np.conj(ball_fwd), jnp.complex64
                                   if cfg.dtype == "complex64"
                                   else jnp.complex128),
        rho_ratio_i=jnp.asarray(1.0, fdt),
        rho_ratio_e=jnp.asarray(np.sqrt(cfg.mass_ratio_me_mi), fdt),
        vth_ratio_e=jnp.asarray(1.0 / np.sqrt(cfg.mass_ratio_me_mi), fdt),
    )


# ---------------------------------------------------------------------------
# Field solves
# ---------------------------------------------------------------------------

def velocity_moment(f_s: jnp.ndarray, weight, g: GKGrids) -> jnp.ndarray:
    """Integral over (vpar, mu) of weight * f — the only cross-velocity
    reduction; under velocity-space sharding this becomes a ``psum``."""
    return jnp.sum(f_s * weight, axis=(-2, -1)) * (g.d_vpar * g.d_mu)


def field_solve(cfg: NonlinearGKConfig, g: GKGrids,
                f: jnp.ndarray) -> jnp.ndarray:
    """Quasineutrality phi(kx, ky, theta) (reference
    ``_gk_nonlinear_operators.py:21-46``)."""
    n_ion = velocity_moment(f[0], 1.0, g)
    b_i = 0.5 * g.kperp2 * g.rho_ratio_i ** 2
    gamma0_i = 1.0 / (1.0 + b_i)
    if cfg.kinetic_electrons:
        n_elec = velocity_moment(f[1], 1.0, g)
        b_e = 0.5 * g.kperp2 * g.rho_ratio_e ** 2
        gamma0_e = 1.0 / (1.0 + b_e)
        denom = jnp.maximum((1.0 - gamma0_i) + (1.0 - gamma0_e), 1e-10)
        phi = (gamma0_i[:, :, None] * n_ion
               - gamma0_e[:, :, None] * n_elec) / denom[:, :, None]
    else:
        # Adiabatic electrons with zonal-flow correction: the Boltzmann
        # response does not act on the flux-surface-averaged (ky=0) modes.
        ky_nonzero = (jnp.abs(g.ky)[None, :] > 1e-10).astype(f.real.dtype)
        denom = jnp.maximum((1.0 - gamma0_i) + ky_nonzero, 1e-10)
        phi = gamma0_i[:, :, None] * n_ion / denom[:, :, None]
    return phi.at[0, 0, :].set(0.0)


def ampere_solve(cfg: NonlinearGKConfig, g: GKGrids,
                 f: jnp.ndarray) -> jnp.ndarray:
    """A_par from parallel current (electromagnetic mode)."""
    vpar_w = g.vpar[:, None]
    j_par = velocity_moment(f[0], vpar_w, g)
    if cfg.kinetic_electrons:
        j_par = j_par - g.vth_ratio_e * velocity_moment(f[1], vpar_w, g)
    a_par = cfg.beta_e * j_par / jnp.maximum(g.kperp2[:, :, None], 1e-10)
    return a_par.at[0, 0, :].set(0.0)


def bpar_solve(cfg: NonlinearGKConfig, g: GKGrids,
               f: jnp.ndarray) -> jnp.ndarray:
    """B_par from perpendicular pressure balance (electromagnetic mode)."""
    mu_w = g.mu[None, :]
    p_perp = velocity_moment(f[0], mu_w, g)
    if cfg.kinetic_electrons:
        p_perp = p_perp + velocity_moment(f[1], mu_w, g)
    b_par = -cfg.beta_e * p_perp / (1.0 + g.kperp2[:, :, None])
    return b_par.at[0, 0, :].set(0.0)


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def exb_bracket(g: GKGrids, phi: jnp.ndarray,
                f_s: jnp.ndarray) -> jnp.ndarray:
    """Dealiased pseudo-spectral Poisson bracket {phi, f}.

    One batched ifft2/fft2 over the trailing (theta, vpar, mu) dims — the
    FFTs see a single large batch, which is what XLA tiles well.
    """
    kxg = g.kx[:, None, None, None, None]
    kyg = g.ky[None, :, None, None, None]
    phi5 = phi[:, :, :, None, None]
    dphi_dx = jnp.fft.ifft2(1j * kxg * phi5, axes=(0, 1))
    dphi_dy = jnp.fft.ifft2(1j * kyg * phi5, axes=(0, 1))
    df_dx = jnp.fft.ifft2(1j * kxg * f_s, axes=(0, 1))
    df_dy = jnp.fft.ifft2(1j * kyg * f_s, axes=(0, 1))
    bracket = jnp.fft.fft2(dphi_dx * df_dy - dphi_dy * df_dx, axes=(0, 1))
    return bracket * g.dealias_mask[:, :, None, None, None]


def _kx_shift(g: GKGrids, f_s: jnp.ndarray, forward: bool) -> jnp.ndarray:
    """Ballooning kx-shift: x-space phase twist e^{+-i s_hat ky x}."""
    phase = g.ball_phase_fwd if forward else g.ball_phase_bwd
    fx = jnp.fft.ifft(f_s, axis=0)
    fx = fx * phase[:, :, None, None, None]
    return jnp.fft.fft(fx, axis=0)


def _roll_ballooning(g: GKGrids, f_s: jnp.ndarray, shift: int) -> jnp.ndarray:
    """Roll along theta; planes that wrap the boundary get the ballooning
    kx connection (reference ``_gk_nonlinear_setup.py:131-160``)."""
    rolled = jnp.roll(f_s, shift, axis=2)
    n_theta = f_s.shape[2]
    shifted = _kx_shift(g, rolled, forward=(shift > 0))
    idx = jnp.arange(n_theta)
    wrapped = (idx < shift) if shift > 0 else (idx >= n_theta + shift)
    sel = wrapped[None, None, :, None, None]
    return jnp.where(sel, shifted, rolled)


def parallel_streaming(g: GKGrids, f_s: jnp.ndarray) -> jnp.ndarray:
    """v_par bhat.grad(theta) d f/d theta, 4th-order centred."""
    dfdt = (-_roll_ballooning(g, f_s, -2)
            + 8.0 * _roll_ballooning(g, f_s, -1)
            - 8.0 * _roll_ballooning(g, f_s, 1)
            + _roll_ballooning(g, f_s, 2)) / (12.0 * g.d_theta)
    return (g.vpar[None, None, None, :, None]
            * g.b_dot_grad[None, None, :, None, None] * dfdt)


def magnetic_drift(g: GKGrids, f_s: jnp.ndarray) -> jnp.ndarray:
    """i omega_D f with curvature/grad-B frequency from local geometry."""
    vpar2 = g.vpar[None, None, None, :, None] ** 2
    mu_b = (g.mu[None, None, None, None, :]
            * g.b_ratio[None, None, :, None, None])
    energy = 0.5 * vpar2 + mu_b
    xi2 = jnp.clip(vpar2 / jnp.maximum(vpar2 + 2.0 * mu_b, 1e-30), 0.0)
    kn = g.kappa_n[None, None, :, None, None]
    kg = g.kappa_g[None, None, :, None, None]
    omega_d = (g.ky[None, :, None, None, None] * 2.0 * energy
               * (kn * xi2 + kg * jnp.sqrt(xi2)))
    return 1j * omega_d * f_s


def collide_krook(cfg: NonlinearGKConfig, g: GKGrids,
                  f_s: jnp.ndarray) -> jnp.ndarray:
    return -cfg.nu_collision * g.kperp2[:, :, None, None, None] * f_s


def collide_conservative(cfg: NonlinearGKConfig, g: GKGrids,
                         f_s: jnp.ndarray) -> jnp.ndarray:
    """Pitch-angle + energy diffusion with (n, p_par, E) conservation.

    Same contract as the reference's Sugama-like model
    (``_gk_nonlinear_operators.py:171-210``): a velocity-space diffusion
    whose density / parallel-momentum / energy moments are projected out
    against the Maxwellian so the collision operator conserves them.
    """
    nu = cfg.nu_collision
    d2f = (jnp.roll(f_s, -1, axis=3) - 2.0 * f_s
           + jnp.roll(f_s, 1, axis=3)) / g.d_vpar ** 2
    d2f = d2f.at[:, :, :, 0, :].set(0.0)
    d2f = d2f.at[:, :, :, -1, :].set(0.0)

    vpar2 = g.vpar[None, None, None, :, None] ** 2
    mu_v = g.mu[None, None, None, None, :]
    v2 = vpar2 + 2.0 * mu_v
    nu_v = nu * jnp.minimum(1.0 / jnp.maximum(v2, 0.1) ** 1.5, 10.0)
    pitch = 2.0 * mu_v / jnp.maximum(v2, 0.01)
    cf = nu_v * pitch * d2f

    fm = g.maxwellian[None, None, None, :, :].astype(f_s.dtype)
    vpar5 = g.vpar[None, None, None, :, None].astype(f_s.dtype)
    energy5 = g.energy[None, None, None, :, :].astype(f_s.dtype)
    ones = jnp.ones_like(energy5)
    dv = g.d_vpar * g.d_mu

    basis = (ones, vpar5, energy5)
    moments = jnp.stack(
        [jnp.sum(cf * b, axis=(-2, -1)) * dv for b in basis], axis=0)
    gram = jnp.asarray(
        [[jnp.sum(jnp.real(a * b * fm)) * dv for b in basis] for a in basis],
        dtype=f_s.real.dtype)
    coeffs = jnp.tensordot(jnp.linalg.inv(gram).astype(f_s.dtype),
                           moments, axes=(1, 0))
    corr = (coeffs[0][..., None, None] * ones
            + coeffs[1][..., None, None] * vpar5
            + coeffs[2][..., None, None] * energy5) * fm
    return cf - corr


def gradient_drive(cfg: NonlinearGKConfig, g: GKGrids, phi: jnp.ndarray,
                   a_par=None, b_par=None) -> jnp.ndarray:
    """Background omega_* drive for all species, stacked."""
    ky5 = g.ky[None, :, None, None, None]
    energy5 = g.energy[None, None, None, :, :]
    fm = g.maxwellian[None, None, None, :, :]
    vpar5 = g.vpar[None, None, None, :, None]
    mu5 = g.mu[None, None, None, None, :]

    phi_eff = phi[:, :, :, None, None]
    if cfg.electromagnetic and a_par is not None:
        phi_eff = phi_eff - vpar5 * a_par[:, :, :, None, None]
    if cfg.electromagnetic and b_par is not None:
        phi_eff = phi_eff + mu5 * b_par[:, :, :, None, None]

    r_l_ne = max(cfg.r_l_ne, 0.1)
    eta_i = cfg.r_l_ti / r_l_ne if cfg.r_l_ne > 0 else 0.0
    omega_star_i = ky5 * cfg.r_l_ne * (1.0 + eta_i * (energy5 - 1.5))
    drive_i = -1j * omega_star_i * phi_eff * fm
    if cfg.n_species < 2:
        return drive_i[None]
    if cfg.kinetic_electrons:
        eta_e = cfg.r_l_te / r_l_ne if cfg.r_l_ne > 0 else 0.0
        omega_star_e = -ky5 * cfg.r_l_ne * (1.0 + eta_e * (energy5 - 1.5))
        drive_e = -1j * omega_star_e * phi_eff * fm
    else:
        drive_e = jnp.zeros_like(drive_i)
    return jnp.stack([drive_i, drive_e], axis=0)


def gk_rhs(cfg: NonlinearGKConfig, g: GKGrids,
           f: jnp.ndarray) -> jnp.ndarray:
    """Full Vlasov RHS; all species in one fused program."""
    phi = field_solve(cfg, g, f)
    collide = (collide_conservative
               if cfg.collision_model == "conservative" else collide_krook)

    def species_terms(f_s, v_scale, charge_sign, active):
        terms = -v_scale * parallel_streaming(g, f_s)
        terms = terms - charge_sign * magnetic_drift(g, f_s)
        if cfg.nonlinear:
            terms = terms - exb_bracket(g, phi, f_s)
        if cfg.collisions:
            terms = terms + collide(cfg, g, f_s)
        hyper = (-cfg.hyper_coeff
                 * g.kperp2[:, :, None, None, None] ** (cfg.hyper_order // 2)
                 * f_s)
        return active * (terms + hyper)

    out = [species_terms(f[0], 1.0, 1.0, 1.0)]
    if cfg.n_species >= 2:
        active = 1.0 if cfg.kinetic_electrons else 0.0
        v_scale = g.vth_ratio_e if cfg.kinetic_electrons else 1.0
        out.append(species_terms(f[1], v_scale, -1.0, active))
    dfdt = jnp.stack(out, axis=0)

    a_par = ampere_solve(cfg, g, f) if cfg.electromagnetic else None
    b_par = bpar_solve(cfg, g, f) if cfg.electromagnetic else None
    dfdt = dfdt + gradient_drive(cfg, g, phi, a_par, b_par)[:cfg.n_species]

    if cfg.zonal_damping_rate > 0.0:
        ky_zero = (jnp.abs(g.ky)[None, :] < 1e-10).astype(f.real.dtype)
        dfdt = dfdt - (cfg.zonal_damping_rate
                       * f * ky_zero[None, :, :, None, None, None])
    return dfdt


# ---------------------------------------------------------------------------
# Time stepping + diagnostics
# ---------------------------------------------------------------------------

def cfl_dt(cfg: NonlinearGKConfig, g: GKGrids, phi: jnp.ndarray):
    """Adaptive CFL dt (traceable; reference ``_gk_nonlinear_time.py:95``)."""
    if not cfg.cfl_adapt:
        return jnp.asarray(cfg.dt, phi.real.dtype)
    phi_max = jnp.max(jnp.abs(phi)) + 1e-30
    kmax = jnp.maximum(jnp.max(jnp.abs(g.kx)), jnp.max(jnp.abs(g.ky)))
    vmax = jnp.maximum(jnp.max(jnp.abs(g.vpar)), 1.0)
    v_scale = g.vth_ratio_e if (cfg.kinetic_electrons) else 1.0
    v_exb = kmax * phi_max
    v_par = vmax * v_scale * jnp.max(jnp.abs(g.b_dot_grad))
    v_hyper = cfg.hyper_coeff * jnp.max(g.kperp2) ** (cfg.hyper_order // 2)
    dt = cfg.cfl_factor / jnp.maximum(v_exb + v_par + v_hyper, 1e-30)
    return jnp.minimum(dt, cfg.dt)


def rk4_step(cfg: NonlinearGKConfig, g: GKGrids,
             state: GKState) -> GKState:
    phi = field_solve(cfg, g, state.f)
    dt = cfl_dt(cfg, g, phi)
    f = state.f
    k1 = gk_rhs(cfg, g, f)
    k2 = gk_rhs(cfg, g, f + 0.5 * dt * k1)
    k3 = gk_rhs(cfg, g, f + 0.5 * dt * k2)
    k4 = gk_rhs(cfg, g, f + dt * k3)
    f1 = f + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return GKState(f=f1, time=state.time + dt)


def heat_flux(cfg: NonlinearGKConfig, g: GKGrids, f: jnp.ndarray,
              phi: jnp.ndarray):
    """Gyro-Bohm heat fluxes Q_i, Q_e (reference
    ``_gk_nonlinear_time.py:114-150``)."""
    energy_w = g.energy
    ky_col = g.ky[None, :, None]
    ky_mask = (g.ky > 1e-10).astype(phi.real.dtype)[None, :, None]

    def one(f_s):
        pressure = velocity_moment(f_s, energy_w, g)
        flux_k = 1j * ky_col * jnp.conj(phi) * pressure
        return jnp.sum(jnp.real(flux_k) * ky_mask)

    q_i = one(f[0])
    q_e = one(f[1]) if cfg.kinetic_electrons else 0.5 * q_i
    return q_i, q_e


def diagnostics(cfg: NonlinearGKConfig, g: GKGrids, state: GKState):
    phi = field_solve(cfg, g, state.f)
    q_i, q_e = heat_flux(cfg, g, state.f, phi)
    phi_rms = jnp.sqrt(jnp.mean(jnp.abs(phi) ** 2))
    ky0 = jnp.argmin(jnp.abs(g.ky))
    zonal = jnp.sqrt(jnp.mean(jnp.abs(phi[:, ky0, :]) ** 2))
    fm = jnp.maximum(g.maxwellian[None, None, None, :, :], 1e-30)
    w = jnp.sum(jnp.abs(state.f) ** 2 / fm) * g.d_vpar * g.d_mu
    return q_i, q_e, phi_rms, zonal, 0.5 * w


def init_state(cfg: NonlinearGKConfig, g: GKGrids, amplitude: float = 1e-5,
               seed: int = 42) -> GKState:
    """Maxwellian-weighted random perturbation on the dealiased modes."""
    cdt = jnp.complex64 if cfg.dtype == "complex64" else jnp.complex128
    key = jax.random.PRNGKey(seed)
    shape = (cfg.n_species, cfg.n_kx, cfg.n_ky, cfg.n_theta,
             cfg.n_vpar, cfg.n_mu)
    kr, ki = jax.random.split(key)
    noise = (jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
    f = (amplitude * noise
         * g.maxwellian[None, None, None, None, :, :]
         * g.dealias_mask[None, :, :, None, None, None]).astype(cdt)
    f = f.at[:, 0, 0, :, :, :].set(0.0)
    return GKState(f=f, time=jnp.asarray(0.0, jnp.float32
                                         if cfg.dtype == "complex64"
                                         else default_float()))


@partial(jax.jit, static_argnums=(0,))
def _run_compiled(cfg: NonlinearGKConfig, g: GKGrids, state: GKState):
    n_saves = max(cfg.n_steps // cfg.save_interval, 1)

    def inner(s, _):
        return rk4_step(cfg, g, s), None

    def outer(s, _):
        s, _ = jax.lax.scan(inner, s, None, length=cfg.save_interval)
        q_i, q_e, phi_rms, zonal, w = diagnostics(cfg, g, s)
        return s, (s.time, q_i, q_e, phi_rms, zonal, w)

    state, (t, qi, qe, pr, zr, w) = jax.lax.scan(
        outer, state, None, length=n_saves)
    return state, GKTrace(times=t, q_ion=qi, q_elec=qe, phi_rms=pr,
                          zonal_rms=zr, free_energy=w)


def run_nonlinear_gk(cfg: NonlinearGKConfig, geometry=None,
                     state: GKState | None = None,
                     amplitude: float = 1e-5, seed: int = 42):
    """Whole nonlinear run in one compiled program.

    Returns (final GKState, GKTrace of diagnostics every save_interval).
    """
    g = build_grids(cfg, geometry)
    if state is None:
        state = init_state(cfg, g, amplitude=amplitude, seed=seed)
    return _run_compiled(cfg, g, state)
