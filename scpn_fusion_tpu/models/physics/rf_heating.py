"""RF heating: ICRH Hamiltonian ray tracing + ECRH deposition.

JAX-native equivalent of the reference RF stack (``core/rf_heating.py:93-526``):

* ICRH (50 MHz fast-wave) ray tracing — the reference integrates the
  Hamiltonian ray equations dr/dt = -dD/dk, dk/dt = +dD/dr per ray with
  ``scipy.odeint`` and finite-difference derivatives of the dispersion
  relation, freezing each ray at its caustic.  Here the WHOLE bundle
  advances together: one fixed-step RK4 inside ``lax.scan``, ``vmap`` over
  rays, and the dispersion derivatives come from ``jax.grad`` (exact, no
  eps tuning).  Caustic freeze = `jnp.where` forward-fill of the last
  finite state — deterministic by construction, the property the reference
  needed a post-pass (``_freeze_ray_at_caustic``) to recover.
* ICRH power deposition (``compute_power_deposition``) — per-segment
  cyclotron damping exp(-delta^2); the sequential Beer-Lambert power drain
  along each ray becomes a closed-form ``cumsum`` in log space, and the
  radial binning is a one-hot matmul instead of a scatter loop.
* ECRH (170 GHz) Gaussian deposition at the cold resonance layer with
  Doppler width + single-pass optical-depth efficiency
  (``ECRHHeatingSystem.compute_deposition``).

All functions are jit-compatible and differentiable w.r.t. plasma/launch
parameters (launcher optimisation by ``jax.grad``).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

E_CHARGE = 1.602176634e-19
M_E = 9.1093837e-31
M_D = 3.34e-27
MU_0 = 4.0e-7 * math.pi
EPS_0 = 8.8541878e-12


@dataclasses.dataclass(frozen=True)
class ICRHParams:
    """Fast-wave launch + plasma model (reference ``RFHeatingSystem``)."""

    freq_hz: float = 50e6
    b0_tesla: float = 5.3
    r0_major: float = 6.2
    a_minor: float = 2.0
    n0_m3: float = 1e20
    blob_sigma_sq: float = 2.0     # Gaussian density blob variance [m^2]
    t_ion_kev: float = 10.0
    r_antenna: float = 9.0
    k0: float = 10.0               # launch wavenumber [1/m]

    @property
    def omega(self) -> float:
        return 2.0 * math.pi * self.freq_hz

    @property
    def b_resonance(self) -> float:
        """Fundamental D cyclotron resonance field omega = qB/m."""
        return self.omega * M_D / E_CHARGE


def _density(p: ICRHParams, r, z):
    """Gaussian blob density surrogate (reference ``get_plasma_params``)."""
    dist_sq = (r - p.r0_major) ** 2 + z**2
    return p.n0_m3 * jnp.exp(-dist_sq / p.blob_sigma_sq)


def icrh_dispersion(p: ICRHParams, r, z, k_r, k_z):
    """Warm-plasma fast-wave dispersion D = k^2 v_A^2 (1 + 3/4 k^2 rho_i^2) - w^2.

    Smoothly gated to the vacuum value D=1 below the cutoff density so the
    ray Hamiltonian stays differentiable (the reference branches on
    n_e < 1e18 which would create a non-differentiable kink under grad).
    """
    r_safe = jnp.maximum(r, 0.1)
    b_tor = p.b0_tesla * p.r0_major / r_safe
    n_e = _density(p, r, z)

    # Alfven speed, FLR thermal correction (deuterium).
    v_a_sq = b_tor**2 / (MU_0 * jnp.maximum(n_e, 1e16) * M_D)
    v_thi = math.sqrt(2.0 * p.t_ion_kev * 1e3 * E_CHARGE / M_D)
    rho_i = M_D * v_thi / (E_CHARGE * b_tor)
    k_sq = k_r**2 + k_z**2
    flr = 1.0 + 0.75 * k_sq * rho_i**2

    d_plasma = k_sq * v_a_sq * flr - p.omega**2
    # Normalise by omega^2 so plasma and vacuum branches share a scale.
    d_plasma = d_plasma / p.omega**2
    in_plasma = jax.nn.sigmoid((jnp.log10(jnp.maximum(n_e, 1.0)) - 18.0) * 4.0)
    return in_plasma * d_plasma + (1.0 - in_plasma) * 1.0


class RayBundle(NamedTuple):
    r: jnp.ndarray       # (n_rays, n_steps)
    z: jnp.ndarray
    k_r: jnp.ndarray
    k_z: jnp.ndarray
    frozen: jnp.ndarray  # (n_rays, n_steps) bool — past the caustic


@partial(jax.jit, static_argnames=("p", "n_rays", "n_steps"))
def trace_icrh_rays(p: ICRHParams, *, n_rays: int = 10, n_steps: int = 160,
                    path_length_m: float = 8.0) -> RayBundle:
    """Trace the antenna ray bundle (reference ``trace_rays``) on device.

    Arc-length parametrised Hamiltonian rays: dr/ds = g/|g| with
    g = dD/dk and dk/ds = -(dD/dr)/|g| — the independent variable is
    metres of path, so the step size is physical regardless of the local
    group speed (the reference's raw-time parametrisation makes rays crawl
    in dense plasma and blow up near caustics, which is why it needs
    LSODA + a freeze post-pass).  RK4 with exact ``jax.grad`` derivatives;
    any non-finite step still freezes the ray at its last finite state.
    """
    dt = path_length_m / n_steps

    def hamiltonian(state):
        r, z, k_r, k_z = state
        return icrh_dispersion(p, r, z, k_r, k_z)

    grad_d = jax.grad(hamiltonian)

    def rhs(state):
        # dr/ds = +dD/dk normalised to unit speed, dk/ds = -dD/dr / |dD/dk|
        # (launch with k_R < 0 propagates inward).
        d_r, d_z, d_kr, d_kz = grad_d(state)
        g_norm = jnp.maximum(jnp.sqrt(d_kr**2 + d_kz**2), 1e-12)
        return jnp.stack([d_kr, d_kz, -d_r, -d_z]) / g_norm

    def rk4(state):
        k1 = rhs(state)
        k2 = rhs(state + 0.5 * dt * k1)
        k3 = rhs(state + 0.5 * dt * k2)
        k4 = rhs(state + dt * k3)
        return state + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    def step(carry, _):
        state, frozen = carry
        new = rk4(state)
        bad = frozen | ~jnp.all(jnp.isfinite(new))
        state = jnp.where(bad, state, new)
        return (state, bad), (state, bad)

    def trace_one(z_launch):
        init = jnp.asarray([p.r_antenna, z_launch, -p.k0, 0.0])
        _, (traj, frozen) = jax.lax.scan(
            step, (init, jnp.bool_(False)), None, length=n_steps)
        return traj, frozen

    z_spread = jnp.linspace(-1.0, 1.0, n_rays)
    traj, frozen = jax.vmap(trace_one)(z_spread)   # (n_rays, n_steps, 4)
    return RayBundle(traj[..., 0], traj[..., 1], traj[..., 2], traj[..., 3],
                     frozen)


@partial(jax.jit, static_argnames=("p", "n_radial_bins"))
def icrh_power_deposition(p: ICRHParams, rays: RayBundle,
                          p_rf_mw: float = 20.0, *,
                          n_radial_bins: int = 50):
    """Radial deposition profile from cyclotron damping along each ray
    (reference ``compute_power_deposition``), fully vectorised.

    Beer-Lambert drain P_j = P_0 exp(-sum_{i<=j} alpha_i ds_i) is a cumsum;
    the per-bin scatter becomes a one-hot contraction.
    Returns (rho_bins, P_dep [MW/m^3], absorption_efficiency).
    """
    r, z = rays.r, rays.z
    n_rays = r.shape[0]
    v_thi = math.sqrt(2.0 * 20.0 * 1e3 * E_CHARGE / M_D)

    r_mid = 0.5 * (r[:, 1:] + r[:, :-1])
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    ds = jnp.sqrt((r[:, 1:] - r[:, :-1]) ** 2 + (z[:, 1:] - z[:, :-1]) ** 2)

    b_local = p.b0_tesla * p.r0_major / jnp.maximum(r_mid, 0.1)
    omega_ci = E_CHARGE * b_local / M_D
    delta = (p.omega - omega_ci) / jnp.maximum(10.0 * v_thi, 1e6)
    alpha = 0.5 * jnp.exp(-delta**2) / p.a_minor

    # Remaining power before each segment, then per-segment absorption.
    tau = jnp.cumsum(alpha * ds, axis=1)
    p_per_ray = p_rf_mw / max(n_rays, 1)
    p_before = p_per_ray * jnp.exp(-jnp.concatenate(
        [jnp.zeros((n_rays, 1)), tau[:, :-1]], axis=1))
    dp = p_before * (1.0 - jnp.exp(-alpha * ds))

    rho = jnp.minimum(jnp.sqrt((r_mid - p.r0_major) ** 2 + z_mid**2)
                      / p.a_minor, 1.0)
    bin_idx = jnp.clip((rho * n_radial_bins).astype(jnp.int32), 0,
                       n_radial_bins - 1)
    rho_bins = jnp.linspace(0.0, 1.0, n_radial_bins)

    # Shell volumes (reference geometry: dV = (2 pi R)(2 pi r_inner a drho)).
    dr = 1.0 / n_radial_bins
    r_inner = rho_bins[bin_idx] * p.a_minor
    dv = jnp.maximum(2.0 * jnp.pi * r_mid * 2.0 * jnp.pi * r_inner
                     * p.a_minor * dr, 1e-6)

    onehot = jax.nn.one_hot(bin_idx.reshape(-1), n_radial_bins,
                            dtype=dp.dtype)
    p_dep = (dp / dv).reshape(-1) @ onehot            # MW/m^3 per bin
    efficiency = jnp.clip(jnp.sum(dp) / jnp.maximum(p_rf_mw, 1e-12), 0.0, 1.0)
    return rho_bins, p_dep, efficiency


@dataclasses.dataclass(frozen=True)
class ECRHParams:
    """ECRH launcher (reference ``ECRHHeatingSystem``)."""

    b0_tesla: float = 5.3
    r0_major: float = 6.2
    a_minor: float = 2.0
    freq_ghz: float = 170.0
    harmonic: int = 1

    @property
    def omega(self) -> float:
        return 2.0 * math.pi * self.freq_ghz * 1e9

    @property
    def resonance_radius(self) -> float:
        """Major radius where n Omega_ce = omega."""
        b_res = self.omega * M_E / (self.harmonic * E_CHARGE)
        return self.b0_tesla * self.r0_major / b_res


@partial(jax.jit, static_argnames=("p", "n_radial_bins"))
def ecrh_deposition(p: ECRHParams, *, p_ecrh_mw: float = 20.0,
                    t_e_kev=20.0, n_e_m3=1e20, launch_angle_deg=0.0,
                    n_radial_bins: int = 50):
    """Gaussian deposition at the EC resonance with Doppler width and
    single-pass O-mode optical-depth efficiency (reference
    ``ECRHHeatingSystem.compute_deposition``).  Differentiable w.r.t.
    (t_e, n_e, launch angle) for launcher optimisation."""
    rho_res = jnp.abs(p.resonance_radius - p.r0_major) / p.a_minor

    t_e = jnp.maximum(jnp.asarray(t_e_kev, jnp.float32), 0.01)
    v_the = jnp.sqrt(2.0 * t_e * (1e3 * E_CHARGE / M_E))
    theta = jnp.deg2rad(jnp.asarray(launch_angle_deg, jnp.float32))
    obliquity = jnp.clip(jnp.cos(theta) ** 2, 0.05, 1.0)
    delta_rho = jnp.maximum(
        v_the / (p.omega * p.a_minor) * 50.0
        * (1.0 + 0.35 * jnp.abs(jnp.sin(theta))), 0.02)

    rho = jnp.linspace(0.0, 1.0, n_radial_bins)
    r_local = p.r0_major + rho * p.a_minor
    dv = jnp.maximum(2.0 * jnp.pi * r_local * 2.0 * jnp.pi * rho * p.a_minor
                     * p.a_minor / n_radial_bins, 1e-6)
    p_dep = jnp.exp(-((rho - rho_res) ** 2) / (2.0 * delta_rho**2)) / dv

    # omega_pe^2/omega^2 with the e^2/(m_e eps0) prefactor folded host-side
    # (f32-safe: e^2 ~ 2.6e-38 underflows in f32).
    wpe_sq_per_n = E_CHARGE**2 / (M_E * EPS_0)      # host double
    wpe_ratio_sq = jnp.asarray(n_e_m3, jnp.float32) * (wpe_sq_per_n
                                                       / p.omega**2)
    overlap = jnp.where(rho_res <= 1.0, 1.0,
                        jnp.exp(-(((rho_res - 1.0) / 0.18) ** 2)))
    tau_opt = wpe_ratio_sq * 20.0 * p.harmonic * obliquity * overlap
    efficiency = jnp.clip(1.0 - jnp.exp(-tau_opt), 0.01, 0.99)

    total = jnp.maximum(jnp.sum(p_dep), 1e-12)
    p_dep = p_dep * (p_ecrh_mw * efficiency / total)
    return rho, p_dep, efficiency
