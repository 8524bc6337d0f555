"""Stellarator geometry, neoclassical transport, and ISS04 confinement.

JAX-native port of the reference's ``core/stellarator_geometry.py:34-340``
(Boozer-coordinate flux surfaces with helical mirror + axis-excursion
|B| modulation, Nemov-style effective-ripple spectrum estimate, ISS04
scaling, 1/nu neoclassical chi; physics per Boozer 1981, Yamada 2005,
Nemov 1999, Beidler 2011).  Everything is ``jnp`` and jittable; the
effective-ripple spectral estimate uses ``jnp.fft.rfft`` on-device, and
``stellarator_neoclassical_chi`` is differentiable in (T, n_e) so the
stellarator transport lane composes with gradient-based scans.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class StellaratorConfig:
    """Device + magnetic configuration (hashable: jit-static).

    Fields mirror the reference's ``StellaratorConfig`` (:34-88).
    """

    n_fp: int = 5
    r0: float = 5.5
    a: float = 0.53
    b0: float = 2.5
    iota_0: float = 0.85
    iota_a: float = 0.97
    mirror_ratio: float = 0.05
    helical_excursion: float = 0.2

    def __post_init__(self) -> None:
        if self.n_fp < 1:
            raise ValueError("n_fp must be >= 1")
        for name in ("r0", "a", "b0"):
            if getattr(self, name) <= 0.0:
                raise ValueError(f"{name} must be > 0")


def w7x_config() -> StellaratorConfig:
    """Wendelstein 7-X-like preset (reference :105-121)."""
    return StellaratorConfig(n_fp=5, r0=5.5, a=0.53, b0=2.5,
                             iota_0=0.85, iota_a=0.97,
                             mirror_ratio=0.05, helical_excursion=0.2)


def iota_profile(cfg: StellaratorConfig, s):
    """Rotational transform iota(s), linear in the flux label."""
    return cfg.iota_0 + (cfg.iota_a - cfg.iota_0) * jnp.asarray(s)


@partial(jax.jit, static_argnames=("cfg", "n_theta", "n_phi"))
def stellarator_flux_surface(cfg: StellaratorConfig, s,
                             n_theta: int = 64, n_phi: int = 64):
    """(R, Z, |B|) on one Boozer flux surface (reference :144-199).

    |B| modulation: toroidal (eps_t cos th), helical mirror
    (eps_h cos(N phi - iota th)), and helical-axis curvature.
    """
    s = jnp.clip(jnp.asarray(s), 1e-6, 1.0)
    r = cfg.a * jnp.sqrt(s)
    iota = iota_profile(cfg, s)

    theta = jnp.linspace(0.0, 2.0 * jnp.pi, n_theta, endpoint=False)
    phi = jnp.linspace(0.0, 2.0 * jnp.pi, n_phi, endpoint=False)
    th, ph = jnp.meshgrid(theta, phi, indexing="ij")

    delta_r = cfg.helical_excursion * jnp.cos(cfg.n_fp * ph)
    r_maj = cfg.r0 + r * jnp.cos(th) + delta_r
    z = r * jnp.sin(th) + cfg.helical_excursion * jnp.sin(cfg.n_fp * ph)

    eps_t = r / cfg.r0
    eps_h = cfg.mirror_ratio * jnp.sqrt(s)
    axis_curv = (cfg.helical_excursion / cfg.r0) * jnp.sqrt(s)
    b = cfg.b0 * (1.0
                  - eps_t * jnp.cos(th)
                  - eps_h * jnp.cos(cfg.n_fp * ph - iota * th)
                  - axis_curv * jnp.cos(cfg.n_fp * ph))
    return r_maj, z, b


@partial(jax.jit, static_argnames=("cfg",))
def effective_ripple(cfg: StellaratorConfig, s) -> jnp.ndarray:
    """Effective helical ripple eps_eff (Nemov-style field-spectrum
    estimate, reference :200-249): remove the toroidally-averaged |B|
    per poloidal ring, measure the non-axisymmetric RMS and its spectral
    concentration at the N_fp harmonic."""
    if cfg.mirror_ratio == 0.0 and cfg.helical_excursion == 0.0:
        return jnp.asarray(0.0)
    n_phi = max(64, 16 * cfg.n_fp)
    _, _, b = stellarator_flux_surface(cfg, s, n_theta=96, n_phi=n_phi)
    b_mean = jnp.mean(b)
    b_norm = b / jnp.maximum(b_mean, 1e-30) - 1.0
    nonax = b_norm - jnp.mean(b_norm, axis=1, keepdims=True)
    rms = jnp.sqrt(jnp.mean(nonax**2))

    spec = jnp.fft.rfft(nonax, axis=1)
    harmonic = min(cfg.n_fp, n_phi // 2)
    power_h = jnp.mean(jnp.abs(spec[:, harmonic]) ** 2)
    power_t = jnp.mean(jnp.sum(jnp.abs(spec[:, 1:]) ** 2, axis=1))
    concentration = power_h / jnp.maximum(power_t, 1e-30)

    helical = jnp.sqrt(2.0) * rms * jnp.sqrt(jnp.maximum(concentration, 0.0))
    aspect = jnp.sqrt(cfg.a / cfg.r0)
    eps_eff = helical**1.5 * aspect / jnp.sqrt(float(cfg.n_fp))
    return jnp.clip(eps_eff, 0.0, 1.0)


def iss04_tau_e(cfg: StellaratorConfig, n_e19, p_heat_mw) -> jnp.ndarray:
    """ISS04 stellarator confinement scaling (Yamada 2005 Eq. 4,
    reference :251-294): tau = 0.134 a^2.28 R^0.64 P^-0.61 n^0.54
    B^0.84 iota_{2/3}^0.41."""
    iota_ref = iota_profile(cfg, 2.0 / 3.0)
    return (0.134 * cfg.a**2.28 * cfg.r0**0.64
            * jnp.asarray(p_heat_mw) ** -0.61
            * jnp.asarray(n_e19) ** 0.54
            * cfg.b0**0.84 * iota_ref**0.41)


_M_D = 3.344e-27          # deuteron mass [kg]
_E_KEV_J = 1.602176634e-16
_E_CHARGE = 1.602176634e-19
_EPS0 = 8.8541878128e-12
_LN_LAMBDA = 17.0


@partial(jax.jit, static_argnames=("cfg",))
def stellarator_neoclassical_chi(cfg: StellaratorConfig, s, t_kev,
                                 n_e19) -> jnp.ndarray:
    """1/nu-regime neoclassical chi ~ eps_eff^1.5 v_th^2 / (nu R N_fp)
    (Beidler 2011, reference :296-340)."""
    eps_eff = effective_ripple(cfg, s)
    t_kev = jnp.maximum(jnp.asarray(t_kev), 1e-3)
    n_m3 = jnp.maximum(jnp.asarray(n_e19), 1e-3) * 1e19
    v_th = jnp.sqrt(t_kev * _E_KEV_J / _M_D)
    nu = (n_m3 * _LN_LAMBDA * _E_CHARGE**4
          / (4.0 * jnp.pi * _EPS0**2 * _M_D**2 * v_th**3))
    chi = eps_eff**1.5 * v_th**2 / (jnp.maximum(nu, 1e-30)
                                    * cfg.r0 * float(cfg.n_fp))
    return jnp.clip(chi, 0.0, 1e6)
