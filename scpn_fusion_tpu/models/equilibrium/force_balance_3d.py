"""Reduced 3D equilibrium: Fourier flux-coordinate map + force balance.

Compiled redesign of the reference's ``core/equilibrium_3d.py``:

* ``Geometry3D`` — the VMEC-like Fourier-parameterised map
  (rho, theta, phi) -> (R, Z, phi) with elongation / triangularity /
  ``n != 0`` shaping (reference ``VMECStyleEquilibrium3D``,
  :62-246).  Mode indices (m, n) are STATIC (hashable tuples on the
  frozen dataclass); mode AMPLITUDES are a traced ``(K, 4)`` array
  ``[r_cos, r_sin, z_cos, z_sin]`` — so the geometry map is a pure
  function of the decision variables and the whole force-balance solve
  differentiates through it.
* ``force_residual`` — volume-RMS of ``J x B - grad p`` on a
  (rho, theta, phi) sampling grid with the reference's reduced field
  model (toroidal ``B0 R0 / R``, cylindrical-Ampere poloidal field,
  ``p ~ (1-rho^2)^alpha`` / ``J ~ (1-rho^2)^beta`` profiles;
  reference ``ForceBalance3D`` :309-440).
* ``solve_force_balance_3d`` — spectral variational minimisation of the
  residual over the mode amplitudes.  The reference estimates gradients
  by central finite differences over every coefficient (2 x 4K residual
  evaluations per iteration) host-side; here the gradient is EXACT
  (``jax.value_and_grad`` through the whole geometry + physics chain)
  and the full Armijo-backtracked descent runs inside one
  ``lax.while_loop`` under jit.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

MU0 = 4.0e-7 * jnp.pi


@dataclasses.dataclass(frozen=True)
class Geometry3D:
    """VMEC-like reduced 3D geometry (hashable: jit-static).

    ``modes_m`` / ``modes_n`` are the Fourier indices of the shaping
    harmonics; their amplitudes live OUTSIDE this dataclass (traced).
    """

    r_axis: float = 6.2
    z_axis: float = 0.0
    a_minor: float = 2.0
    kappa: float = 1.0
    triangularity: float = 0.0
    nfp: int = 1
    modes_m: tuple[int, ...] = (0, 0, 1, 1, 2, 2)
    modes_n: tuple[int, ...] = (0, 1, 0, 1, 0, 1)

    def __post_init__(self) -> None:
        if self.a_minor <= 0.0:
            raise ValueError("a_minor must be > 0")
        if self.kappa <= 0.0:
            raise ValueError("kappa must be > 0")
        if self.nfp < 1:
            raise ValueError("nfp must be >= 1")
        if len(self.modes_m) != len(self.modes_n):
            raise ValueError("modes_m and modes_n must have equal length")

    @property
    def n_modes(self) -> int:
        return len(self.modes_m)

    def zero_amplitudes(self, dtype=jnp.float32) -> jnp.ndarray:
        return jnp.zeros((self.n_modes, 4), dtype)


def flux_to_cylindrical(geom: Geometry3D, amps: jnp.ndarray,
                        rho, theta, phi):
    """(rho, theta, phi) -> (R, Z, phi); amps is (K, 4)
    [r_cos, r_sin, z_cos, z_sin] (reference ``flux_to_cylindrical``
    :206-232, vectorised over all K harmonics at once)."""
    rho_c = jnp.clip(rho, 0.0, 1.25)
    delta = jnp.clip(geom.triangularity, -0.95, 0.95)
    theta_geo = theta + delta * jnp.sin(theta)
    minor = geom.a_minor * rho_c
    r_val = geom.r_axis + minor * jnp.cos(theta_geo)
    z_val = geom.z_axis + geom.kappa * minor * jnp.sin(theta)

    m = jnp.asarray(geom.modes_m, rho_c.dtype)          # (K,)
    n = jnp.asarray(geom.modes_n, rho_c.dtype) * geom.nfp
    # phase[k, ...] = m_k theta - n_k nfp phi  (broadcast over the grid).
    phase = (m[:, None] * theta.reshape(-1)[None, :]
             - n[:, None] * phi.reshape(-1)[None, :])
    cos_p, sin_p = jnp.cos(phase), jnp.sin(phase)
    d_r = (amps[:, 0][:, None] * cos_p + amps[:, 1][:, None] * sin_p)
    d_z = (amps[:, 2][:, None] * cos_p + amps[:, 3][:, None] * sin_p)
    minor_flat = minor.reshape(-1)[None, :]
    r_val = r_val + (minor_flat * d_r).sum(0).reshape(r_val.shape)
    z_val = z_val + (minor_flat * d_z).sum(0).reshape(z_val.shape)
    return r_val, z_val, phi


def flux_to_cartesian(geom: Geometry3D, amps: jnp.ndarray, rho, theta, phi):
    r_val, z_val, phi_val = flux_to_cylindrical(geom, amps, rho, theta, phi)
    return r_val * jnp.cos(phi_val), r_val * jnp.sin(phi_val), z_val


@dataclasses.dataclass(frozen=True)
class ForceBalanceConfig:
    """Physics profiles + solver knobs (reference ``ForceBalance3D.__init__``
    + ``solve`` signature, condensed and hashable)."""

    b0_tesla: float = 5.3
    r0_major: float = 6.2
    p0_pa: float = 5e5
    j0_ma_m2: float = 1.0
    pressure_exp: float = 2.0
    current_exp: float = 1.5
    n_rho: int = 12
    n_theta: int = 24
    n_phi: int = 16
    max_iterations: int = 20
    tolerance: float = 1e-4
    # Initial trial length along the NORMALISED gradient direction; the
    # objective is residual/res0, so steps are dimensionless and the
    # Armijo ladder is scale-free (the reference's raw-residual lr=0.01
    # is badly scaled: its gradients are O(1e4), so Armijo rejects to
    # micro-steps — measured 1.7x/20 iters vs 3.6x with this scheme).
    step0: float = 0.5
    armijo_c: float = 1e-4
    armijo_backtracks: int = 12


def _profiles(cfg: ForceBalanceConfig, rho):
    rho_c = jnp.clip(rho, 0.0, 1.0)
    p = cfg.p0_pa * (1.0 - rho_c**2) ** cfg.pressure_exp
    j_phi = cfg.j0_ma_m2 * 1e6 * (1.0 - rho_c**2) ** cfg.current_exp
    return p, j_phi


@partial(jax.jit, static_argnames=("geom", "cfg"))
def force_residual(amps: jnp.ndarray, geom: Geometry3D,
                   cfg: ForceBalanceConfig) -> jnp.ndarray:
    """Volume-RMS of ``J x B - grad p`` on the sampling grid (reference
    ``compute_force_residual`` :374-422, same reduced field model)."""
    dtype = amps.dtype
    rho_pts = jnp.linspace(0.05, 0.95, cfg.n_rho, dtype=dtype)
    th_pts = jnp.linspace(0.0, 2.0 * jnp.pi, cfg.n_theta,
                          endpoint=False, dtype=dtype)
    ph_pts = jnp.linspace(0.0, 2.0 * jnp.pi, cfg.n_phi,
                          endpoint=False, dtype=dtype)
    rho_g, th_g, ph_g = jnp.meshgrid(rho_pts, th_pts, ph_pts, indexing="ij")

    r_val, z_val, _ = flux_to_cylindrical(geom, amps, rho_g, th_g, ph_g)

    # Radial pressure gradient mapped to (R, Z) by the flux-coordinate
    # chain rule (reference's drho/dR ~ cos th / a, drho/dZ ~ sin th / ka).
    drho = 0.01
    p_plus, _ = _profiles(cfg, rho_g + drho)
    p_minus, _ = _profiles(cfg, rho_g - drho)
    dp_drho = (p_plus - p_minus) / (2.0 * drho)
    grad_p_r = dp_drho * jnp.cos(th_g) / geom.a_minor
    grad_p_z = dp_drho * jnp.sin(th_g) / (geom.kappa * geom.a_minor)

    # Reduced field model: B_phi = B0 R0 / R; poloidal field from
    # cylindrical Ampere on the current profile.
    _, j_phi = _profiles(cfg, rho_g)
    b_theta = MU0 * j_phi * geom.a_minor * jnp.clip(rho_g, 0.0, 1.0) / 2.0
    theta_approx = jnp.arctan2(z_val - geom.z_axis, r_val - geom.r_axis)
    b_r = -b_theta * jnp.sin(theta_approx)
    b_z = b_theta * jnp.cos(theta_approx)

    f_r = j_phi * b_z - grad_p_r
    f_z = -j_phi * b_r - grad_p_z
    return jnp.sqrt(jnp.mean(f_r**2 + f_z**2))


class ForceBalanceResult(NamedTuple):
    amplitudes: jnp.ndarray          # (K, 4) optimised mode amplitudes
    residual: jnp.ndarray            # final volume-RMS force residual
    initial_residual: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    history: jnp.ndarray             # (max_iterations + 1,) residuals


@partial(jax.jit, static_argnames=("geom", "cfg"))
def solve_force_balance_3d(
    geom: Geometry3D,
    cfg: ForceBalanceConfig = ForceBalanceConfig(),
    amps0: jnp.ndarray | None = None,
) -> ForceBalanceResult:
    """Minimise the force residual over the Fourier amplitudes.

    Exact-gradient descent (``jax.value_and_grad`` through geometry +
    physics) with Armijo backtracking, the whole loop one compiled
    ``lax.while_loop`` (reference ``solve`` :449-560 semantics; its
    central-difference gradient stack is replaced by autodiff).
    """
    if amps0 is None:
        amps0 = geom.zero_amplitudes()
    dtype = amps0.dtype

    res0 = force_residual(amps0, geom, cfg)
    # Scale-free objective: residual / res0 (f0 = 1), so Armijo steps are
    # dimensionless regardless of the pressure/current magnitudes.
    val_grad = jax.value_and_grad(
        lambda a: force_residual(a, geom, cfg) / res0)

    hist0 = jnp.full((cfg.max_iterations + 1,), jnp.nan, dtype)
    hist0 = hist0.at[0].set(res0)
    tol_f = cfg.tolerance / jnp.maximum(res0, 1e-30)

    def cond(carry):
        k, _, f_val, _ = carry
        return (k < cfg.max_iterations) & (f_val > tol_f)

    def body(carry):
        k, amps, f_val, hist = carry
        value, grad = val_grad(amps)
        gnorm = jnp.sqrt(jnp.sum(grad * grad))
        direction = grad / jnp.maximum(gnorm, 1e-30)

        # Armijo backtracking over a fixed ladder of halved trial lengths
        # along the normalised direction: pick the LARGEST passing step
        # (compiled analogue of the reference's sequential halving).
        steps = cfg.step0 * 0.5 ** jnp.arange(
            cfg.armijo_backtracks, dtype=dtype)

        def trial(step):
            f_trial = force_residual(amps - step * direction, geom,
                                     cfg) / res0
            ok = f_trial < value - cfg.armijo_c * step * gnorm
            return ok, f_trial

        ok, f_trials = jax.vmap(trial)(steps)
        any_ok = jnp.any(ok)
        idx = jnp.argmax(ok)                       # first (largest) passing
        step = jnp.where(any_ok, steps[idx], 0.0)
        new_amps = amps - step * direction
        new_f = jnp.where(any_ok, f_trials[idx], value)
        # A zero gradient or fully-rejected line search ends progress.
        stalled = (gnorm < 1e-20) | ~any_ok
        new_f = jnp.where(stalled, f_val, new_f)
        new_amps = jnp.where(stalled, amps, new_amps)
        k_next = jnp.where(stalled, cfg.max_iterations, k + 1)
        hist = hist.at[jnp.minimum(k + 1, cfg.max_iterations)].set(
            new_f * res0)
        return (k_next, new_amps, new_f, hist)

    k, amps, f_val, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), amps0, jnp.asarray(1.0, dtype), hist0))
    res = f_val * res0
    return ForceBalanceResult(
        amplitudes=amps, residual=res, initial_residual=res0,
        iterations=k, converged=res <= cfg.tolerance, history=hist)
