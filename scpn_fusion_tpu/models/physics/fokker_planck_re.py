"""Runaway-electron Fokker-Planck kernel (1D in momentum), compiled.

JAX-native port of the reference's MUSCL-Hancock momentum-space solver
(``control/fokker_planck_re.py:251-616``; Rust twin
``fusion-physics/src/fokker_planck.rs:130``): log-spaced momentum grid
(p normalised to m_e c), Hesslow-style advection coefficient
``A = F_acc - F_drag - F_synch``, Connor-Hastie critical field, minmod-limited
MUSCL advection with upwind face fluxes, operator-split central-difference
diffusion, and the Rosenbluth-Putvinski avalanche / Dreicer / knock-on
sources.  The whole ``n_steps`` trajectory runs as one ``lax.scan`` under
``jit`` — per-step physics is a handful of fused VPU ops on a (np_grid,)
vector, so thousands of kinetic steps execute with zero host involvement.

Constants match the reference (``fokker_planck_re.py:38-52``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

C = 2.998e8
ME = 9.109e-31
MC = ME * C
E_CHARGE = 1.602e-19
EPS0 = 8.854e-12
COULOMB_LOG = 15.0
B_TOROIDAL = 5.3
DIFFUSION_FLOOR = 1e-5
AVALANCHE_RATE = 100.0
DREICER_SOURCE = 1.0e15
KNOCK_ON_SCALE = 1.0e-25
KNOCK_ON_MAX_SOURCE = 1.0e24
RE_SEED_FLOOR = 1.0e6


@dataclasses.dataclass(frozen=True)
class FokkerPlanckGrid:
    """Static log-spaced momentum grid (p in units of m_e c)."""

    np_grid: int = 200
    p_max: float = 100.0

    def __post_init__(self) -> None:
        if self.np_grid < 16:
            raise ValueError("np_grid must be >= 16")
        if not np.isfinite(self.p_max) or self.p_max <= 1e-3:
            raise ValueError("p_max must be finite and > 1e-3")

    def p(self, dtype=jnp.float32) -> jnp.ndarray:
        return jnp.logspace(-2.0, jnp.log10(self.p_max), self.np_grid, dtype=dtype)

    def dp(self, dtype=jnp.float32) -> jnp.ndarray:
        # np.gradient central-difference spacings of the log grid.
        p = self.p(dtype)
        interior = 0.5 * (p[2:] - p[:-2])
        return jnp.concatenate([(p[1] - p[0])[None], interior, (p[-1] - p[-2])[None]])


def fp_coefficients(
    p: jnp.ndarray,
    e_field,
    n_e,
    z_eff,
    t_e_ev,
    b_toroidal: float = B_TOROIDAL,
):
    """(A, D, Fc_norm): advection/diffusion coefficients + normalised
    Connor-Hastie critical force (reference ``compute_coefficients``)."""
    f_acc = (E_CHARGE * e_field) / MC
    e_crit = (n_e * E_CHARGE**3 * COULOMB_LOG) / (4 * jnp.pi * EPS0**2 * ME * C**2)
    fc_norm = (E_CHARGE * e_crit) / MC

    gamma = jnp.sqrt(1.0 + p**2)
    p_th_sq = jnp.maximum(t_e_ev / 511e3, 1e-6)
    f_drag = fc_norm * (1.0 + (z_eff + 1.0) / (p**2 + p_th_sq))
    tau_rad = (6 * jnp.pi * EPS0 * MC**3) / (E_CHARGE**4 * b_toroidal**2)
    f_synch = (1.0 / tau_rad) * p * gamma * jnp.sqrt(1.0 + z_eff)

    a = f_acc - f_drag - f_synch
    d = jnp.full_like(p, DIFFUSION_FLOOR)
    return a, d, fc_norm


def _minmod(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(a * b > 0,
                     jnp.sign(a) * jnp.minimum(jnp.abs(a), jnp.abs(b)), 0.0)


def fp_step(
    f: jnp.ndarray,
    p: jnp.ndarray,
    dp: jnp.ndarray,
    dt,
    e_field,
    n_e,
    t_e_ev,
    z_eff,
):
    """One MUSCL-Hancock advection + diffusion + sources step.

    Returns (f_new, n_re, j_re) — reference ``step`` (``:517-616``).
    """
    n = f.shape[0]
    a, d, fc = fp_coefficients(p, e_field, n_e, z_eff, t_e_ev)

    # Avalanche source (Rosenbluth-Putvinski NF 37 (1997) Eq. 19).
    e_crit = fc * MC / E_CHARGE
    gamma_av = jnp.where(
        e_field > e_crit,
        (e_field / jnp.maximum(e_crit, 1e-300) - 1.0)
        * jnp.sqrt(jnp.pi * (z_eff + 1.0) / 2.0) * AVALANCHE_RATE,
        0.0)
    s_av = gamma_av * f

    # Dreicer injection into the 5 lowest-momentum cells above 5% of E_crit.
    idx = jnp.arange(n)
    s_dr = jnp.where((idx < 5) & (e_field > 0.05 * e_crit), DREICER_SOURCE, 0.0)

    # Knock-on (Moller 1/p^2) source, gated on a seed population.
    n_re_now = jnp.sum(f * dp)
    s_ko = (1.0 / (p**2 + 1e-4)) * n_e * n_re_now * KNOCK_ON_SCALE
    s_ko = jnp.clip(jnp.where(jnp.isfinite(s_ko), s_ko, 0.0), 0.0, KNOCK_ON_MAX_SOURCE)
    s_ko = jnp.where(n_re_now < RE_SEED_FLOOR, 0.0, s_ko)

    # MUSCL advection with minmod slopes.
    df_fwd = jnp.concatenate([f[1:] - f[:-1], jnp.zeros((1,), f.dtype)])
    df_bwd = jnp.concatenate([jnp.zeros((1,), f.dtype), f[1:] - f[:-1]])
    slope = _minmod(df_fwd, df_bwd)
    f_l = f + 0.5 * slope
    f_r = jnp.roll(f - 0.5 * slope, -1)
    flux = jnp.where(a >= 0, a * f_l, a * f_r)

    interior = (jnp.arange(n) >= 1) & (jnp.arange(n) <= n - 2)
    flux_prev = jnp.concatenate([jnp.zeros((1,), f.dtype), flux[:-1]])
    adv = -(dt / dp) * (flux - flux_prev)
    f_n = jnp.roll(f, -1)
    f_s = jnp.roll(f, 1)
    diff = dt * d * (f_n - 2.0 * f + f_s) / dp**2
    update = adv + diff + dt * (s_av + s_dr + s_ko)
    f_new = jnp.maximum(0.0, f + jnp.where(interior, update, 0.0))

    n_re = jnp.sum(f_new * dp)
    gamma = jnp.sqrt(1.0 + p**2)
    v = C * p / gamma
    j_re = E_CHARGE * jnp.sum(f_new * v * dp)
    return f_new, n_re, j_re


class FPTrace(NamedTuple):
    n_re: jnp.ndarray
    j_re: jnp.ndarray


@partial(jax.jit, static_argnames=("grid", "n_steps"))
def run_fokker_planck(
    grid: FokkerPlanckGrid,
    f0: jnp.ndarray,
    dt,
    e_field,
    n_e,
    t_e_ev,
    z_eff,
    *,
    n_steps: int,
):
    """Run ``n_steps`` kinetic steps under ``lax.scan``; returns
    (f_final, FPTrace with per-step n_re / j_re)."""
    p = grid.p(f0.dtype)
    dp = grid.dp(f0.dtype)

    def step(f, _):
        f_new, n_re, j_re = fp_step(f, p, dp, dt, e_field, n_e, t_e_ev, z_eff)
        return f_new, FPTrace(n_re, j_re)

    return jax.lax.scan(step, f0, None, length=n_steps)
