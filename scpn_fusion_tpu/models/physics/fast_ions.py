"""Fast-ion population physics: Monte-Carlo ensembles, orbit
classification, prompt loss, and collisional slowing-down.

JAX-native counterpart of the reference's fast-ion machinery
(``core/orbit_following.py:167-442`` — ``OrbitClassifier``,
``MonteCarloEnsemble``, ``first_orbit_loss``, ``SlowingDown``; full-orbit
twin ``fusion-core/src/particles.rs``).  Design deltas:

* the whole ensemble integrates as ONE device program —
  ``vmap(lax.scan(rk4))`` over the guiding-centre pusher from
  :mod:`.orbits` — instead of the reference's per-particle host loop
  (its ensemble costs O(n_particles × n_steps) Python dispatches);
* classification happens ON THE FLY inside the scan (running
  wall-crossing / bounce flags), so no (n_particles × n_steps) trace is
  ever materialised in HBM;
* lost particles freeze at their loss state, which keeps the batch free
  of post-wall NaN excursions while preserving the loss statistics;
* an energy-conservation audit (E = m v_par²/2 + µ|B| along every
  surviving orbit) is part of the returned statistics — the integrator
  polices itself on every run, not only in tests;
* the slowing-down formulary is expressed over ``jnp`` arrays, so whole
  radial profiles evaluate in one call (the reference's statics are
  scalar with per-value ``ValueError`` guards; here non-finite inputs
  propagate as NaN, which the fail-closed campaign gates catch).

Formulas are the published NRL/Stix results the reference also uses
(cited per function).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.models.physics.orbits import (
    ATOMIC_MASS_KG,
    E_CHARGE,
    GuidingCenterState,
    _gc_eom,
)

__all__ = [
    "ALPHA_AMU",
    "ALPHA_BIRTH_KEV",
    "ALPHA_Z",
    "EnsembleStats",
    "coulomb_log_ei",
    "critical_velocity",
    "first_orbit_loss",
    "follow_ensemble",
    "heating_partition",
    "sample_fast_ion_birth",
    "slowing_down_time",
    "tau_spitzer_electron",
    "tokamak_field",
]

ALPHA_AMU = 4.001506
ALPHA_Z = 2
ALPHA_BIRTH_KEV = 3500.0
DT_MEAN_ION_AMU = 2.5

ELECTRON_MASS_KG = 9.1093837015e-31
EPS0 = 8.8541878128e-12
MU0 = 1.25663706212e-6


# ── analytic field ───────────────────────────────────────────────────────


def tokamak_field(b0: float, r0: float, a: float,
                  q0: float = 1.0, qa: float = 3.0) -> Callable:
    """Analytic circular-surface tokamak field ``(R, Z) -> (B_R, B_Z,
    B_phi)``: ``B_phi = B0 R0 / R`` and a poloidal component tangent to
    circular surfaces with parabolic safety factor
    ``q(r) = q0 + (qa - q0)(r/a)^2`` — the standard test field for orbit
    studies (the reference's demos hand-roll the same shape)."""

    def field(r, z):
        b_phi = b0 * r0 / r
        rm = jnp.sqrt((r - r0) ** 2 + z**2)
        rm_safe = jnp.maximum(rm, 1e-6)
        q = q0 + (qa - q0) * (rm / a) ** 2
        b_pol = rm * b0 / (q * r)
        b_r = -b_pol * z / rm_safe
        b_z = b_pol * (r - r0) / rm_safe
        return b_r, b_z, b_phi

    return field


# ── birth sampling ───────────────────────────────────────────────────────


def sample_fast_ion_birth(
    key: jax.Array,
    n: int,
    b_field: Callable,
    *,
    r0: float,
    a: float,
    e_kev: float = ALPHA_BIRTH_KEV,
    m_amu: float = ALPHA_AMU,
) -> GuidingCenterState:
    """Sample ``n`` fast-ion guiding centres: centrally peaked
    ``Beta(2, 5)`` birth minor radius, uniform poloidal angle, isotropic
    pitch angle — the reference's ``MonteCarloEnsemble.initialize``
    prior (``orbit_following.py:220-242``), drawn as one batched program.
    Returns a batched :class:`GuidingCenterState` (leading axis ``n``)."""
    k_r, k_th, k_pitch = jax.random.split(key, 3)
    rm = jax.random.beta(k_r, 2.0, 5.0, (n,)) * a
    theta = jax.random.uniform(k_th, (n,), minval=0.0, maxval=2.0 * jnp.pi)
    pitch = jax.random.uniform(k_pitch, (n,), minval=0.0, maxval=jnp.pi)

    r = r0 + rm * jnp.cos(theta)
    z = rm * jnp.sin(theta)

    m = m_amu * ATOMIC_MASS_KG
    v_tot = jnp.sqrt(2.0 * e_kev * 1e3 * E_CHARGE / m)
    v_par = v_tot * jnp.cos(pitch)
    v_perp = v_tot * jnp.sin(pitch)
    b_r, b_z, b_phi = b_field(r, z)
    b_mag = jnp.sqrt(b_r**2 + b_z**2 + b_phi**2)
    mu = m * v_perp**2 / (2.0 * b_mag)
    return GuidingCenterState(r, z, jnp.zeros((n,)), v_par, mu)


# ── ensemble follow + classification ─────────────────────────────────────


class EnsembleStats(NamedTuple):
    """Aggregate orbit statistics for one followed population."""

    n_passing: jnp.ndarray
    n_trapped: jnp.ndarray
    n_lost: jnp.ndarray
    loss_fraction: jnp.ndarray
    trapped_fraction: jnp.ndarray      # of the CONFINED population
    energy_drift_rel_max: jnp.ndarray  # over confined orbits
    final: GuidingCenterState


@partial(jax.jit,
         static_argnames=("b_field", "n_steps", "m_amu", "charge_z"))
def follow_ensemble(
    states: GuidingCenterState,
    b_field: Callable,
    *,
    m_amu: float,
    charge_z: float,
    dt: float,
    n_steps: int,
    r_wall_in: float,
    r_wall_out: float,
    z_wall: float,
) -> EnsembleStats:
    """Integrate every guiding centre and classify orbits in one program.

    Classification mirrors the reference's ``OrbitClassifier.classify``
    (``orbit_following.py:171-201``): *lost* if the orbit ever crosses
    the wall envelope (checked every step, not on a sampled trace),
    *trapped* if ``v_par`` ever reverses sign (a bounce point), else
    *passing*; lost overrides trapped.  Lost particles freeze at their
    loss state.  The energy audit tracks ``E = m v_par²/2 + µ|B|`` per
    surviving particle against its birth value.
    """
    m = m_amu * ATOMIC_MASS_KG
    q = charge_z * E_CHARGE

    def b_mag_at(r, z):
        br, bz, bp = b_field(r, z)
        return jnp.sqrt(br**2 + bz**2 + bp**2)

    def one_particle(s0: GuidingCenterState):
        mu = s0.mu
        sign0 = jnp.sign(s0.v_par)
        e0 = 0.5 * m * s0.v_par**2 + mu * b_mag_at(s0.r, s0.z)

        def f(y):
            return _gc_eom((y[0], y[1], y[2], y[3], mu), b_field, m, q)

        def step(carry, _):
            y, lost, bounced = carry
            k1 = f(y)
            k2 = f(y + 0.5 * dt * k1)
            k3 = f(y + 0.5 * dt * k2)
            k4 = f(y + dt * k3)
            y_new = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            out = (y_new[0] > r_wall_out) | (y_new[0] < r_wall_in) | \
                  (jnp.abs(y_new[1]) > z_wall)
            y_next = jnp.where(lost, y, y_new)       # freeze once lost
            lost = lost | out
            bounced = bounced | (~lost & (y_next[3] * sign0 < 0.0))
            return (y_next, lost, bounced), None

        y0 = jnp.stack([s0.r, s0.z, s0.phi, s0.v_par])
        (y_f, lost, bounced), _ = jax.lax.scan(
            step, (y0, jnp.bool_(False), jnp.bool_(False)), None,
            length=n_steps)
        e_f = 0.5 * m * y_f[3] ** 2 + mu * b_mag_at(y_f[0], y_f[1])
        drift = jnp.abs(e_f - e0) / e0
        return y_f, lost, bounced, drift

    y_f, lost, bounced, drift = jax.vmap(one_particle)(states)
    trapped = bounced & ~lost
    passing = ~bounced & ~lost
    n = states.r.shape[0]
    n_lost = jnp.sum(lost)
    n_trapped = jnp.sum(trapped)
    n_passing = jnp.sum(passing)
    confined = jnp.maximum(n - n_lost, 1)
    final = GuidingCenterState(y_f[:, 0], y_f[:, 1], y_f[:, 2],
                               y_f[:, 3], states.mu)
    return EnsembleStats(
        n_passing=n_passing,
        n_trapped=n_trapped,
        n_lost=n_lost,
        loss_fraction=n_lost / n,
        trapped_fraction=n_trapped / confined,
        energy_drift_rel_max=jnp.max(jnp.where(lost, 0.0, drift)),
        final=final,
    )


# ── prompt (first-orbit) loss ────────────────────────────────────────────


def first_orbit_loss(r0, a, ip_ma, *, e_kev: float = ALPHA_BIRTH_KEV,
                     m_amu: float = ALPHA_AMU, z: int = ALPHA_Z):
    """Prompt-loss-zone width as a fraction of the minor radius:
    ``min(1, rho_pol / a)`` with ``rho_pol = m v / (Z e B_pol)`` and the
    edge poloidal field ``B_pol = mu0 Ip / (2 pi a)`` — the banana-width
    confinement scaling (reference ``orbit_following.py:295-336``; an
    upper bound, since the birth profile is centrally peaked).  ``r0``
    is accepted for signature parity but the scaling is R0-free."""
    del r0
    m = m_amu * ATOMIC_MASS_KG
    v = jnp.sqrt(2.0 * e_kev * 1e3 * E_CHARGE / m)
    b_pol = MU0 * (ip_ma * 1e6) / (2.0 * jnp.pi * a)
    rho_pol = m * v / (abs(z) * E_CHARGE * b_pol)
    return jnp.minimum(1.0, rho_pol / a)


# ── collisional slowing-down (NRL / Stix 1972) ───────────────────────────


def coulomb_log_ei(te_kev, ne20):
    """NRL electron-ion Coulomb logarithm (T_e > 10 eV):
    ``24 - ln(sqrt(n_e[cm^-3]) / T_e[eV])``
    (reference ``orbit_following.py:347-359``)."""
    te_ev = jnp.asarray(te_kev) * 1e3
    ne_cm3 = jnp.asarray(ne20) * 1e20 * 1e-6
    return 24.0 - jnp.log(jnp.sqrt(ne_cm3) / te_ev)


def critical_velocity(te_kev, ai_amu=DT_MEAN_ION_AMU):
    """Stix critical velocity (electron drag == ion drag), m/s:
    ``v_c = (3 sqrt(pi)/4 · m_e/m_i)^(1/3) · sqrt(2 T_e / m_e)``
    (reference :361-377).  Independent of the fast ion and of density."""
    te_j = jnp.asarray(te_kev) * 1e3 * E_CHARGE
    v_te = jnp.sqrt(2.0 * te_j / ELECTRON_MASS_KG)
    ratio = ELECTRON_MASS_KG / (ai_amu * ATOMIC_MASS_KG)
    return (3.0 * jnp.sqrt(jnp.pi) / 4.0 * ratio) ** (1.0 / 3.0) * v_te


def tau_spitzer_electron(te_kev, ne20, *, m_amu: float = ALPHA_AMU,
                         z: int = ALPHA_Z, coulomb_log=None):
    """Electron-drag (Spitzer) slowing-down time ``tau_se`` in seconds:
    ``3 (2 pi)^(3/2) eps0^2 m_f T_e^(3/2) / (m_e^(1/2) n_e Z^2 e^4 lnL)``
    (reference :378-416 — same constants; note its docstring writes
    ``(2 pi)^(1/2)`` and anchors "~0.3 s", which is the ~10 keV value:
    at T_e = 20 keV, n_e = 1e20 both codes give ~1.0 s, the standard
    ITER alpha slowing-down time)."""
    lnl = coulomb_log_ei(te_kev, ne20) if coulomb_log is None \
        else jnp.asarray(coulomb_log)
    te_j = jnp.asarray(te_kev) * 1e3 * E_CHARGE
    m_f = m_amu * ATOMIC_MASS_KG
    n_e = jnp.asarray(ne20) * 1e20
    num = 3.0 * 2.0**1.5 * jnp.pi**1.5 * EPS0**2 * m_f * te_j**1.5
    den = jnp.sqrt(ELECTRON_MASS_KG) * n_e * z**2 * E_CHARGE**4 * lnl
    return num / den


def slowing_down_time(v1, v2, v_c, tau_se):
    """Time to slow from ``v1`` to ``v2``:
    ``(tau_se/3) ln[(v1^3 + v_c^3)/(v2^3 + v_c^3)]`` (reference :417-430)."""
    return (tau_se / 3.0) * jnp.log(
        (jnp.asarray(v1) ** 3 + jnp.asarray(v_c) ** 3)
        / (jnp.asarray(v2) ** 3 + jnp.asarray(v_c) ** 3))


def heating_partition(v, v_c):
    """(ion, electron) heating fractions at fast-ion speed ``v``:
    ``f_ion = v_c^3 / (v^3 + v_c^3)`` (reference :431-442)."""
    f_ion = jnp.asarray(v_c) ** 3 / (jnp.asarray(v) ** 3
                                     + jnp.asarray(v_c) ** 3)
    return f_ion, 1.0 - f_ion
