"""Ideal-MHD s-alpha ballooning eigenvalue solver with second-stability access.

JAX-native port of the reference's full ballooning-equation machinery
(``core/ballooning_solver.py:33-140``: shooting integration of the s-alpha
ballooning ODE + binary-searched first-stability boundary, and
``core/ballooning_second_stability.py:50-161``: critical-alpha-vs-shear table
with second-stability classification).

The reference integrates each (s, alpha) pair on the host with SciPy's
adaptive ``solve_ivp`` and bisects with Python loops — one ODE solve at a
time.  Here the ballooning equation

    d/dtheta [ f(theta) d xi/dtheta ] + g(theta) xi = 0,
    f = 1 + (s theta - alpha sin theta)^2,
    g = alpha (cos theta + (s theta - alpha sin theta) sin theta),

is integrated by a fixed-step RK4 ``lax.scan`` (static shapes, no
data-dependent control flow), so the *entire* (s, alpha) stability map is ONE
``vmap``-batched XLA program: thousands of field-line integrations run as a
single vectorised kernel instead of thousands of host round-trips.  Stability
is the reference's criterion: the Newcomb condition — xi launched from
(1, 0) keeps its sign over the ballooning interval (a zero crossing marks
instability; ``ballooning_solver.py:52-93``).

Band extraction (first boundary, second boundary, second-stability access)
is pure ``argmax`` logic over the vectorised map — jittable, differentiable
through the smooth margin, and exact on the alpha grid.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def _integrate_newcomb(rhs, like, theta_max: float,
                       n_steps: int) -> jnp.ndarray:
    """min xi(theta) over [0, theta_max] from xi(0)=1, xi'(0)=0 by RK4
    on the first-order system (u1, u2) = (xi, f xi') — the reference's
    variables (``ballooning_solver.py:60-64``).  Shared by the circular
    s-alpha and Miller-shaped operators (only ``rhs`` differs); returns
    min(u1): negative iff the displacement crossed zero (unstable)."""
    h = theta_max / n_steps

    def step(carry, i):
        y, m = carry
        t = i * h
        k1 = rhs(t, y)
        k2 = rhs(t + 0.5 * h, y + 0.5 * h * k1)
        k3 = rhs(t + 0.5 * h, y + 0.5 * h * k2)
        k4 = rhs(t + h, y + h * k3)
        y = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return (y, jnp.minimum(m, y[0])), None

    y0 = jnp.stack([jnp.ones_like(like), jnp.zeros_like(like)])
    (_, m), _ = jax.lax.scan(step, (y0, jnp.asarray(1.0, y0.dtype)),
                             jnp.arange(n_steps))
    return m


def _ballooning_min_xi(
    s: jnp.ndarray,
    alpha: jnp.ndarray,
    theta_max: float,
    n_steps: int,
) -> jnp.ndarray:
    """Circular s-alpha Newcomb integration."""
    def rhs(theta, y):
        u1, u2 = y
        w = s * theta - alpha * jnp.sin(theta)
        f = 1.0 + w * w
        g = alpha * (jnp.cos(theta) + w * jnp.sin(theta))
        return jnp.stack([u2 / f, -g * u1])

    return _integrate_newcomb(rhs, s * alpha, theta_max, n_steps)


@partial(jax.jit, static_argnames=("theta_max", "n_steps"))
def ballooning_stable(
    s,
    alpha,
    *,
    theta_max: float = 20.0 * float(jnp.pi),
    n_steps: int = 4000,
) -> jnp.ndarray:
    """True where the (s, alpha) point is ideal-ballooning stable.

    Broadcasts over array inputs — a whole stability diagram is one call.
    """
    s = jnp.asarray(s, jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    alpha = jnp.asarray(alpha, s.dtype)
    s_b, a_b = jnp.broadcast_arrays(s, alpha)
    flat = jax.vmap(
        lambda sv, av: _ballooning_min_xi(sv, av, theta_max, n_steps)
    )(s_b.reshape(-1), a_b.reshape(-1))
    return (flat > 0.0).reshape(s_b.shape)


class SecondStabilityResult(NamedTuple):
    """Per-shear ballooning band structure on an alpha grid.

    alpha_crit_first : lower (first-stability) boundary — smallest alpha on
        the grid that is unstable; ``alpha_max`` where no instability exists
        (full second-stability access at this shear, stored at the scan
        ceiling exactly like the reference artifact,
        ``ballooning_second_stability.py:112-118``).
    alpha_crit_second : upper boundary — smallest alpha above the unstable
        band that is stable again; NaN where the band never closes below
        the ceiling.
    second_access : the unstable band closes below ``alpha_max`` (or never
        opens): increasing pressure gradient re-enters stability.
    """

    shear: jnp.ndarray
    alpha: jnp.ndarray
    stable_map: jnp.ndarray         # (n_s, n_alpha) bool
    alpha_crit_first: jnp.ndarray   # (n_s,)
    alpha_crit_second: jnp.ndarray  # (n_s,)
    second_access: jnp.ndarray      # (n_s,) bool

    def alpha_crit_at(self, shat) -> jnp.ndarray:
        """Interpolated first-stability critical alpha at ``shat`` (clamped
        linear interp — reference ``alpha_crit_at``,
        ``ballooning_second_stability.py:131-151``)."""
        return jnp.interp(jnp.asarray(shat), self.shear, self.alpha_crit_first)

    def has_second_stability_at(self, shat) -> jnp.ndarray:
        """Nearest-neighbour second-stability classification (the boolean is
        not interpolable; reference ``has_second_stability_at``)."""
        idx = jnp.argmin(jnp.abs(self.shear - jnp.asarray(shat)))
        return self.second_access[idx]


@partial(jax.jit, static_argnames=("n_alpha", "theta_max", "n_steps"))
def second_stability_scan(
    s_vals: jnp.ndarray,
    *,
    alpha_max: float = 5.0,
    n_alpha: int = 64,
    theta_max: float = 20.0 * float(jnp.pi),
    n_steps: int = 4000,
) -> SecondStabilityResult:
    """Full s-alpha diagram with first/second boundaries and access flags.

    One XLA program: ``n_s * n_alpha`` RK4 field-line integrations batched
    through ``vmap`` (vs the reference's per-point host bisection,
    ``ballooning_solver.py:96-135``), then band edges via index arithmetic.
    """
    s_vals = jnp.asarray(s_vals)
    if not jnp.issubdtype(s_vals.dtype, jnp.floating):
        s_vals = s_vals.astype(
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    alphas = jnp.linspace(0.0, alpha_max, n_alpha, dtype=s_vals.dtype)
    stable = ballooning_stable(
        s_vals[:, None], alphas[None, :],
        theta_max=theta_max, n_steps=n_steps)          # (n_s, n_alpha)

    unstable = ~stable
    any_unstable = jnp.any(unstable, axis=1)
    # First boundary: first unstable alpha index along the grid.
    i_first = jnp.argmax(unstable, axis=1)
    alpha_first = jnp.where(any_unstable, alphas[i_first],
                            jnp.asarray(alpha_max, alphas.dtype))

    # Second boundary: first stable alpha AFTER the last unstable point.
    idx = jnp.arange(n_alpha)
    i_last_unstable = (n_alpha - 1) - jnp.argmax(unstable[:, ::-1], axis=1)
    beyond = idx[None, :] > i_last_unstable[:, None]
    reentry = stable & beyond
    any_reentry = jnp.any(reentry, axis=1) & any_unstable
    i_second = jnp.argmax(reentry, axis=1)
    alpha_second = jnp.where(any_reentry, alphas[i_second], jnp.nan)

    second_access = any_reentry | ~any_unstable
    return SecondStabilityResult(
        shear=s_vals, alpha=alphas, stable_map=stable,
        alpha_crit_first=alpha_first, alpha_crit_second=alpha_second,
        second_access=second_access)


def marginal_alpha(
    s: float,
    *,
    alpha_lo: float = 0.0,
    alpha_hi: float = 2.0,
    n_bisect: int = 24,
    theta_max: float = 20.0 * float(jnp.pi),
    n_steps: int = 4000,
) -> jnp.ndarray:
    """Bisected first-stability boundary at fixed shear (reference
    ``find_marginal_stability``, ``ballooning_solver.py:96-135``).

    A fixed-trip-count bisection ``scan`` (jittable): assumes stability at
    ``alpha_lo`` and instability at ``alpha_hi`` — use ``second_stability_scan``
    for the general banded structure.
    """
    def body(carry, _):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        stab = _ballooning_min_xi(
            jnp.asarray(s, mid.dtype), mid, theta_max, n_steps) > 0.0
        return (jnp.where(stab, mid, lo), jnp.where(stab, hi, mid)), None

    lo0 = jnp.asarray(alpha_lo, jnp.float64
                      if jax.config.jax_enable_x64 else jnp.float32)
    hi0 = jnp.asarray(alpha_hi, lo0.dtype)
    (lo, hi), _ = jax.lax.scan(body, (lo0, hi0), None, length=n_bisect)
    return 0.5 * (lo + hi)


# ── Shaped (Miller) ballooning tier ──────────────────────────────────────
#
# The reference names "shaped_geometry_miller_ballooning_required_for_
# second_stability_access" as the recorded BLOCKER of its own PB-KBM
# pedestal tier (benchmark_eped_pedestal_tiers.py:55-58) and ships no
# implementation.  This tier goes beyond it: the s-alpha ballooning
# operator with Miller-geometry-modulated coefficients from
# ``models/gyrokinetics/geometry.py`` (shaped major radius R_s(theta),
# field strength B(theta), field-line arc b.grad-theta), keeping the
# alpha sin(theta) secular term (the Shafranov-shift mechanism that
# produces second stability).  Reduced model, documented as such:
#
# Self-adjoint field-line form (B.grad = bdgt d/dtheta; bending carries
# one power of bdgt, the drive its inverse; flux expansion |grad r|^2
# rides the secular Lambda^2 part of k_perp^2):
#
#   d/dtheta [ f dX/dtheta ] + g X = 0,
#   Lambda   = s theta - alpha sin theta
#   f(theta) = bdgt_n * (1 + Lambda^2 grr_n) * (B(0)/B)^2
#   g(theta) = alpha * (R_s(0)/R_s) * (cos theta + Lambda sin theta)
#              / bdgt_n
#
# with bdgt_n = bdgt/bdgt(0) and grr_n = |grad r|^2 / |grad r|^2(0).
# Shaping enters through four measured channels: in/out drive asymmetry
# (R_s — triangularity), field-line arc/bending (bdgt — elongation),
# flux expansion (grr), and field-strength modulation (B).  The exact
# thin-tube limit rho -> 0 recovers the circular s-alpha operator
# coefficient-for-coefficient (parity-tested).


def _miller_coefficients(*, r0, a, rho, kappa, delta, q, n_theta: int):
    """Shaped coefficient tables on a uniform theta grid."""
    from scpn_fusion_tpu.models.gyrokinetics.geometry import miller_geometry

    # The shaped coefficients are 2pi-periodic in theta (the secular
    # Lambda dynamics is applied analytically in the integrator), so one
    # densely-sampled period suffices; the integrator wraps theta.
    geo = miller_geometry(r0=r0, a=a, rho=rho, kappa=kappa, delta=delta,
                          q=q, s_hat=0.0, alpha_mhd=0.0,
                          n_theta=2 * n_theta + 1, n_period=1)
    mid = n_theta  # theta = 0 sample
    bdgt_n = geo.b_dot_grad_theta / geo.b_dot_grad_theta[mid]
    grr_n = geo.g_rr / geo.g_rr[mid]
    binv2 = (geo.b_mag[mid] / geo.b_mag) ** 2
    drive_weight = (geo.r_s[mid] / geo.r_s) / bdgt_n
    # Triangularity tilts the curvature's angular structure: the Miller
    # geometric angle is theta_hat = theta + arcsin(delta) sin(theta), so
    # delta > 0 narrows the outboard bad-curvature window (stabilising)
    # and delta < 0 widens it.
    delta_angle = jnp.arcsin(jnp.clip(delta, -0.99, 0.99))
    theta_hat = geo.theta + delta_angle * jnp.sin(geo.theta)
    return (geo.theta, bdgt_n, grr_n, binv2, drive_weight,
            jnp.cos(theta_hat), jnp.sin(theta_hat))


def _miller_min_xi(s, alpha, theta_tab, bdgt_tab, grr_tab, binv2_tab,
                   weight_tab, cos_hat_tab, sin_hat_tab,
                   theta_max: float, n_steps: int) -> jnp.ndarray:
    """Newcomb integration of the shaped operator."""
    def interp(tab, theta):
        wrapped = theta - 2.0 * jnp.pi * jnp.round(theta / (2.0 * jnp.pi))
        return jnp.interp(wrapped, theta_tab, tab)

    def rhs(theta, y):
        u1, u2 = y
        lam = s * theta - alpha * jnp.sin(theta)
        f = (interp(bdgt_tab, theta)
             * (1.0 + lam * lam * interp(grr_tab, theta))
             * interp(binv2_tab, theta))
        g = alpha * interp(weight_tab, theta) * (
            interp(cos_hat_tab, theta) + lam * interp(sin_hat_tab, theta))
        return jnp.stack([u2 / jnp.maximum(f, 1e-12), -g * u1])

    return _integrate_newcomb(rhs, s * alpha, theta_max, n_steps)


@partial(jax.jit, static_argnames=(
    "r0", "a", "rho", "kappa", "delta", "q",
    "n_theta", "theta_max", "n_steps"))
def miller_ballooning_stable(
    s,
    alpha,
    *,
    r0: float = 3.0,
    a: float = 1.0,
    rho: float = 0.9,
    kappa: float = 1.0,
    delta: float = 0.0,
    q: float = 3.0,
    n_theta: int = 256,
    theta_max: float = 20.0 * float(jnp.pi),
    n_steps: int = 4000,
) -> jnp.ndarray:
    """True where (s, alpha) is ballooning-stable in Miller geometry.

    Broadcasts over (s, alpha) arrays; the shaped coefficient tables are
    built once per geometry and shared by every integration in the vmap.
    In the thin-tube limit (rho -> 0, kappa = 1, delta = 0) this is the
    circular :func:`ballooning_stable` operator exactly.
    """
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    s = jnp.asarray(s, dtype)
    alpha = jnp.asarray(alpha, dtype)
    tabs = _miller_coefficients(
        r0=r0, a=a, rho=rho, kappa=kappa, delta=delta, q=q,
        n_theta=n_theta)
    tabs = tuple(t.astype(dtype) for t in tabs)
    s_b, a_b = jnp.broadcast_arrays(s, alpha)
    flat = jax.vmap(
        lambda sv, av: _miller_min_xi(sv, av, *tabs, theta_max, n_steps)
    )(s_b.reshape(-1), a_b.reshape(-1))
    return (flat > 0.0).reshape(s_b.shape)


def miller_marginal_alpha(
    s: float,
    *,
    alpha_hi: float = 5.0,
    n_grid: int = 96,
    **geometry,
) -> jnp.ndarray:
    """First-stability critical alpha at fixed shear in Miller geometry
    (grid scan — the shaped band can close; bisection assumptions fail)."""
    alphas = jnp.linspace(0.0, alpha_hi, n_grid)
    stable = miller_ballooning_stable(jnp.asarray(s), alphas, **geometry)
    unstable = ~stable
    any_u = jnp.any(unstable)
    i_first = jnp.argmax(unstable)
    return jnp.where(any_u, alphas[i_first], jnp.asarray(alpha_hi,
                                                         alphas.dtype))


class BootstrapPathResult(NamedTuple):
    """Marginal alpha along the bootstrap-consistent (s_eff, alpha) path.

    alpha_crit : last stable alpha along the path before the first
        unstable point (``alpha_hi`` when the whole path is stable).
    second_access : the path dodges the unstable band entirely — the
        pedestal reaches second stability and alpha is NOT
        ballooning-limited (a peeling/current limit must take over).
    """

    alpha_crit: jnp.ndarray
    second_access: jnp.ndarray


def bootstrap_path_alpha_crit(
    s0: float,
    c_bs: float,
    *,
    alpha_hi: float = 16.0,
    n_grid: int = 65,
    **geometry,
) -> BootstrapPathResult:
    """Ballooning-critical alpha with self-consistent bootstrap shear.

    The pedestal's pressure gradient drives bootstrap current, which
    lowers the local magnetic shear: ``s_eff(alpha) = s0 - c_bs alpha``.
    As alpha builds from 0 the operating point traces this path through
    the shaped (Miller) stability diagram; the marginal alpha is the last
    stable point on the path.  With strong bootstrap the path drops below
    the band's nose before reaching it — genuine second-stability access,
    the mechanism EPED's KBM tier relies on and the reference records as
    its unimplemented blocker (``benchmark_eped_pedestal_tiers.py:55-58``).
    One vmapped stability evaluation along the path (static shapes).
    """
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    alphas = jnp.linspace(0.0, alpha_hi, n_grid, dtype=dtype)
    s_eff = jnp.asarray(s0, dtype) - jnp.asarray(c_bs, dtype) * alphas
    stable = miller_ballooning_stable(s_eff, alphas, **geometry)
    unstable = ~stable
    any_u = jnp.any(unstable)
    i_first = jnp.argmax(unstable)
    alpha_crit = jnp.where(
        any_u, alphas[jnp.maximum(i_first - 1, 0)],
        jnp.asarray(alpha_hi, dtype))
    return BootstrapPathResult(alpha_crit=alpha_crit, second_access=~any_u)
