"""Radial force balance: PF-coil currents for static equilibrium at R.

Compiled redesign of the reference's ``core/force_balance.py:19-175``
(``ForceBalanceSolver``): find the control-coil currents that zero the
net radial force on the plasma at the target radius.

The reference runs a Newton-Raphson loop with a numerically-perturbed
Jacobian through its full kernel.  Here the physics collapses to a
LINEAR solve: the net radial force on the plasma column is

    F_R = 2 pi R I_p (B_z_ext(R, 0) - B_v_eq)

with the Shafranov equilibrium field

    B_v_eq = -(mu0 I_p / 4 pi R) (ln(8R/a) + beta_p + l_i/2 - 3/2)

and B_z_ext EXACTLY linear in the coil currents through the Green's
function (the same response rows the shape-control lane uses), so the
paired-coil adjustment that zeroes F_R is one closed-form division —
no iteration.  A Newton variant via ``jax.grad`` is exposed for plants
where the force is NOT linear in the knob (e.g. force evaluated from a
re-solved free-boundary equilibrium).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.models.equilibrium.free_boundary import CoilSet
from scpn_fusion_tpu.models.equilibrium.shape_control import (
    probe_response_matrix,
)

MU0_SI = 4.0e-7 * jnp.pi


def shafranov_vertical_field(r0, a_minor, ip_a, *, beta_p=0.5, li=0.9,
                             mu0: float = float(MU0_SI)):
    """Equilibrium vertical field B_v (Shafranov, standard form)."""
    return -(mu0 * ip_a / (4.0 * jnp.pi * r0)) * (
        jnp.log(8.0 * r0 / a_minor) + beta_p + li / 2.0 - 1.5)


def external_bz_at(coils: CoilSet, r, z, *, mu0: float = float(MU0_SI)):
    """B_z from the coil set at one point — one response row @ currents."""
    pt = jnp.asarray([[r, z]], coils.currents.dtype)
    row = probe_response_matrix(
        coils, b_probe_points=pt,
        b_probe_dirs=jnp.asarray([1], jnp.int32), mu0=mu0)[0]
    return row @ coils.currents, row


def radial_force(coils: CoilSet, r_target, ip_a, a_minor, *,
                 beta_p=0.5, li=0.9, mu0: float = float(MU0_SI)):
    """Net radial force [N] on the plasma column at ``r_target``."""
    b_ext, _ = external_bz_at(coils, r_target, 0.0, mu0=mu0)
    b_eq = shafranov_vertical_field(r_target, a_minor, ip_a,
                                    beta_p=beta_p, li=li, mu0=mu0)
    return 2.0 * jnp.pi * r_target * ip_a * (b_ext - b_eq)


class ForceBalanceSolution(NamedTuple):
    currents: jnp.ndarray          # balanced coil currents
    delta_i: jnp.ndarray           # applied change on the control pair
    residual_force_n: jnp.ndarray  # force after the solve
    initial_force_n: jnp.ndarray
    converged: jnp.ndarray


def solve_force_balance(
    coils: CoilSet,
    *,
    r_target: float = 6.2,
    ip_a: float = 15e6,
    a_minor: float = 2.0,
    control_indices: tuple[int, int] = (2, 3),
    beta_p: float = 0.5,
    li: float = 0.9,
    mu0: float = float(MU0_SI),
    tolerance_n: float = 1e4,
) -> ForceBalanceSolution:
    """Closed-form balanced currents for a symmetric control pair.

    The reference perturbs PF3/PF4 together and Newton-iterates
    (:64-140); B_z is linear in the currents, so the exact step is
    ``dI = (B_eq - B_ext) / (s_i + s_j)`` with s the response-row
    entries of the control coils.
    """
    f0 = radial_force(coils, r_target, ip_a, a_minor,
                      beta_p=beta_p, li=li, mu0=mu0)
    b_ext, row = external_bz_at(coils, r_target, 0.0, mu0=mu0)
    b_eq = shafranov_vertical_field(r_target, a_minor, ip_a,
                                    beta_p=beta_p, li=li, mu0=mu0)
    i, j = control_indices
    sens = row[i] + row[j]
    delta = jnp.where(jnp.abs(sens) > 1e-30,
                      (b_eq - b_ext) / jnp.where(jnp.abs(sens) > 1e-30,
                                                 sens, 1.0), 0.0)
    new_currents = coils.currents.at[i].add(delta).at[j].add(delta)
    balanced = coils._replace(currents=new_currents)
    f1 = radial_force(balanced, r_target, ip_a, a_minor,
                      beta_p=beta_p, li=li, mu0=mu0)
    return ForceBalanceSolution(
        currents=new_currents, delta_i=delta, residual_force_n=f1,
        initial_force_n=f0, converged=jnp.abs(f1) < tolerance_n)


def solve_force_balance_newton(
    force_fn,
    i0,
    *,
    n_iter: int = 10,
    tolerance_n: float = 1e4,
    jacobian_floor: float = 1e-12,
):
    """Newton on a general (possibly nonlinear) force function of one
    knob, with EXACT ``jax.grad`` derivatives (the reference estimates
    dF/dI by a 0.1 MA perturbation, :126-140).  For plants where the
    force comes from a re-solved equilibrium rather than the linear
    vacuum response."""
    grad_fn = jax.grad(force_fn)

    def body(carry):
        k, x, f = carry
        g = grad_fn(x)
        g_safe = jnp.where(jnp.abs(g) > jacobian_floor, g,
                           jnp.sign(g) * jacobian_floor + (g == 0.0)
                           * jacobian_floor)
        x_new = x - f / g_safe
        return k + 1, x_new, force_fn(x_new)

    def cond(carry):
        k, _, f = carry
        return (k < n_iter) & (jnp.abs(f) > tolerance_n)

    x0 = jnp.asarray(i0)
    k, x, f = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x0, force_fn(x0)))
    return x, f, jnp.abs(f) < tolerance_n
