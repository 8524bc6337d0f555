"""Super-twisting sliding-mode vertical stabiliser.

JAX-native equivalent of the reference SMC module
(``control/sliding_mode_vertical.py:17-90``): second-order sliding mode
u = -alpha sqrt(|s|) sign(s) + v,  dv/dt = -beta sign(s),  s = e + c de/dt,
with actuator saturation, plus the Lyapunov gain certificate and the
finite-time convergence bound.  State is carried functionally
(``smc_step(params, v, e, de) -> (u, v')``) so whole closed-loop shots run
inside one ``lax.scan`` — see ``run_smc_vertical``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SMCParams:
    alpha: float = 5.0      # proportional sqrt gain
    beta: float = 3.0       # integral switching gain
    c: float = 0.1          # sliding-surface velocity weight [s]
    u_max: float = 10.0     # actuator saturation


def sliding_surface(p: SMCParams, e, de_dt):
    """s = e + c de/dt."""
    return e + p.c * de_dt


def smc_step(p: SMCParams, v, e, de_dt, dt):
    """One super-twisting update; returns (u, v_next)."""
    s = sliding_surface(p, e, de_dt)
    v_next = jnp.clip(v - p.beta * jnp.sign(s) * dt, -p.u_max, p.u_max)
    u = -p.alpha * jnp.sqrt(jnp.abs(s)) * jnp.sign(s) + v_next
    return jnp.clip(u, -p.u_max, p.u_max), v_next


def lyapunov_certificate(alpha: float, beta: float, l_max: float) -> bool:
    """Gain conditions alpha > sqrt(2 L), beta > L for finite-time stability
    under |disturbance rate| <= L."""
    l_safe = max(l_max, 1e-12)
    return alpha > math.sqrt(2.0 * l_safe) and beta > l_safe


def estimate_convergence_time(alpha: float, beta: float, l_max: float,
                              s0: float) -> float:
    """Upper bound t_reach <= 2 sqrt(|s0|) / (alpha - sqrt(2 L))."""
    if l_max < 0:
        return float("inf")
    denom = alpha - math.sqrt(2.0 * l_max)
    if denom <= 0:
        return float("inf")
    return 2.0 * math.sqrt(abs(s0)) / denom


class SMCTrace(NamedTuple):
    z: jnp.ndarray
    u: jnp.ndarray
    s: jnp.ndarray


@partial(jax.jit, static_argnames=("p", "n_steps"))
def run_smc_vertical(
    p: SMCParams,
    *,
    z0: float,
    dz0: float,
    gamma: float,            # open-loop vertical growth rate [1/s]
    control_gain: float,     # plant gain: d2Z/dt2 = gamma^2 Z + g u
    z_ref: float = 0.0,
    dt: float = 1e-4,
    n_steps: int = 5000,
) -> SMCTrace:
    """Closed-loop shot against the unstable rigid plant
    d2Z/dt2 = gamma^2 (Z - Z_axis) + g u  under one ``lax.scan``
    (the reference exercises SMC per-step in Python)."""
    def step(carry, _):
        z, dz, v = carry
        e = z - z_ref
        u, v = smc_step(p, v, e, dz, dt)
        ddz = gamma**2 * (z - z_ref) + control_gain * u
        dz = dz + dt * ddz
        z = z + dt * dz
        return (z, dz, v), (z, u, sliding_surface(p, e, dz))

    init = (jnp.asarray(z0, jnp.float32), jnp.asarray(dz0, jnp.float32),
            jnp.asarray(0.0, jnp.float32))
    _, (z, u, s) = jax.lax.scan(step, init, None, length=n_steps)
    return SMCTrace(z, u, s)
