"""Mean-field Kuramoto-Sakaguchi oscillators with a global field driver.

JAX-native equivalent of the reference phase kernel
(``phase/kuramoto.py:34-200`` + Rust ``fusion-phase``):

    dtheta_i/dt = omega_i + K R sin(psi_r - theta_i - alpha)
                  + zeta sin(Psi - theta_i)

where (R, psi_r) is the Kuramoto order parameter and Psi is an exogenous
global driver phase ("external") or the mean-field phase ("mean_field").
Everything is pure jnp: the step is one fused elementwise kernel, whole
trajectories run in ``lax.scan``, and the Lyapunov diagnostics
V = <1 - cos(theta - Psi)>, lambda = ln(V_T/V_0)/T come out of the same
scan (the reference computes them per tick in Python).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def wrap_phase(x):
    """Map phases to (-pi, pi]."""
    return (x + jnp.pi) % (2.0 * jnp.pi) - jnp.pi


def order_parameter(theta, weights=None):
    """Kuramoto order parameter R e^{i psi} = <w e^{i theta}>/W -> (R, psi)."""
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    if weights is None:
        zr, zi = jnp.mean(c), jnp.mean(s)
    else:
        w_sum = jnp.maximum(jnp.sum(weights), 1e-15)
        zr = jnp.sum(weights * c) / w_sum
        zi = jnp.sum(weights * s) / w_sum
    return jnp.sqrt(zr**2 + zi**2), jnp.arctan2(zi, zr)


def lyapunov_v(theta, psi):
    """V = <1 - cos(theta - Psi)>; 0 at sync, 2 at max desync."""
    return jnp.mean(1.0 - jnp.cos(theta - psi))


def lyapunov_exponent(v_hist, dt):
    """lambda = ln(V_final/V_initial)/T over the sampled window."""
    v_hist = jnp.asarray(v_hist)
    n = v_hist.shape[0]
    v0 = jnp.maximum(v_hist[0], 1e-15)
    vf = jnp.maximum(v_hist[-1], 1e-15)
    return jnp.log(vf / v0) / (n * dt)


def resolve_psi(theta, psi_external, mode: str = "external"):
    """Global driver phase: caller-supplied carrier or the mean field."""
    if mode == "external":
        return jnp.asarray(psi_external)
    if mode == "mean_field":
        _, psi = order_parameter(theta)
        return psi
    raise ValueError(f"unknown psi mode {mode!r}")


@partial(jax.jit, static_argnames=("wrap",))
def kuramoto_step(theta, omega, *, dt, k_coupling, alpha=0.0, zeta=0.0,
                  psi=0.0, wrap: bool = True):
    """One Euler step; ``psi`` must already be resolved (see resolve_psi).

    Returns (theta1, aux) with aux = dict(R, psi_r, dtheta).
    """
    r, psi_r = order_parameter(theta)
    dtheta = omega + (k_coupling * r) * jnp.sin(psi_r - theta - alpha)
    dtheta = dtheta + zeta * jnp.sin(psi - theta)
    theta1 = theta + dt * dtheta
    if wrap:
        theta1 = wrap_phase(theta1)
    return theta1, {"R": r, "psi_r": psi_r, "dtheta": dtheta}


class KuramotoTrace(NamedTuple):
    theta: jnp.ndarray       # (n_steps, N)
    r: jnp.ndarray           # (n_steps,)
    v: jnp.ndarray           # (n_steps,) Lyapunov V against the driver
    lambda_exp: jnp.ndarray  # scalar


@partial(jax.jit, static_argnames=("n_steps", "psi_mode"))
def run_kuramoto(theta0, omega, *, dt, k_coupling, alpha=0.0, zeta=0.0,
                 psi_external=0.0, psi_mode: str = "external",
                 n_steps: int = 1000) -> KuramotoTrace:
    """Whole trajectory in one scan with Lyapunov history."""
    def step(theta, _):
        psi = resolve_psi(theta, psi_external, psi_mode)
        theta1, aux = kuramoto_step(
            theta, omega, dt=dt, k_coupling=k_coupling, alpha=alpha,
            zeta=zeta, psi=psi)
        return theta1, (theta1, aux["R"], lyapunov_v(theta1, psi))

    _, (thetas, rs, vs) = jax.lax.scan(step, theta0, None, length=n_steps)
    return KuramotoTrace(thetas, rs, vs, lyapunov_exponent(vs, dt))
