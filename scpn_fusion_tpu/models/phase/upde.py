"""Multi-layer UPDE (unified phase-dynamics equation) system.

JAX-native equivalent of the reference UPDE tick
(``phase/upde.py:40-360`` + Rust ``py_upde_tick``): L plasma-process
layers of Kuramoto oscillators coupled through an (L, L) matrix K
(source row -> target column) with Sakaguchi lags alpha, per-layer
global-driver gains zeta, and PAC gating that boosts inter-layer coupling
from incoherent sources.

Layout: the reference stores a flat vector with per-layer offsets and
loops over layers twice per tick.  Here layers live in a dense padded
(L, n_max) array with a validity mask, so one tick is:

    z_m   = masked mean of e^{i theta}  per layer            (vector ops)
    coupling expanded by sin(a-b) identity into two (L,L)@(L,) matmuls
    dtheta = omega + S_m cos(theta) - C_m sin(theta) + zeta_m sin(Psi-theta)

— no per-layer Python loops, matmul-friendly, and the whole trajectory runs
under ``lax.scan`` with V_layer/V_global Lyapunov histories.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.models.phase.kuramoto import (
    lyapunov_exponent,
    lyapunov_v,
    wrap_phase,
)


def layer_order_parameters(theta, mask):
    """Per-layer (R_m, Psi_m) for padded (L, n) phases with validity mask."""
    counts = jnp.maximum(jnp.sum(mask, axis=1), 1e-15)
    zr = jnp.sum(jnp.cos(theta) * mask, axis=1) / counts
    zi = jnp.sum(jnp.sin(theta) * mask, axis=1) / counts
    return jnp.sqrt(zr**2 + zi**2), jnp.arctan2(zi, zr)


def global_order_parameter(theta, mask):
    total = jnp.maximum(jnp.sum(mask), 1e-15)
    zr = jnp.sum(jnp.cos(theta) * mask) / total
    zi = jnp.sum(jnp.sin(theta) * mask) / total
    return jnp.sqrt(zr**2 + zi**2), jnp.arctan2(zi, zr)


@partial(jax.jit, static_argnames=("wrap",))
def upde_tick(
    theta,            # (L, n) padded phases
    omega,            # (L, n)
    mask,             # (L, n) 1.0 where a real oscillator lives
    k_matrix,         # (L, L) coupling, source row -> target column
    alpha,            # (L, L) Sakaguchi lag
    zeta,             # (L,) global-driver gain
    *,
    dt,
    psi_global,
    actuation_gain=1.0,
    pac_gamma=0.0,
    wrap: bool = True,
):
    """One Euler tick of all layers; returns (theta1, aux)."""
    r_m, psi_m = layer_order_parameters(theta, mask)
    r_glob, psi_r_glob = global_order_parameter(theta, mask)

    # Coupling weight from source n to target m, with PAC gate on
    # inter-layer terms: (1 + gamma (1 - R_n)) for n != m.
    el = jnp.eye(k_matrix.shape[0], dtype=theta.dtype)
    gate = 1.0 + pac_gamma * (1.0 - r_m)[:, None] * (1.0 - el)
    w = actuation_gain * gate * k_matrix * r_m[:, None]   # (L_src, L_tgt)

    # sum_n w[n,m] sin(Psi_n - theta - alpha[n,m])
    #   = S_m cos(theta) - C_m sin(theta)
    beta = psi_m[:, None] - alpha                          # (L_src, L_tgt)
    s_m = jnp.sum(w * jnp.sin(beta), axis=0)               # (L_tgt,)
    c_m = jnp.sum(w * jnp.cos(beta), axis=0)

    dtheta = (omega
              + s_m[:, None] * jnp.cos(theta)
              - c_m[:, None] * jnp.sin(theta)
              + zeta[:, None] * jnp.sin(psi_global - theta))
    theta1 = theta + dt * dtheta
    if wrap:
        theta1 = wrap_phase(theta1)
    theta1 = jnp.where(mask > 0, theta1, 0.0)

    counts = jnp.maximum(jnp.sum(mask, axis=1), 1e-15)
    v_layer = jnp.sum((1.0 - jnp.cos(theta1 - psi_global)) * mask,
                      axis=1) / counts
    v_global = jnp.sum((1.0 - jnp.cos(theta1 - psi_global)) * mask) \
        / jnp.maximum(jnp.sum(mask), 1e-15)
    aux = {"R_layer": r_m, "Psi_layer": psi_m, "R_global": r_glob,
           "Psi_r_global": psi_r_glob, "V_layer": v_layer,
           "V_global": v_global, "dtheta": dtheta}
    return theta1, aux


class UPDETrace(NamedTuple):
    theta: jnp.ndarray        # (T, L, n)
    r_layer: jnp.ndarray      # (T, L)
    r_global: jnp.ndarray     # (T,)
    v_layer: jnp.ndarray      # (T, L)
    v_global: jnp.ndarray     # (T,)
    lambda_exp: jnp.ndarray   # scalar: global Lyapunov exponent


@partial(jax.jit, static_argnames=("n_steps", "psi_mode", "wrap"))
def run_upde(
    theta0, omega, mask, k_matrix, alpha, zeta, *, dt,
    psi_external=0.0, psi_mode: str = "external",
    actuation_gain=1.0, pac_gamma=0.0,
    n_steps: int = 1000, wrap: bool = True,
) -> UPDETrace:
    """Whole multi-layer trajectory in one scan (reference ``run``/
    ``run_lyapunov``)."""
    def step(theta, _):
        if psi_mode == "external":
            psi = jnp.asarray(psi_external)
        else:   # global mean field from layer order parameters
            r_m, psi_m = layer_order_parameters(theta, mask)
            psi = jnp.arctan2(jnp.sum(r_m * jnp.sin(psi_m)),
                              jnp.sum(r_m * jnp.cos(psi_m)))
        theta1, aux = upde_tick(
            theta, omega, mask, k_matrix, alpha, zeta, dt=dt,
            psi_global=psi, actuation_gain=actuation_gain,
            pac_gamma=pac_gamma, wrap=wrap)
        return theta1, (theta1, aux["R_layer"], aux["R_global"],
                        aux["V_layer"], aux["V_global"])

    _, (thetas, r_l, r_g, v_l, v_g) = jax.lax.scan(
        step, theta0, None, length=n_steps)
    return UPDETrace(thetas, r_l, r_g, v_l, v_g,
                     lyapunov_exponent(v_g, dt))
