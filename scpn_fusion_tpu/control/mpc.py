"""Nonlinear model-predictive control with gradient-through-rollout planning.

Compiled redesign of the reference's two MPC lanes
(``control/nmpc_controller.py:50-200`` finite-difference linearised
projected gradient; ``control/fusion_nmpc_jax.py:39-200`` JAX NMPC over a
learned MLP dynamics surrogate): the horizon rollout is a ``lax.scan``, the
planner is Adam on the *exact* gradient of the rollout cost via ``jax.grad``
(no finite-difference Jacobians), and control bounds are enforced by
projection each iteration.  Works with any traced dynamics function
``f(x, u) -> dx/dt`` — an analytic plant, the transport stepper, or a
learned MLP surrogate (``models/surrogates/mlp.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 10
    dt: float = 0.1
    iterations: int = 50
    learning_rate: float = 0.05
    l2_reg: float = 0.01
    u_min: float = -1.0
    u_max: float = 1.0


class MPCPlan(NamedTuple):
    u_traj: jnp.ndarray     # (N, nu) planned inputs
    x_traj: jnp.ndarray     # (N+1, nx) predicted states
    cost: jnp.ndarray
    first_action: jnp.ndarray


def rollout(dynamics: Callable, x0: jnp.ndarray, u_traj: jnp.ndarray,
            dt) -> jnp.ndarray:
    """Euler rollout of dx/dt = f(x, u) under lax.scan; returns (N+1, nx)."""
    def step(x, u):
        x_new = x + dt * dynamics(x, u)
        return x_new, x_new

    _, xs = jax.lax.scan(step, x0, u_traj)
    return jnp.concatenate([x0[None, :], xs], axis=0)


@partial(jax.jit, static_argnames=("dynamics", "cfg"))
def plan(
    dynamics: Callable,
    cfg: MPCConfig,
    x0: jnp.ndarray,
    x_target: jnp.ndarray,
    u_init: jnp.ndarray | None = None,
    q_weights: jnp.ndarray | None = None,
) -> MPCPlan:
    """Solve the finite-horizon tracking problem by Adam on the rollout cost.

    cost = sum_k ||Q (x_k - x*)||^2 + l2 ||u||^2, bounds via projection.
    """
    nx = x0.shape[0]
    nu = u_init.shape[1] if u_init is not None else nx
    if u_init is None:
        u_init = jnp.zeros((cfg.horizon, nu), x0.dtype)
    q = jnp.ones((nx,), x0.dtype) if q_weights is None else q_weights

    def cost_fn(u_traj):
        xs = rollout(dynamics, x0, u_traj, cfg.dt)
        track = jnp.sum((q[None, :] * (xs[1:] - x_target[None, :])) ** 2)
        return track + cfg.l2_reg * jnp.sum(u_traj**2)

    opt = optax.adam(cfg.learning_rate)

    def body(carry, _):
        u, state = carry
        loss, grads = jax.value_and_grad(cost_fn)(u)
        updates, state = opt.update(grads, state, u)
        u = optax.apply_updates(u, updates)
        u = jnp.clip(u, cfg.u_min, cfg.u_max)
        return (u, state), loss

    (u_final, _), _ = jax.lax.scan(
        body, (u_init, opt.init(u_init)), None, length=cfg.iterations)
    xs = rollout(dynamics, x0, u_final, cfg.dt)
    return MPCPlan(u_traj=u_final, x_traj=xs, cost=cost_fn(u_final),
                   first_action=u_final[0])


def mpc_closed_loop(
    dynamics: Callable,
    true_plant: Callable,
    cfg: MPCConfig,
    x0: jnp.ndarray,
    x_target: jnp.ndarray,
    n_steps: int,
    q_weights: jnp.ndarray | None = None,
    nu: int | None = None,
):
    """Receding-horizon closed loop: plan, apply the first action, repeat.

    The loop is a host-level iteration of jitted plans (each plan is one
    device program); warm-starts each plan from the shifted previous one.
    """
    nu = nu if nu is not None else x0.shape[0]
    u_warm = jnp.zeros((cfg.horizon, nu), x0.dtype)
    x = x0
    xs, us = [x0], []
    for _ in range(n_steps):
        p = plan(dynamics, cfg, x, x_target, u_warm, q_weights)
        u = p.first_action
        x = x + cfg.dt * true_plant(x, u)
        xs.append(x)
        us.append(u)
        u_warm = jnp.concatenate([p.u_traj[1:], p.u_traj[-1:]], axis=0)
    return jnp.stack(xs), jnp.stack(us)
