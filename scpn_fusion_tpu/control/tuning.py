"""Automated controller gain tuning — batched cross-entropy search on device.

Compiled re-design of the reference's Optuna-based tuner
(``control/controller_tuning.py:184-238`` ``tune_pid``, ``:240-264``
``tune_hinf``): where the reference runs sequential Optuna trials, each one a
host-Python Gymnasium rollout, here a whole GENERATION of candidates is one
batched device program — the closed-loop shot is vmapped over the population
and the full cross-entropy-method (CEM) optimisation is a single
``lax.scan`` under one jit.  A 20-generation x 128-candidate tuning run is
2560 complete closed-loop shots in one compiled call.

Sampling is in log-space, matching the reference's ``log=True`` Optuna
search distributions (``controller_tuning.py:221-224``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.control.flight_sim import (
    FlightSimParams,
    run_shot_reduced_gains,
)
from scpn_fusion_tpu.control.hinf import HInfState, hinf_step, synthesize_hinf


class CEMResult(NamedTuple):
    best_params: jnp.ndarray      # (k,) best candidate ever seen
    best_cost: jnp.ndarray        # scalar
    mean: jnp.ndarray             # (k,) final sampling mean (log-space)
    cost_history: jnp.ndarray     # (n_gen,) best cost per generation


def cem_minimize(
    objective: Callable[[jnp.ndarray], jnp.ndarray],
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    key: jnp.ndarray,
    *,
    population: int = 128,
    n_generations: int = 20,
    elite_frac: float = 0.125,
    init_std: float = 0.6,
    min_std: float = 0.02,
) -> CEMResult:
    """Minimise ``objective`` over a box ``[lo, hi]`` (log-uniform geometry).

    ``objective`` maps a ``(k,)`` parameter vector to a scalar cost and must
    be traceable; it is vmapped over the population.  The entire optimisation
    (sample -> batch-evaluate -> elite refit) runs as one ``lax.scan``.
    """
    lo = jnp.asarray(lo, jnp.float32)
    hi = jnp.asarray(hi, jnp.float32)
    log_lo, log_hi = jnp.log(lo), jnp.log(hi)
    k = lo.shape[0]
    n_elite = max(1, int(population * elite_frac))
    batch_obj = jax.vmap(objective)

    def decode(z):
        # z in log-space, clipped to the box.
        return jnp.exp(jnp.clip(z, log_lo, log_hi))

    def generation(carry, key_g):
        mean, std, best_p, best_c = carry
        z = mean + std * jax.random.normal(key_g, (population, k),
                                           dtype=mean.dtype)
        costs = batch_obj(decode(z)).astype(jnp.float32)
        costs = jnp.where(jnp.isfinite(costs), costs, jnp.inf)
        order = jnp.argsort(costs)
        elite = z[order[:n_elite]]
        new_mean = jnp.mean(elite, axis=0)
        new_std = jnp.maximum(jnp.std(elite, axis=0), min_std)
        gen_best_c = costs[order[0]]
        gen_best_p = decode(z[order[0]])
        improved = gen_best_c < best_c
        best_c = jnp.where(improved, gen_best_c, best_c)
        best_p = jnp.where(improved, gen_best_p, best_p)
        return (new_mean, new_std, best_p, best_c), gen_best_c

    mean0 = 0.5 * (log_lo + log_hi)
    std0 = jnp.full((k,), init_std, jnp.float32) * (log_hi - log_lo) / 2.0
    init = (mean0, std0, decode(mean0), jnp.asarray(jnp.inf, jnp.float32))
    keys = jax.random.split(key, n_generations)
    (mean, _, best_p, best_c), hist = jax.lax.scan(generation, init, keys)
    return CEMResult(best_p, best_c, mean, hist)


# ── PID tuning on the reduced flight-sim lane ────────────────────────────

PID_BOUNDS_LO = jnp.asarray([0.1, 0.01, 0.01, 0.1, 0.01, 0.01])
PID_BOUNDS_HI = jnp.asarray([10.0, 1.0, 1.0, 10.0, 1.0, 1.0])


def pid_shot_cost(params: FlightSimParams, gains: jnp.ndarray) -> jnp.ndarray:
    """Integral-absolute-error score of one closed-loop reduced shot
    (reference ``_pid_rollout_score`` :148-181: summed |tracking error| with
    a max-steps residual penalty; here plus an explicit disruption term)."""
    trace, metrics = run_shot_reduced_gains(params, gains)
    iae = jnp.mean(jnp.abs(trace.r_err)) + jnp.mean(jnp.abs(trace.z_err))
    return iae + 10.0 * metrics["disruption_fraction"] \
        + metrics["r_err_final"] + metrics["z_err_final"]


@partial(jax.jit, static_argnames=("params", "population", "n_generations"))
def tune_pid(
    params: FlightSimParams,
    key: jnp.ndarray,
    *,
    population: int = 128,
    n_generations: int = 15,
) -> CEMResult:
    """Tune the six reduced-lane PID gains
    ``[r_kp, r_ki, r_kd, z_kp, z_ki, z_kd]`` over the reference's log-uniform
    search box (``controller_tuning.py:221-224`` per-axis)."""
    return cem_minimize(
        lambda g: pid_shot_cost(params, g),
        jnp.asarray(PID_BOUNDS_LO), jnp.asarray(PID_BOUNDS_HI), key,
        population=population, n_generations=n_generations)


# ── H-infinity (gamma, bandwidth-weight) tuning ──────────────────────────

HINF_BOUNDS_LO = jnp.asarray([1.01, 0.05])
HINF_BOUNDS_HI = jnp.asarray([20.0, 5.0])


def hinf_closed_loop_cost(
    a: jnp.ndarray, b1: jnp.ndarray, b2: jnp.ndarray,
    c1: jnp.ndarray, c2: jnp.ndarray,
    theta: jnp.ndarray,
    *,
    x0: jnp.ndarray,
    dt: float = 0.01,
    n_steps: int = 400,
    riccati_steps: int = 800,
) -> jnp.ndarray:
    """Closed-loop regulation cost of the central H-inf controller
    synthesised at ``theta = [gamma, bandwidth_weight]``.

    Unlike the reference's tune_hinf objective (distance to target
    parameters, ``controller_tuning.py:258-261``), the tuned parameters are
    scored by what they DO: synthesize at (gamma, w.C1), roll the
    observer-based loop from a perturbed state, and integrate state + control
    energy, with an infeasibility penalty from the rho(XY) < gamma^2 test.
    """
    dtype = jnp.result_type(a, theta)
    a, b1, b2, c1, c2, x0, theta = (
        x.astype(dtype) for x in (a, b1, b2, c1, c2, x0, theta))
    gamma, w = theta[0], theta[1]
    gains = synthesize_hinf(a, b1, b2, w * c1, c2, gamma,
                            riccati_steps=riccati_steps, riccati_dt=dt)

    def step(carry, _):
        x, est = carry
        y_meas = c2 @ x
        est, u = hinf_step(gains, a, b2, c2, est, y_meas, dt, u_max=1e3)
        x = x + dt * (a @ x + b2 @ u)
        return (x, est), jnp.sum(x * x) + 1e-3 * jnp.sum(u * u)

    est0 = HInfState(jnp.zeros_like(x0))
    _, cost_t = jax.lax.scan(step, (x0, est0), None, length=n_steps)
    ise = dt * jnp.sum(cost_t)
    penalty = jnp.where(gains.robust_feasible, 0.0, 1e3)
    return ise + penalty


@partial(jax.jit, static_argnames=("population", "n_generations"))
def tune_hinf(
    a: jnp.ndarray, b1: jnp.ndarray, b2: jnp.ndarray,
    c1: jnp.ndarray, c2: jnp.ndarray,
    key: jnp.ndarray,
    *,
    x0: jnp.ndarray | None = None,
    population: int = 64,
    n_generations: int = 10,
) -> CEMResult:
    """Tune ``[gamma, bandwidth_weight]`` for the central H-inf design over
    the reference's search box (gamma in [1.01, 20], bandwidth log-uniform in
    [0.05, 5] — ``controller_tuning.py:258-259``), scored by closed-loop
    regulation performance.  Every generation synthesises and rolls out
    ``population`` complete Riccati designs in one vmapped program."""
    if x0 is None:
        x0 = jnp.ones((a.shape[0],), jnp.float32)
    return cem_minimize(
        lambda th: hinf_closed_loop_cost(a, b1, b2, c1, c2, th, x0=x0),
        jnp.asarray(HINF_BOUNDS_LO), jnp.asarray(HINF_BOUNDS_HI), key,
        population=population, n_generations=n_generations)
