"""1000-shot stress-test campaign (vmapped randomized flight sims).

Compiled redesign of the reference's
``validation/stress_test_campaign.py`` (Step 2.1: PID across 1000
identical-scenario episodes with injected sensor noise, ELM events, and
ramp transients; headline result: 0% disruption rate, BASELINE.md).

The reference runs 1000 sequential Python episodes; here every episode
is a ``lax.scan`` and the WHOLE campaign is one ``vmap`` over per-shot
PRNG keys — 1000 stochastic shots execute as a single compiled program
on the chip.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.control.flight_sim import (
    FlightSimParams,
    PIDGains,
    _envelope,
    pid_init,
    pid_step,
)


@dataclasses.dataclass(frozen=True)
class StressConfig:
    """Disturbance injection knobs (reference campaign scenario set)."""

    sensor_noise_m: float = 0.005       # measurement noise sigma [m]
    elm_rate_hz: float = 10.0           # ELM event frequency
    elm_kick_m: float = 0.02            # radial kick per ELM
    ramp_disturbance_m_s: float = 0.01  # slow drift transient
    disruption_limit_m: float = 0.5


class StressResult(NamedTuple):
    disruption_rate: jnp.ndarray    # fraction of shots EVER disrupted
    r_err_p50: jnp.ndarray
    r_err_p95: jnp.ndarray
    r_err_p99: jnp.ndarray
    z_err_p95: jnp.ndarray
    mean_final_err: jnp.ndarray
    per_shot_disrupted: jnp.ndarray


@partial(jax.jit, static_argnames=("params", "cfg", "n_shots"))
def run_stress_campaign(
    params: FlightSimParams = FlightSimParams(),
    cfg: StressConfig = StressConfig(),
    *,
    n_shots: int = 1000,
    seed: int = 0,
    dtype=jnp.float32,
) -> StressResult:
    """All shots in one compiled program (vmap over PRNG keys)."""
    dt = params.control_dt
    n = params.n_steps
    dt_ref = 0.01
    g_r = PIDGains(jnp.asarray(params.pid_r_kp, dtype),
                   jnp.asarray(params.pid_r_ki * dt / dt_ref, dtype),
                   jnp.asarray(params.pid_r_kd * dt_ref / dt, dtype))
    g_z = PIDGains(jnp.asarray(params.pid_z_kp, dtype),
                   jnp.asarray(params.pid_z_ki * dt / dt_ref, dtype),
                   jnp.asarray(params.pid_z_kd * dt_ref / dt, dtype))
    p_elm = jnp.asarray(cfg.elm_rate_hz * dt, dtype)

    def one_shot(key):
        keys = jax.random.split(key, n)

        def step(carry, inputs):
            (r, z, beta, heating, pid_r, pid_z, pf_r, pf_z,
             disrupted_ever) = carry
            k, kk = inputs
            phase = jnp.clip(k.astype(dtype) * dt / params.shot_duration_s,
                             0.0, 1.0)
            # Plant evolution with injected transients.
            heating_req = 20.0 + 60.0 * phase
            heating = _envelope(heating_req, heating,
                                params.heating_rate_limit,
                                params.heating_abs_max, dt)
            heating = jnp.clip(heating, 0.0,
                               params.heating_abs_max).astype(dtype)
            beta_t = 0.6 + 0.03 * heating
            beta = jnp.clip(beta + 0.5 * (beta_t - beta) * dt,
                            0.2, 10.0).astype(dtype)

            k1, k2, k3 = jax.random.split(kk, 3)
            elm = (jax.random.uniform(k1) < p_elm).astype(dtype) \
                * cfg.elm_kick_m * jax.random.normal(k2, dtype=dtype)
            drift = cfg.ramp_disturbance_m_s * jnp.sin(
                2.0 * jnp.pi * phase)

            r = jnp.clip(r + (0.01 * beta + drift) * dt + elm,
                         2.0, 10.0).astype(dtype)
            z = jnp.clip(z + 0.02 * dt + 0.5 * elm, -6.0, 6.0).astype(dtype)

            # Control on NOISY measurements.
            noise = cfg.sensor_noise_m * jax.random.normal(k3, (2,), dtype)
            pid_r, cmd_r = pid_step(g_r, pid_r,
                                    params.target_r - (r + noise[0]))
            pid_z, cmd_z = pid_step(g_z, pid_z,
                                    params.target_z - (z + noise[1]))
            ctrl_r = _envelope(cmd_r, pf_r, params.pf_rate_limit,
                               params.pf_abs_max, dt)
            ctrl_z = _envelope(cmd_z, pf_z, params.pf_rate_limit,
                               params.pf_abs_max, dt)
            r = jnp.clip(r + ctrl_r * dt, 2.0, 10.0).astype(dtype)
            z = jnp.clip(z + ctrl_z * dt, -6.0, 6.0).astype(dtype)

            r_err = jnp.abs(r - params.target_r)
            z_err = jnp.abs(z - params.target_z)
            disrupted = (r_err > cfg.disruption_limit_m) | \
                        (z_err > cfg.disruption_limit_m)
            carry = (r, z, beta, heating, pid_r, pid_z, ctrl_r, ctrl_z,
                     disrupted_ever | disrupted)
            return carry, (r_err, z_err)

        init = (jnp.asarray(params.target_r + 0.1, dtype),
                jnp.asarray(params.target_z + 0.05, dtype),
                jnp.asarray(0.6, dtype), jnp.asarray(20.0, dtype),
                pid_init(dtype), pid_init(dtype),
                jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype),
                jnp.bool_(False))
        carry, (r_err, z_err) = jax.lax.scan(
            step, init, (jnp.arange(n), keys))
        return carry[-1], r_err, z_err

    shot_keys = jax.random.split(jax.random.PRNGKey(seed), n_shots)
    disrupted, r_err, z_err = jax.vmap(one_shot)(shot_keys)
    return StressResult(
        disruption_rate=jnp.mean(disrupted.astype(dtype)),
        r_err_p50=jnp.percentile(r_err, 50.0),
        r_err_p95=jnp.percentile(r_err, 95.0),
        r_err_p99=jnp.percentile(r_err, 99.0),
        z_err_p95=jnp.percentile(z_err, 95.0),
        mean_final_err=jnp.mean(r_err[:, -1] + z_err[:, -1]),
        per_shot_disrupted=disrupted)
