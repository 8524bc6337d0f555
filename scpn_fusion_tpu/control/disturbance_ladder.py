"""Disturbance-rejection ladder: PID vs H-inf vs MPC vs SNN on one plant.

Compiled redesign of the reference's
``validation/benchmark_disturbance_rejection.py`` (PID / LQR-robust /
DARE-MPC / SpikingControllerPool on the linearised vertical-stability
plant, three scenarios, ISE + settling + overshoot metrics; results table
RESULTS.md "Disturbance Rejection").

Plant (reference ``LinearPlant`` :450-497):
    x = [z, dz/dt],  dx/dt = A x + B u + B_d d(t)
    A = [[0, 1], [gamma^2, -10]],  B = [0, 1],  B_d = [0, 0.5]

Scenarios (reference :505-545): VDE impulse kick with 1 cm initial
displacement, density-ramp force, 10 Hz ELM pacing bursts.

Every closed loop runs as ONE ``lax.scan`` at dt = 1e-4 (the reference
steps a Python loop per tick); disturbances are precomputed arrays, and
the whole 4-controller x 3-scenario ladder is a handful of compiled
launches.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

DT = 1e-4
GAMMA_GROWTH = 100.0

SCENARIO_DURATIONS = {"VDE": 2.0, "density_ramp": 4.0, "elm_pacing": 3.0}


def plant_matrices(gamma: float = GAMMA_GROWTH, dtype=jnp.float32):
    a = jnp.asarray([[0.0, 1.0], [gamma * gamma, -10.0]], dtype)
    b = jnp.asarray([0.0, 1.0], dtype)
    b_d = jnp.asarray([0.0, 0.5], dtype)
    return a, b, b_d


def disturbance_trace(scenario: str, dtype=jnp.float32) -> jnp.ndarray:
    """Precomputed d(t) array for the scenario (reference :505-545)."""
    if scenario not in SCENARIO_DURATIONS:
        raise ValueError(f"unknown scenario {scenario!r}")
    t = np.arange(0.0, SCENARIO_DURATIONS[scenario], DT)
    if scenario == "VDE":
        d = np.where(t < 1e-3, 5000.0, 0.0)
    elif scenario == "density_ramp":
        n_frac = np.where(t >= 2.0, 1.2, 0.5 + 0.7 * (t / 2.0))
        d = 200.0 * (n_frac - 1.0)
    elif scenario == "elm_pacing":
        d = np.where((t % 0.1) < 0.5e-3, 1000.0, 0.0)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    return jnp.asarray(d, dtype)


def initial_state(scenario: str, dtype=jnp.float32) -> jnp.ndarray:
    if scenario == "VDE":
        return jnp.asarray([0.01, 0.0], dtype)   # 1 cm displacement
    return jnp.zeros((2,), dtype)


class LadderMetrics(NamedTuple):
    ise: jnp.ndarray
    settling_time_s: jnp.ndarray
    overshoot: jnp.ndarray
    control_effort: jnp.ndarray
    stable: jnp.ndarray
    z_trace: jnp.ndarray


def _metrics(z: jnp.ndarray, u: jnp.ndarray,
             threshold: float = 0.05) -> LadderMetrics:
    n = z.shape[0]
    ise = jnp.sum(z**2) * DT
    over = jnp.max(jnp.abs(z))
    # Settling: last time |z| exceeded threshold * max(|z0|, 1 cm).
    band = threshold * jnp.maximum(jnp.abs(z[0]), 0.01)
    outside = jnp.abs(z) > band
    last_out = jnp.max(jnp.where(outside, jnp.arange(n), -1))
    settle = (last_out + 1).astype(z.dtype) * DT
    stable = jnp.isfinite(ise) & (jnp.abs(z[-1]) < 0.5)
    return LadderMetrics(ise=ise, settling_time_s=settle, overshoot=over,
                         control_effort=jnp.sum(jnp.abs(u)) * DT,
                         stable=stable, z_trace=z)


def _run_loop(step_ctrl, carry0, scenario: str, dtype=jnp.float32,
              u_max: float = 1e6) -> LadderMetrics:
    """Generic closed loop: plant Euler step + controller, one scan."""
    a, b, b_d = plant_matrices(dtype=dtype)
    d_trace = disturbance_trace(scenario, dtype)
    x0 = initial_state(scenario, dtype)

    def step(carry, d):
        x, ctrl_carry = carry
        z = x[0]
        ctrl_carry, u = step_ctrl(ctrl_carry, z)
        u = jnp.clip(u, -u_max, u_max)
        dx = a @ x + b * u + b_d * d
        x = x + DT * dx
        return (x, ctrl_carry), (z, u)

    (_, _), (z, u) = jax.lax.scan(step, (x0, carry0), d_trace)
    return _metrics(z, u)


# ── PID (anti-windup, derivative on measurement) ─────────────────────────


@partial(jax.jit, static_argnames=("scenario", "dtype"))
def run_pid(scenario: str, kp: float = 3e4, ki: float = 1e4,
            kd: float = 250.0, dtype=jnp.float32) -> LadderMetrics:
    """Tuned PID on z (reference ``PIDController`` :164-210 semantics)."""

    def step_ctrl(carry, z):
        integ, z_prev = carry
        err = -z
        integ = jnp.clip(integ + err * DT, -10.0, 10.0)   # anti-windup
        deriv = -(z - z_prev) / DT
        u = kp * err + ki * integ + kd * deriv
        return (integ, z), u

    carry0 = (jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype))
    return _run_loop(step_ctrl, carry0, scenario, dtype)


# ── H-infinity (central solution on the time-scaled plant) ───────────────


@partial(jax.jit, static_argnames=("scenario", "dtype"))
def run_hinf(scenario: str, gamma_hinf: float = 8.0,
             dtype=jnp.float32) -> LadderMetrics:
    """Observer-based central H-inf output feedback.

    The Riccati ODE integrates on the TIME-SCALED plant (tau = g t,
    x2' = dz/g with g the growth rate): eigenvalues are O(1), so the
    fixed-step CARE integration is stable where the raw plant (lambda =
    +-100) would blow it up.  Gains map back exactly.
    """
    from scpn_fusion_tpu.control.hinf import (
        HInfState,
        hinf_step,
        synthesize_hinf,
    )

    g = GAMMA_GROWTH
    a_s = jnp.asarray([[0.0, 1.0], [1.0, -10.0 / g]], dtype)
    b1_s = jnp.asarray([[0.0], [0.5 / (g * g)]], dtype)
    b2_s = jnp.asarray([[0.0], [1.0 / (g * g)]], dtype)
    c1 = jnp.asarray([[1.0, 0.0], [0.0, 0.1]], dtype)
    c2 = jnp.asarray([[1.0, 0.0]], dtype)
    gains = synthesize_hinf(a_s, b1_s, b2_s, c1, c2,
                            jnp.asarray(gamma_hinf, dtype),
                            riccati_steps=3000, riccati_dt=0.01)

    def step_ctrl(carry, z):
        # Observer runs in scaled time: d tau = g dt.
        state, u = hinf_step(
            gains, a_s, b2_s, c2, carry, jnp.asarray([z], z.dtype),
            g * DT, u_max=1e6)
        return state, u[0]

    carry0 = HInfState(x_hat=jnp.zeros((2,), dtype))
    return _run_loop(step_ctrl, carry0, scenario, dtype)


# ── MPC (DARE-optimal discrete LQR, reference ``MPCController``) ─────────


def _dare_gain(a_d, b_d, q, r, n_iter: int = 2000):
    """Fixed-point Riccati difference iteration -> steady-state gain K."""

    def body(p, _):
        btp = b_d @ p
        denom = r + btp @ b_d
        k = (btp @ a_d) / denom
        p_new = q + a_d.T @ p @ a_d - jnp.outer(a_d.T @ btp, k)
        return p_new, None

    p0 = jnp.eye(2, dtype=a_d.dtype)
    p, _ = jax.lax.scan(body, p0, None, length=n_iter)
    btp = b_d @ p
    return (btp @ a_d) / (r + btp @ b_d)


@partial(jax.jit, static_argnames=("scenario", "dtype"))
def run_mpc(scenario: str, dtype=jnp.float32) -> LadderMetrics:
    """Unconstrained receding-horizon MPC == DARE LQR on the ZOH plant
    (the reference's MPCController solves exactly this :305-395); state
    [z, dz] estimated from successive measurements."""
    a, b, _ = plant_matrices(dtype=dtype)
    a_d = jnp.eye(2, dtype=dtype) + DT * a
    b_d = DT * b
    q = jnp.asarray([[1.0, 0.0], [0.0, 1e-4]], dtype)
    k_gain = _dare_gain(a_d, b_d, q, jnp.asarray(1e-9, dtype))

    def step_ctrl(z_prev, z):
        dz = (z - z_prev) / DT
        u = -(k_gain[0] * z + k_gain[1] * dz)
        return z, u

    return _run_loop(step_ctrl, jnp.asarray(0.0, dtype), scenario, dtype)


# ── SNN (SCPN fused controller tick) ─────────────────────────────────────


def _build_z_net(gain: float, dtype):
    from scpn_fusion_tpu.scpn.controller import build_controller
    from scpn_fusion_tpu.scpn.structure import StochasticPetriNet

    net = StochasticPetriNet()
    for p in ("eZ+", "eZ-", "cZ+", "cZ-", "sink"):
        net.add_place(p)
    for t, src, dst in (("tZ+", "eZ+", "cZ+"), ("tZ-", "eZ-", "cZ-")):
        net.add_transition(t, threshold=0.01)
        net.add_arc(src, t)
        net.add_arc(t, dst)
    # Drain transitions: leaky readout.  Without them the command places
    # integrate every firing, BOTH saturate at 1, and the action
    # difference collapses to zero while the gamma=100/s instability runs
    # free (measured: unopposed divergence from tick ~100).
    for t, src in (("dZ+", "cZ+"), ("dZ-", "cZ-")):
        net.add_transition(t, threshold=0.0)
        net.add_arc(src, t)
        net.add_arc(t, "sink")
    compiled = net.compile()
    return build_controller(
        compiled,
        axis_targets=[0.0], axis_scales=[0.05],
        injections=[("eZ+", 0, True, 1.0, 0.0),
                    ("eZ-", 0, False, 1.0, 0.0)],
        actions=[("cZ+", "cZ-", gain, 1e6, 1e9)],
        dtype=dtype)


@partial(jax.jit, static_argnames=("scenario", "dtype"))
def run_snn(scenario: str, gain: float = 2e3,
            dtype=jnp.float32) -> LadderMetrics:
    """Fused SCPN/LIF controller in the loop (reference
    ``SNNControllerWrapper`` over ``SpikingControllerPool``).  The spiking
    path quantises the error through threshold firing, so its ISE is
    expected orders above the linear controllers — the reference's table
    shows the same (7.74e-2 vs 1e-5-class)."""
    from scpn_fusion_tpu.scpn.controller import (
        ControllerConfig,
        controller_step,
        initial_controller_state,
    )

    ctrl = _build_z_net(gain, dtype)
    cfg = ControllerConfig(firing_mode="fractional", firing_margin=0.5,
                           dt=DT)
    state0 = initial_controller_state(ctrl, cfg)

    def step_ctrl(carry, z):
        state, k = carry
        state, actions, _ = controller_step(
            ctrl, cfg, state, jnp.asarray([z], dtype), k)
        return (state, k + 1), actions[0]

    return _run_loop(step_ctrl, (state0, jnp.int32(0)), scenario, dtype)


RUNNERS = {"PID": run_pid, "H-infinity": run_hinf, "MPC": run_mpc,
           "SNN": run_snn}


def run_ladder(scenarios=("VDE", "density_ramp", "elm_pacing"),
               dtype=jnp.float32) -> dict:
    """Full controller x scenario table (reference output shape)."""
    out = {}
    for scenario in scenarios:
        for name, runner in RUNNERS.items():
            m = runner(scenario, dtype=dtype)
            out[(name, scenario)] = {
                "ise": float(m.ise),
                "settling_time_s": float(m.settling_time_s),
                "overshoot": float(m.overshoot),
                "control_effort": float(m.control_effort),
                "stable": bool(m.stable),
            }
    return out
