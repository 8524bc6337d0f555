"""Push-pull spiking-population axis control, scan-fused on device.

Compiled re-design of the reference's neuro-cybernetic controller
(``control/neuro_cybernetic_controller.py``): ``SpikingControllerPool``
(:53-194) steps two LIF populations (push/pull) per axis in a Python loop
over neuron objects with a ``deque`` spike-rate window;
``NeuroCyberneticController`` (:196-443) then runs a shot host-side,
calling the kernel equilibrium solve per tick and a
``SafetyInterlockRuntime`` check.  Here each population is a vectorised
membrane array, the spike-count window is a rolling buffer in the scan
carry, and the WHOLE shot — both R/Z push-pull brains (4 populations),
plant, and the vertical-rate safety interlock — is one ``lax.scan`` under
jit, vmappable over seeds.

Compatibility notes: LIF constants match the reference's NumPy lane
(:138-151: dt/tau = 1e-3/15e-3, noise 0.02, threshold 0.35, i_scale 5,
i_bias 0.1); brain sizing matches ``initialize_brains`` (:241-257:
n=50, window 20, gain 10 radial / 20 vertical).  The reference's
``sc-neurocore`` stochastic-entropy source is a hardware RNG; both modes
here are deterministic PRNG streams (classical / entropy-folded),
disclosed.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class LIFPoolParams:
    """Push-pull population configuration (hashable, jit-static)."""

    n_neurons: int = 50
    gain: float = 10.0
    tau_window: int = 20
    dt_s: float = 1.0e-3
    tau_mem_s: float = 15.0e-3
    noise_std: float = 0.02
    i_scale: float = 5.0
    i_bias: float = 0.1
    v_threshold: float = 0.35
    v_reset: float = 0.0

    def __post_init__(self) -> None:
        if self.n_neurons < 1:
            raise ValueError("n_neurons must be >= 1")
        if self.tau_window < 1:
            raise ValueError("tau_window must be >= 1")
        if self.dt_s <= 0.0 or self.tau_mem_s <= 0.0:
            raise ValueError("dt_s and tau_mem_s must be > 0")

    @property
    def alpha(self) -> float:
        return self.dt_s / self.tau_mem_s


class PoolState(NamedTuple):
    v_pos: jnp.ndarray     # (n,) membrane potentials
    v_neg: jnp.ndarray
    hist_pos: jnp.ndarray  # (window,) spike counts
    hist_neg: jnp.ndarray
    cursor: jnp.ndarray


def pool_init(p: LIFPoolParams, dtype=jnp.float32) -> PoolState:
    return PoolState(
        v_pos=jnp.zeros((p.n_neurons,), dtype),
        v_neg=jnp.zeros((p.n_neurons,), dtype),
        hist_pos=jnp.zeros((p.tau_window,), dtype),
        hist_neg=jnp.zeros((p.tau_window,), dtype),
        cursor=jnp.int32(0),
    )


def _population_step(p: LIFPoolParams, v, i_in, key):
    """Leaky integrate-and-fire sweep of one population
    (reference ``_step_numpy_population`` :151-163)."""
    noise = p.noise_std * jax.random.normal(key, v.shape, v.dtype)
    v = v + p.alpha * (-v + i_in + noise)
    fired = v >= p.v_threshold
    v = jnp.where(fired, p.v_reset, v)
    return v, jnp.sum(fired.astype(v.dtype))


def pool_step(p: LIFPoolParams, state: PoolState, error, key):
    """One push-pull tick: rectified error drives the two populations;
    returns ``(state, command, (rate_pos, rate_neg))``
    (reference ``SpikingControllerPool.step`` :165-194)."""
    kp, kn = jax.random.split(key)
    i_pos = p.i_bias + jnp.maximum(error, 0.0) * p.i_scale
    i_neg = p.i_bias + jnp.maximum(-error, 0.0) * p.i_scale
    v_pos, n_pos = _population_step(p, state.v_pos, i_pos, kp)
    v_neg, n_neg = _population_step(p, state.v_neg, i_neg, kn)
    hist_pos = state.hist_pos.at[state.cursor].set(n_pos)
    hist_neg = state.hist_neg.at[state.cursor].set(n_neg)
    cursor = (state.cursor + 1) % p.tau_window
    denom = float(p.tau_window * p.n_neurons)
    rate_pos = jnp.sum(hist_pos) / denom
    rate_neg = jnp.sum(hist_neg) / denom
    command = (rate_pos - rate_neg) * p.gain
    return (PoolState(v_pos, v_neg, hist_pos, hist_neg, cursor),
            command, (rate_pos, rate_neg))


class NeuroShotTrace(NamedTuple):
    r: jnp.ndarray
    z: jnp.ndarray
    err_r: jnp.ndarray
    err_z: jnp.ndarray
    ctrl_r: jnp.ndarray
    ctrl_z: jnp.ndarray
    spike_rate: jnp.ndarray
    position_allowed: jnp.ndarray


@partial(jax.jit, static_argnames=("n_ticks", "brain_r", "brain_z",
                                  "stochastic"))
def run_neuro_cybernetic_shot(
    key: jnp.ndarray,
    *,
    n_ticks: int = 200,
    brain_r: LIFPoolParams = LIFPoolParams(gain=10.0),
    brain_z: LIFPoolParams = LIFPoolParams(gain=20.0),
    target_r: float = 6.2,
    target_z: float = 0.0,
    r0: float = 6.0,
    z0: float = 0.3,
    dt: float = 0.05,
    beta: float = 1.0,
    vertical_limit_m_s: float = 1.0,
    actuation_gain: float = 0.04,
    stochastic: bool = False,
):
    """Whole spiking-control shot as one fused program.

    Plant: the reduced Shafranov-drift R/Z axis model
    (``neuro_closed_loop.reduced_plant_step`` semantics).  The vertical
    channel passes through a position interlock: when |dZ/dt| exceeds
    ``vertical_limit_m_s`` the position move is inhibited (the reference's
    ``position_move`` inhibitor arc, ``scpn/safety_interlocks.py``) and
    the tick is recorded as disallowed.

    Returns ``(trace, metrics)``; metrics mirror the reference's telemetry
    (:420-443: final/mean errors, spike rates, safety allow rate, trips).
    """
    stochastic_flag = bool(stochastic)

    def tick(carry, inputs):
        k_idx, key_t = inputs
        br, bz, r, z, z_prev = carry
        err_r = target_r - r
        err_z = target_z - z
        kr, kz = jax.random.split(jax.random.fold_in(
            key_t, 1 if stochastic_flag else 0))
        br, ctrl_r, (rp_r, rn_r) = pool_step(brain_r, br, err_r, kr)
        bz, ctrl_z, (rp_z, rn_z) = pool_step(brain_z, bz, err_z, kz)

        dz_dt = (z - z_prev) / dt
        allowed = jnp.abs(dz_dt) <= vertical_limit_m_s
        ctrl_z_eff = jnp.where(allowed, ctrl_z, 0.0)

        # actuation_gain maps spike-rate commands (|cmd| <= gain) onto
        # bounded axis velocities, the role the coil-response chain plays
        # in the reference's kernel-in-loop shot (:365-375).
        r_new = jnp.clip(
            r + (0.01 * beta + actuation_gain * ctrl_r) * dt, 2.0, 10.0)
        z_new = jnp.clip(
            z + (0.02 + actuation_gain * ctrl_z_eff) * dt, -6.0, 6.0)
        rate = 0.25 * (rp_r + rn_r + rp_z + rn_z)
        out = NeuroShotTrace(r_new, z_new, err_r, err_z, ctrl_r,
                             ctrl_z_eff, rate, allowed)
        return (br, bz, r_new, z_new, z), out

    keys = jax.random.split(key, n_ticks)
    init = (pool_init(brain_r), pool_init(brain_z),
            jnp.float32(r0), jnp.float32(z0), jnp.float32(z0))
    _, trace = jax.lax.scan(tick, init,
                            (jnp.arange(n_ticks), keys))
    metrics = {
        "final_r": trace.r[-1],
        "final_z": trace.z[-1],
        "mean_abs_err_r": jnp.mean(jnp.abs(trace.err_r)),
        "mean_abs_err_z": jnp.mean(jnp.abs(trace.err_z)),
        "final_abs_err_r": jnp.abs(trace.err_r[-1]),
        "final_abs_err_z": jnp.abs(trace.err_z[-1]),
        "mean_spike_rate": jnp.mean(trace.spike_rate),
        "safety_position_allow_rate":
            jnp.mean(trace.position_allowed.astype(jnp.float32)),
        "safety_interlock_trips":
            jnp.sum(~trace.position_allowed),
    }
    return trace, metrics
