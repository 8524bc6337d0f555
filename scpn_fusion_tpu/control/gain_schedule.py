"""Gain-scheduled PID bank with hysteretic regime detection.

JAX-native equivalent of the reference scheduler
(``control/gain_scheduled_controller.py:22-148``): six discharge regimes
(ramp-up, L-mode, L-H transition, H-mode, ramp-down, disruption
mitigation), a hysteresis detector over a rolling history buffer, and a
PID bank with bumpless linear gain interpolation during regime switches.

The reference mutates Python object state per step; here the regime bank
is a stacked (n_regimes, n_ch) array pytree and the detector/controller
state is an explicit ``ScheduleState`` NamedTuple, so an entire shot —
detection, switching, interpolation, PID — runs inside one ``lax.scan``
with ``jnp.where``/one-hot arithmetic instead of branches.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Regime codes (static ints — the device-side regime is just an int32).
RAMP_UP = 0
L_MODE_FLAT = 1
LH_TRANSITION = 2
H_MODE_FLAT = 3
RAMP_DOWN = 4
DISRUPTION_MITIGATION = 5
N_REGIMES = 6


@dataclasses.dataclass(frozen=True)
class DetectorThresholds:
    ramp_rate: float = 0.1          # |dIp/dt| above which we are ramping
    tau_e_l_mode: float = 1.0       # L-mode confinement reference [s]
    tau_e_jump: float = 1.5        # H-mode threshold multiplier
    disruption_prob: float = 0.8
    history_len: int = 5


class GainBank(NamedTuple):
    """Stacked per-regime PID gains and setpoints, shape (N_REGIMES, n_ch)."""

    kp: jnp.ndarray
    ki: jnp.ndarray
    kd: jnp.ndarray
    x_ref: jnp.ndarray


class ScheduleState(NamedTuple):
    regime: jnp.ndarray         # int32 current regime
    prev_regime: jnp.ndarray    # int32
    switch_time: jnp.ndarray    # f32 (-1 = never switched)
    history: jnp.ndarray        # (history_len,) int32 raw detections
    integral: jnp.ndarray       # (n_ch,)
    prev_error: jnp.ndarray     # (n_ch,)


def init_schedule_state(n_ch: int, history_len: int = 5,
                        dtype=jnp.float32) -> ScheduleState:
    return ScheduleState(
        jnp.int32(RAMP_UP), jnp.int32(RAMP_UP), jnp.asarray(-1.0, dtype),
        jnp.full((history_len,), RAMP_UP, jnp.int32),
        jnp.zeros((n_ch,), dtype), jnp.zeros((n_ch,), dtype))


def detect_regime(th: DetectorThresholds, history: jnp.ndarray,
                  dip_dt, tau_e, p_disrupt):
    """Hysteretic classification (reference ``RegimeDetector.detect``):
    the raw detection enters a rolling buffer; the committed regime only
    changes when the buffer is unanimous."""
    raw = jnp.where(
        p_disrupt > th.disruption_prob, DISRUPTION_MITIGATION,
        jnp.where(dip_dt > th.ramp_rate, RAMP_UP,
                  jnp.where(dip_dt < -th.ramp_rate, RAMP_DOWN,
                            jnp.where(tau_e > th.tau_e_jump * th.tau_e_l_mode,
                                      H_MODE_FLAT, L_MODE_FLAT)))).astype(
                                          jnp.int32)
    history = jnp.roll(history, -1).at[-1].set(raw)
    unanimous = jnp.all(history == raw)
    committed = jnp.where(unanimous, raw, history[0])
    return committed, history


@partial(jax.jit, static_argnames=("th",))
def schedule_step(
    th: DetectorThresholds,
    bank: GainBank,
    state: ScheduleState,
    x: jnp.ndarray,          # (n_ch,) measured state
    t,
    dt,
    *,
    dip_dt,
    tau_e,
    p_disrupt,
    tau_switch: float = 0.5,
):
    """One detector + bumpless-PID step; returns (u, new_state)."""
    detected, history = detect_regime(th, state.history, dip_dt, tau_e,
                                      p_disrupt)
    switched = detected != state.regime
    prev_regime = jnp.where(switched, state.regime, state.prev_regime)
    regime = detected
    switch_time = jnp.where(switched, jnp.asarray(t, state.switch_time.dtype),
                            state.switch_time)
    # Disruption mitigation entry resets the integrator (anti-windup).
    integral = jnp.where(switched & (detected == DISRUPTION_MITIGATION),
                         jnp.zeros_like(state.integral), state.integral)

    # Bumpless interpolation old -> new over tau_switch.
    in_blend = (switch_time >= 0) & (t - switch_time < tau_switch)
    alpha = jnp.where(in_blend, (t - switch_time) / tau_switch, 1.0)

    def blend(table):
        old = table[prev_regime]
        new = table[regime]
        return (1.0 - alpha) * old + alpha * new

    kp, ki, kd, x_ref = (blend(bank.kp), blend(bank.ki), blend(bank.kd),
                         blend(bank.x_ref))

    error = x_ref - x
    integral = integral + error * dt
    derror = (error - state.prev_error) / jnp.maximum(dt, 1e-6)
    u = kp * error + ki * integral + kd * derror

    return u, ScheduleState(regime, prev_regime, switch_time, history,
                            integral, error)


class Waveform(NamedTuple):
    """Piecewise-linear scenario waveform: value(t) by interp over knots."""

    times: jnp.ndarray
    values: jnp.ndarray

    def __call__(self, t):
        return jnp.interp(jnp.asarray(t), self.times, self.values)


def iter_baseline_waveforms() -> dict:
    """ITER-like baseline scenario (reference ``iter_baseline_schedule``):
    Ip ramp to 15 MA, density ramp, heating staircase."""
    f32 = jnp.float32
    return {
        "ip_ma": Waveform(jnp.asarray([0., 80., 100., 500., 560., 600.], f32),
                          jnp.asarray([0.5, 15., 15., 15., 2., 0.], f32)),
        "n_e_19": Waveform(jnp.asarray([0., 100., 150., 500., 600.], f32),
                           jnp.asarray([1., 8., 10., 10., 2.], f32)),
        "p_aux_mw": Waveform(jnp.asarray([0., 90., 110., 500., 520.], f32),
                             jnp.asarray([0., 20., 50., 50., 0.], f32)),
    }
