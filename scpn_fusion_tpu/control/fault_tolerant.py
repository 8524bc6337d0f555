"""Fault-tolerant control: FDI + reconfigurable allocation, one-scan shots.

Covers the reference's ``control/fault_tolerant_control.py``
(``FDIMonitor:43``, ``ReconfigurableController:100``, ``FaultInjector:215``):
Tikhonov weighted-least-squares control allocation whose gain is rebuilt
when actuators or sensors fault — zeroed Jacobian columns for lost coils,
down-weighted rows for degraded sensors, stuck-actuator offset
compensation, a minimum-rank controllability check, and a graceful
shutdown command.

JAX-native design (vs the reference's mutable sets/dicts + per-event
NumPy pinv): the fault condition IS the state — a :class:`FaultState`
pytree of arrays (coil mask, sensor weights, stuck values) — and every
operation is a pure jittable function of it.  The allocation gain is a
closed-form Tikhonov solve, so it can be rebuilt *inside* a ``lax.scan``
step (coil counts are small; the n_c x n_c solve is trivial on-device),
which lets :func:`run_fault_tolerant_shot` fuse the whole faulted
closed-loop shot — fault schedule, FDI, reconfiguration, plant — into
one compiled program, vmappable over fault scenarios.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Fault type codes (array-encodable; reference FaultType enum :22-30).
SENSOR_DROPOUT = 0
SENSOR_DRIFT = 1
SENSOR_NOISE = 2
ACTUATOR_LOSS = 3
ACTUATOR_STUCK = 4

# Sensor down-weights per fault class (reference handle_sensor_fault
# :151-184: dropout -> 0, noise -> 0.2, drift -> 0.5).
_SENSOR_WEIGHTS = jnp.asarray([0.0, 0.5, 0.2])


class FaultState(NamedTuple):
    """Pure-array fault condition (reference's faulted_coils /
    faulted_sensors / stuck_values / W, flattened to a pytree)."""

    coil_ok: jnp.ndarray          # (n_c,) 1.0 healthy, 0.0 lost
    sensor_weight: jnp.ndarray    # (n_s,) diagonal of W
    stuck_value: jnp.ndarray      # (n_c,) commanded-stuck offsets


def init_fault_state(n_coils: int, n_sensors: int,
                     dtype=jnp.float32) -> FaultState:
    return FaultState(jnp.ones((n_coils,), dtype),
                      jnp.ones((n_sensors,), dtype),
                      jnp.zeros((n_coils,), dtype))


def reconfig_gain(jacobian: jnp.ndarray, state: FaultState,
                  lambda_reg: float = 1e-6) -> jnp.ndarray:
    """Tikhonov weighted pseudo-inverse K = (J^T W J + lambda I)^-1 J^T W
    with faulted coil columns masked (reference ``_compute_gain:119-134``).
    Pure jnp -> differentiable and rebuildable inside a scan step."""
    j_m = jacobian * state.coil_ok[None, :]
    jtw = j_m.T * state.sensor_weight[None, :]
    n_c = jacobian.shape[1]
    h = jtw @ j_m + lambda_reg * jnp.eye(n_c, dtype=jacobian.dtype)
    k = jnp.linalg.solve(h, jtw)
    return k * state.coil_ok[:, None]


def apply_actuator_fault(state: FaultState, coil_index, kind,
                         stuck_val=0.0) -> FaultState:
    """Mark a coil lost/stuck (reference ``handle_actuator_fault:136``).
    Index/kind may be traced arrays; a no-op is encoded as index < 0."""
    idx = jnp.asarray(coil_index)
    active = idx >= 0
    one_hot = (jnp.arange(state.coil_ok.shape[0]) == idx) & active
    coil_ok = jnp.where(one_hot, 0.0, state.coil_ok)
    stuck = jnp.where(
        one_hot & (jnp.asarray(kind) == ACTUATOR_STUCK),
        stuck_val, state.stuck_value)
    return state._replace(coil_ok=coil_ok, stuck_value=stuck)


def apply_sensor_fault(state: FaultState, sensor_index,
                       kind) -> FaultState:
    """Down-weight a sensor row (reference ``handle_sensor_fault:151``)."""
    idx = jnp.asarray(sensor_index)
    active = idx >= 0
    one_hot = (jnp.arange(state.sensor_weight.shape[0]) == idx) & active
    w = _SENSOR_WEIGHTS[jnp.clip(jnp.asarray(kind), 0, 2)]
    return state._replace(
        sensor_weight=jnp.where(one_hot, w, state.sensor_weight))


def ft_step(jacobian: jnp.ndarray, state: FaultState,
            error: jnp.ndarray, lambda_reg: float = 1e-6) -> jnp.ndarray:
    """Coil-current correction with stuck-offset compensation
    (reference ``step:186-197``)."""
    adjusted = error - jacobian @ (state.stuck_value * (1.0 - state.coil_ok))
    du = reconfig_gain(jacobian, state, lambda_reg) @ adjusted
    return du * state.coil_ok


def controllability_ok(jacobian: jnp.ndarray, state: FaultState,
                       min_rank: int = 2,
                       rel_tol: float = 1e-6) -> jnp.ndarray:
    """Minimum-rank controllability with a >half-coils-lost veto
    (reference ``controllability_check:199-208``).  Rank via singular
    values — static shapes, jittable."""
    n_c = jacobian.shape[1]
    enough_coils = jnp.sum(state.coil_ok) >= (n_c - n_c // 2)
    s = jnp.linalg.svd(jacobian * state.coil_ok[None, :],
                       compute_uv=False)
    rank = jnp.sum(s > rel_tol * jnp.maximum(s[0], 1e-30))
    return enough_coils & (rank >= min_rank)


def graceful_shutdown(n_coils: int, dtype=jnp.float32) -> jnp.ndarray:
    """Zero-current safe ramp-down command (reference ``:210-212``)."""
    return jnp.zeros((n_coils,), dtype)


def inject_sensor_fault(t, signals: jnp.ndarray, fault_time,
                        index, kind, severity=1.0) -> jnp.ndarray:
    """Corrupt a measurement vector after ``fault_time`` (reference
    ``FaultInjector.inject:226-242``): dropout zeroes the channel,
    drift adds ``severity * (t - fault_time)``."""
    active = jnp.asarray(t) >= fault_time
    one_hot = (jnp.arange(signals.shape[0]) == jnp.asarray(index)) & active
    k = jnp.asarray(kind)
    dropped = jnp.where(one_hot & (k == SENSOR_DROPOUT), 0.0, signals)
    drift = severity * jnp.maximum(jnp.asarray(t) - fault_time, 0.0)
    return jnp.where(one_hot & (k == SENSOR_DRIFT), signals + drift,
                     dropped)


class FTShotTrace(NamedTuple):
    error_norm: jnp.ndarray       # (T,)
    controllable: jnp.ndarray     # (T,) bool
    coil_commands: jnp.ndarray    # (T, n_c)


def run_fault_tolerant_shot(
    jacobian: jnp.ndarray,        # (n_s, n_c) plant response
    target: jnp.ndarray,          # (n_s,) setpoint
    fault_times: jnp.ndarray,     # (n_f,) step indices (< 0 disables)
    fault_kinds: jnp.ndarray,     # (n_f,) codes above
    fault_indices: jnp.ndarray,   # (n_f,) coil or sensor index
    fault_values: jnp.ndarray | None = None,  # (n_f,) stuck commands
    *,
    n_steps: int = 200,
    gain: float = 0.5,
    lambda_reg: float = 1e-6,
) -> FTShotTrace:
    """Whole faulted closed-loop shot as ONE ``lax.scan``: a linear plant
    y = J u_phys driven to ``target`` while the fault schedule fires and
    the allocation reconfigures in-loop — lost coils go open-circuit,
    stuck coils hold their ``fault_values`` command physically.  The
    reference runs this as a host loop with Python-side fault handling;
    here fault events are data."""
    n_s, n_c = jacobian.shape
    dtype = jacobian.dtype
    fstate0 = init_fault_state(n_c, n_s, dtype)
    if fault_values is None:
        fault_values = jnp.zeros_like(fault_times, dtype=dtype)
    fault_values = jnp.asarray(fault_values, dtype)

    def u_phys(u, fstate):
        """Physical coil vector: healthy coils follow the command, a
        lost coil is open-circuit (0), a stuck coil holds its frozen
        command regardless of what the controller asks."""
        return u * fstate.coil_ok + fstate.stuck_value * (
            1.0 - fstate.coil_ok)

    def step(carry, t):
        u, fstate = carry
        # Fire any scheduled fault whose time matches this step.
        def fire(fs, f):
            f_t, f_kind, f_idx, f_val = f
            hit = (t == f_t) & (f_t >= 0)
            idx = jnp.where(hit, f_idx, -1)
            is_act = (f_kind == ACTUATOR_LOSS) | (f_kind == ACTUATOR_STUCK)
            fs = apply_actuator_fault(
                fs, jnp.where(is_act, idx, -1), f_kind, stuck_val=f_val)
            fs = apply_sensor_fault(
                fs, jnp.where(is_act, -1, idx), f_kind)
            return fs, None

        fstate, _ = jax.lax.scan(
            fire, fstate,
            (fault_times, fault_kinds, fault_indices, fault_values))
        # Measured error already carries the stuck coil's physical
        # contribution through u_phys, so plain reconfigured feedback is
        # the consistent in-loop law (ft_step's offset compensation is
        # the one-shot allocation form, reference step:186-197).
        err = target - jacobian @ u_phys(u, fstate)
        du = gain * (reconfig_gain(jacobian, fstate, lambda_reg) @ err)
        u2 = u + du * fstate.coil_ok
        err2 = target - jacobian @ u_phys(u2, fstate)
        ok = controllability_ok(jacobian, fstate)
        return (u2, fstate), (jnp.linalg.norm(err2), ok, du)

    (_, _), (errs, oks, dus) = jax.lax.scan(
        step, (jnp.zeros((n_c,), dtype), fstate0),
        jnp.arange(n_steps))
    return FTShotTrace(errs, oks, dus)
