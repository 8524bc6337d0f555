"""Tokamak flight simulator: closed-loop shots, fully on-device.

Two lanes, mirroring the reference's architecture (SURVEY.md §3.4):

* ``run_shot_reduced`` — the >10 kHz lane: reduced-order R/Z/Ip/beta plant
  with PID control, safety-envelope slew enforcement, actuator delay line,
  and disruption metrics, semantics from the reference's Rust engine
  (``fusion-control/src/flight_sim.rs:111-430``).  The whole shot is ONE
  ``lax.scan`` — thousands of control ticks execute in microseconds total,
  replacing the Rust sub-µs/step kernel with a fused on-device loop.

* ``run_shot_full`` — physics-in-the-loop lane: the compiled Grad-Shafranov
  solver is the plant (reference ``control/tokamak_flight_sim.py:252-340``):
  per control tick — Ip ramp, heating actuator driving beta, sub-grid
  parabolic magnetic-axis estimate, R/Z PID, coil-current deltas through
  first-order actuators, vacuum flux refresh via the coil response table,
  inner equilibrium solve.  Also one compiled program.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.control.actuator import (
    ActuatorParams,
    ActuatorState,
    actuator_init,
    actuator_step,
)
from scpn_fusion_tpu.control.pid import PIDGains, PIDState, pid_init, pid_step

DEFAULT_TARGET_R = 6.2
DEFAULT_TARGET_Z = 0.0


def _envelope(requested, prev, rate_limit, abs_max, dt):
    """Safety-envelope enforcement: slew then absolute clamp
    (reference ``SafetyEnvelope::enforce``)."""
    out = jnp.clip(requested, prev - rate_limit * dt, prev + rate_limit * dt)
    return jnp.clip(out, -abs_max, abs_max)


@dataclasses.dataclass(frozen=True)
class FlightSimParams:
    """Static reduced-lane configuration (reference flight_sim.rs defaults)."""

    target_r: float = DEFAULT_TARGET_R
    target_z: float = DEFAULT_TARGET_Z
    control_hz: float = 10_000.0
    shot_duration_s: float = 1.0
    # PID gains at the 100 Hz reference period (scaled by dt at runtime).
    pid_r_kp: float = 2.0
    pid_r_ki: float = 0.1
    pid_r_kd: float = 0.5
    pid_z_kp: float = 5.0
    pid_z_ki: float = 0.2
    pid_z_kd: float = 2.0
    pf_rate_limit: float = 1.0e3     # command units / s
    pf_abs_max: float = 50.0
    heating_rate_limit: float = 200.0  # MW/s
    heating_abs_max: float = 100.0
    delay_steps: int = 2
    disruption_limit_m: float = 0.5

    @property
    def control_dt(self) -> float:
        return 1.0 / self.control_hz

    @property
    def n_steps(self) -> int:
        return int(self.shot_duration_s / self.control_dt)


class ReducedShotTrace(NamedTuple):
    r: jnp.ndarray
    z: jnp.ndarray
    ip_ma: jnp.ndarray
    beta: jnp.ndarray
    heating_mw: jnp.ndarray
    r_err: jnp.ndarray
    z_err: jnp.ndarray
    disrupted: jnp.ndarray


class _ReducedCarry(NamedTuple):
    r: jnp.ndarray
    z: jnp.ndarray
    beta: jnp.ndarray
    heating: jnp.ndarray
    pid_r: PIDState
    pid_z: PIDState
    pf_r: jnp.ndarray        # enforced PF command states (2,)
    pf_z: jnp.ndarray
    delay_buf: jnp.ndarray   # (delay+1, 2) actuator delay line
    cursor: jnp.ndarray


@partial(jax.jit, static_argnames=("params", "dtype"))
def run_shot_reduced(params: FlightSimParams, *, dtype=jnp.float32):
    """Run the reduced-order closed-loop shot; returns the full telemetry
    trace plus aggregate metrics (disruption fraction, final errors)."""
    gains = jnp.asarray(
        [params.pid_r_kp, params.pid_r_ki, params.pid_r_kd,
         params.pid_z_kp, params.pid_z_ki, params.pid_z_kd], dtype)
    return run_shot_reduced_gains(params, gains, dtype=dtype)


@partial(jax.jit, static_argnames=("params", "dtype"))
def run_shot_reduced_gains(params: FlightSimParams, gains: jnp.ndarray, *,
                           dtype=jnp.float32):
    """Reduced-lane shot with the six PID gains as a TRACED ``(6,)`` array
    ``[r_kp, r_ki, r_kd, z_kp, z_ki, z_kd]`` (100 Hz-baseline values, scaled
    by dt internally).  Traced gains make the whole closed loop vmappable
    over gain candidates — the substrate for the controller auto-tuner
    (reference ``control/controller_tuning.py`` runs Optuna trials one
    Gymnasium episode at a time; here a generation of candidates is ONE
    batched device program)."""
    dt = params.control_dt
    n = params.n_steps
    gains = gains.astype(dtype)
    # Gain scaling from the 100 Hz baseline (flight_sim.rs:199-206).
    dt_ref = 0.01
    g_r = PIDGains(gains[0], gains[1] * dt / dt_ref, gains[2] * dt_ref / dt)
    g_z = PIDGains(gains[3], gains[4] * dt / dt_ref, gains[5] * dt_ref / dt)

    def step(c: _ReducedCarry, k):
        phase = jnp.clip(k.astype(dtype) * dt / params.shot_duration_s, 0.0, 1.0)

        # 1. Plant evolution (reference step_once :305-330)
        ip_ma = 5.0 + 10.0 * phase
        heating_req = 20.0 + 60.0 * phase
        heating = _envelope(heating_req, c.heating,
                            params.heating_rate_limit, params.heating_abs_max, dt)
        heating = jnp.clip(heating, 0.0, params.heating_abs_max)
        beta_target = 0.6 + 0.03 * heating
        beta = jnp.clip(c.beta + 0.5 * (beta_target - c.beta) * dt, 0.2, 10.0)

        r = jnp.clip(c.r + 0.01 * beta * dt, 2.0, 10.0)
        z = jnp.clip(c.z + 0.02 * dt, -6.0, 6.0)

        # 2. Control
        pid_r, cmd_r = pid_step(g_r, c.pid_r, params.target_r - r)
        pid_z, cmd_z = pid_step(g_z, c.pid_z, params.target_z - z)

        # 2b. Safety enforcement
        ctrl_r = _envelope(cmd_r, c.pf_r, params.pf_rate_limit, params.pf_abs_max, dt)
        ctrl_z = _envelope(cmd_z, c.pf_z, params.pf_rate_limit, params.pf_abs_max, dt)

        # 3. Actuator delay line
        buf = c.delay_buf.at[c.cursor].set(jnp.stack([ctrl_r, ctrl_z]))
        nbuf = buf.shape[0]
        applied = buf[(c.cursor + 1) % nbuf]
        cursor = (c.cursor + 1) % nbuf

        # 4. Apply control
        r_next = jnp.clip(r + applied[0] * dt, 2.0, 10.0)
        z_next = jnp.clip(z + applied[1] * dt, -6.0, 6.0)

        r_err = jnp.abs(r_next - params.target_r)
        z_err = jnp.abs(z_next - params.target_z)
        disrupted = (r_err > params.disruption_limit_m) | \
                    (z_err > params.disruption_limit_m)

        out = ReducedShotTrace(r_next, z_next, ip_ma, beta, heating,
                               r_err, z_err, disrupted)
        return _ReducedCarry(r_next, z_next, beta, heating, pid_r, pid_z,
                             ctrl_r, ctrl_z, buf, cursor), out

    init = _ReducedCarry(
        r=jnp.asarray(params.target_r + 0.1, dtype),
        z=jnp.asarray(params.target_z + 0.05, dtype),
        beta=jnp.asarray(0.6, dtype),
        heating=jnp.asarray(20.0, dtype),
        pid_r=pid_init(dtype), pid_z=pid_init(dtype),
        pf_r=jnp.asarray(0.0, dtype), pf_z=jnp.asarray(0.0, dtype),
        delay_buf=jnp.zeros((params.delay_steps + 1, 2), dtype),
        cursor=jnp.int32(0),
    )
    _, trace = jax.lax.scan(step, init, jnp.arange(n))
    metrics = {
        "disruption_fraction": jnp.mean(trace.disrupted.astype(dtype)),
        "r_err_final": trace.r_err[-1],
        "z_err_final": trace.z_err[-1],
        "r_err_p95": jnp.percentile(trace.r_err, 95.0),
        "z_err_p95": jnp.percentile(trace.z_err, 95.0),
    }
    return trace, metrics


# ── full-physics lane ────────────────────────────────────────────────────


def subgrid_axis(psi: jnp.ndarray, r_1d: jnp.ndarray, z_1d: jnp.ndarray,
                 d_r: float, d_z: float):
    """Magnetic-axis position with parabolic sub-grid interpolation
    (reference ``run_shot`` :295-318)."""
    nr = psi.shape[1]
    idx = jnp.argmax(psi)
    iz, ir = idx // nr, idx % nr
    curr_r = r_1d[ir]
    curr_z = z_1d[iz]

    irc = jnp.clip(ir, 1, nr - 2)
    a = psi[iz, irc - 1]
    b = psi[iz, irc]
    c = psi[iz, irc + 1]
    denom = 2.0 * (a - 2.0 * b + c)
    dr_frac = jnp.where(jnp.abs(denom) > 1e-30,
                        jnp.clip(-(c - a) / denom, -0.5, 0.5), 0.0)
    curr_r = curr_r + jnp.where((ir >= 1) & (ir <= nr - 2), dr_frac * d_r, 0.0)

    nz = psi.shape[0]
    izc = jnp.clip(iz, 1, nz - 2)
    a2 = psi[izc - 1, ir]
    b2 = psi[izc, ir]
    c2 = psi[izc + 1, ir]
    denom2 = 2.0 * (a2 - 2.0 * b2 + c2)
    dz_frac = jnp.where(jnp.abs(denom2) > 1e-30,
                        jnp.clip(-(c2 - a2) / denom2, -0.5, 0.5), 0.0)
    curr_z = curr_z + jnp.where((iz >= 1) & (iz <= nz - 2), dz_frac * d_z, 0.0)
    return curr_r, curr_z


class FullShotTrace(NamedTuple):
    t_s: jnp.ndarray
    r_axis: jnp.ndarray
    z_axis: jnp.ndarray
    ctrl_r_cmd: jnp.ndarray
    ctrl_r_applied: jnp.ndarray
    ctrl_z_cmd: jnp.ndarray
    ctrl_z_applied: jnp.ndarray
    converged: jnp.ndarray


def run_shot_full(
    cfg,
    *,
    shot_steps: int = 30,
    control_dt_s: float = 0.05,
    actuator_tau_s: float = 0.06,
    actuator_delta_limit: float = 5.0e4,
    radial_coil_ids: tuple = (1, 2, 3),
    top_coil_id: int = 0,
    bottom_coil_id: int = 5,
    target_r: float | None = None,
    target_z: float | None = None,
    dtype=jnp.float32,
):
    """Closed-loop shot with the compiled GS solver as the plant.

    Coil-current deltas act through the precomputed per-coil response table,
    so each tick's vacuum-flux refresh is one einsum.  The whole shot
    (controller + actuators + plant solves) is a single ``lax.scan`` program.
    """
    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.equilibrium.fixed_boundary import (
        solve_fixed_boundary_impl,
    )
    from scpn_fusion_tpu.models.equilibrium.free_boundary import (
        coilset_from_config,
        external_flux_table,
    )
    from scpn_fusion_tpu.models.equilibrium.profiles import (
        profile_coeffs_from_physics,
    )

    grid = Grid.from_config(cfg, dtype=dtype)
    coils = coilset_from_config(cfg, dtype)
    mu0 = float(cfg.physics.vacuum_permeability)
    g_table = external_flux_table(grid, coils, mu0)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, dtype)
    sol = cfg.solver
    tr = float(cfg.physics.plasma_current_target)

    t_r = DEFAULT_TARGET_R if target_r is None else float(target_r)
    t_z = DEFAULT_TARGET_Z if target_z is None else float(target_z)

    act_params = ActuatorParams(
        tau_s=actuator_tau_s, dt_s=control_dt_s,
        u_min=-actuator_delta_limit, u_max=actuator_delta_limit)

    g_r = PIDGains(*[jnp.asarray(v, dtype) for v in (2.0, 0.1, 0.5)])
    g_z = PIDGains(*[jnp.asarray(v, dtype) for v in (5.0, 0.2, 2.0)])

    def gs_solve(psi0, psi_bc, i_target):
        return solve_fixed_boundary_impl(
            grid, psi0, psi_bc, i_target, p_c, ff_c,
            jnp.asarray(sol.convergence_threshold, dtype),
            jnp.asarray(jnp.inf, dtype),
            jnp.asarray(sol.relaxation_factor, dtype),
            jnp.asarray(sol.sor_omega, dtype),
            solver_method=sol.solver_method, max_iter=sol.max_iterations,
            h_mode=cfg.physics.profile_mode == "h-mode",
            inner_sweeps=sol.inner_sweeps, anderson_m=sol.anderson_depth,
            mu0=mu0, use_gs_criterion=False)

    class Carry(NamedTuple):
        psi: jnp.ndarray
        currents: jnp.ndarray
        pid_r: PIDState
        pid_z: PIDState
        act_r: ActuatorState
        act_t: ActuatorState
        act_b: ActuatorState

    n_radial = len(radial_coil_ids)

    @jax.jit
    def run(currents0):
        psi_bc0 = jnp.einsum("c,czr->zr", currents0, g_table)
        eq0 = gs_solve(psi_bc0, psi_bc0, jnp.asarray(tr, dtype))

        def step(c: Carry, k):
            t_sim = k.astype(dtype) * control_dt_s
            i_target = tr * (0.98 + 0.02 * k.astype(dtype) / shot_steps)

            r_axis, z_axis = subgrid_axis(c.psi, grid.R, grid.Z,
                                          grid.dR, grid.dZ)
            pid_r, cmd_r = pid_step(g_r, c.pid_r, t_r - r_axis)
            pid_z, cmd_z = pid_step(g_z, c.pid_z, t_z - z_axis)

            act_r, applied_r = actuator_step(act_params, c.act_r, cmd_r)
            act_t, applied_t = actuator_step(act_params, c.act_t, cmd_z)
            act_b, applied_b = actuator_step(act_params, c.act_b, -cmd_z)

            currents = c.currents
            for cid in radial_coil_ids:
                currents = currents.at[cid].add(applied_r / n_radial)
            currents = currents.at[top_coil_id].add(applied_t)
            currents = currents.at[bottom_coil_id].add(applied_b)

            psi_bc = jnp.einsum("c,czr->zr", currents, g_table)
            eq = gs_solve(c.psi, psi_bc, i_target)

            out = FullShotTrace(t_sim, r_axis, z_axis, cmd_r, applied_r,
                                cmd_z, applied_t, eq.converged)
            return Carry(eq.psi, currents, pid_r, pid_z,
                         act_r, act_t, act_b), out

        init = Carry(eq0.psi, currents0, pid_init(dtype), pid_init(dtype),
                     actuator_init(act_params, dtype),
                     actuator_init(act_params, dtype),
                     actuator_init(act_params, dtype))
        final, trace = jax.lax.scan(step, init, jnp.arange(shot_steps))
        return final.psi, final.currents, trace

    return run(coils.currents)
