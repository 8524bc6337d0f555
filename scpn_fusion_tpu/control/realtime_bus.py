"""Multi-process realtime control bus: physics / controller / diagnostics
nodes as REAL separate OS processes over a shared network-bus stand-in.

Counterpart of the reference's ``run_realtime_simulation.py:14-40``
(SURVEY.md §2.12 "Multi-process realtime bus"): there a physics node
(kernel solve + PWI), a proportional controller node and a logger node run
as ``multiprocessing`` processes communicating through a ``Manager`` dict
proxy that stands in for the plant network bus (Redis/Kafka).

accelerator-first redesign, not a translation:

* the plant is the SAME reduced R/Z/Ip/beta dynamics the fused on-device
  flight simulator runs (:func:`.flight_sim.run_shot_reduced`) — executed
  here as a dependency-light NumPy twin (:func:`reduced_step_np`) because
  a 100 Hz asynchronous control loop is host-bound by construction and a
  per-tick device dispatch would only add latency.  The twin is not
  a re-derivation: :func:`run_monolithic_twin` replays the exact scan
  ordering and the test suite pins it to the jitted lane at 1e-12 in f64
  (``tests/test_realtime_bus.py``), the same twin==kernel trick
  ``tests/test_multiprocess_tiles.py`` uses for the sharded stencil;
* the bus contract is typed and fail-closed: every payload carries a
  monotone sequence number and is schema-validated on READ
  (:func:`validate_telemetry`, :func:`validate_action`) — a malformed or
  non-finite message raises :class:`BusSchemaError` in the consuming node
  instead of silently steering the plant (the reference's nodes
  ``bus.get(...)`` raw dicts);
* the logger role is upgraded to a diagnostics node that computes running
  closed-loop metrics (error RMS over a window, staleness accounting) and
  publishes them back onto the bus;
* nodes handshake before the shot (``*_ready`` keys) so the physics clock
  never starts open-loop while a worker interpreter is still booting, and
  every node's exception surfaces as a ``*_error`` bus key — the session
  runner fails closed instead of hanging on ``join``.

The asynchronous split is the point of the exercise: the controller acts
on the LATEST published telemetry, not the same-tick state the fused scan
uses, so the closed-loop gates are behavioural (convergence to the target
through genuine process boundaries + staleness bounds), while exactness
is gated on the monolithic twin.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import time
from typing import Any, Mapping, NamedTuple

import numpy as np

from scpn_fusion_tpu.control.flight_sim import FlightSimParams

__all__ = [
    "BusSchemaError",
    "RealtimeSessionResult",
    "PlantStateNp",
    "reduced_step_np",
    "run_monolithic_twin",
    "run_realtime_session",
    "validate_action",
    "validate_telemetry",
]

# Bus keys (the dict proxy stands in for subject names on a plant bus).
KEY_TELEMETRY = "telemetry"
KEY_ACTION = "control_action"
KEY_DIAGNOSTICS = "diagnostics"

_TELEMETRY_FIELDS = ("seq", "t_sim", "r", "z", "ip_ma", "beta", "heating",
                     "disrupted")
_ACTION_FIELDS = ("seq", "telemetry_seq", "cmd_r", "cmd_z")


class BusSchemaError(ValueError):
    """A bus payload failed schema/finite-ness validation (fail-closed)."""


def _require(payload: Mapping[str, Any], fields: tuple[str, ...],
             kind: str) -> None:
    if not isinstance(payload, Mapping):
        raise BusSchemaError(f"{kind}: payload must be a mapping, "
                             f"got {type(payload).__name__}")
    missing = [f for f in fields if f not in payload]
    if missing:
        raise BusSchemaError(f"{kind}: missing fields {missing}")
    for f in fields:
        v = payload[f]
        if isinstance(v, bool):
            continue
        if not isinstance(v, (int, float)):
            raise BusSchemaError(
                f"{kind}.{f}: expected a number, got {type(v).__name__}")
        if not math.isfinite(v):
            raise BusSchemaError(f"{kind}.{f}: non-finite value {v!r}")


def validate_telemetry(payload: Mapping[str, Any]) -> None:
    """Fail-closed telemetry schema check (consumer side)."""
    _require(payload, _TELEMETRY_FIELDS, "telemetry")
    if payload["seq"] < 0:
        raise BusSchemaError("telemetry.seq: negative sequence number")


def validate_action(payload: Mapping[str, Any]) -> None:
    """Fail-closed control-action schema check (consumer side)."""
    _require(payload, _ACTION_FIELDS, "control_action")


# ── NumPy twin of the reduced flight-sim dynamics ────────────────────────
#
# Identical f64 elementwise arithmetic to the ``step`` closure inside
# ``flight_sim.run_shot_reduced_gains`` (incl. clip bounds and the
# delay-line cursor discipline); ``run_monolithic_twin`` replays the same
# one-tick ordering so the two traces are pinned bit-tight in the tests.


class PlantStateNp(NamedTuple):
    r: float
    z: float
    beta: float
    heating: float
    pf_r: float                  # last enforced PF command (R channel)
    pf_z: float
    delay_buf: np.ndarray        # (delay+1, 2) actuator delay line
    cursor: int


class PIDStateNp(NamedTuple):
    err_sum: float
    last_err: float


def plant_init_np(params: FlightSimParams) -> PlantStateNp:
    return PlantStateNp(
        r=params.target_r + 0.1, z=params.target_z + 0.05,
        beta=0.6, heating=20.0, pf_r=0.0, pf_z=0.0,
        delay_buf=np.zeros((params.delay_steps + 1, 2), dtype=np.float64),
        cursor=0)


def _envelope_np(requested: float, prev: float, rate_limit: float,
                 abs_max: float, dt: float) -> float:
    out = min(max(requested, prev - rate_limit * dt), prev + rate_limit * dt)
    return min(max(out, -abs_max), abs_max)


def _scaled_gains(params: FlightSimParams):
    """(kp, ki, kd) per channel, scaled from the 100 Hz baseline exactly
    like the jitted lane (flight_sim.rs:199-206 semantics)."""
    dt, dt_ref = params.control_dt, 0.01
    g_r = (params.pid_r_kp, params.pid_r_ki * dt / dt_ref,
           params.pid_r_kd * dt_ref / dt)
    g_z = (params.pid_z_kp, params.pid_z_ki * dt / dt_ref,
           params.pid_z_kd * dt_ref / dt)
    return g_r, g_z


def pid_step_np(gains: tuple[float, float, float], state: PIDStateNp,
                error: float) -> tuple[PIDStateNp, float]:
    """NumPy twin of :func:`.pid.pid_step` (incl. the NaN fail-safe)."""
    kp, ki, kd = gains
    if not math.isfinite(error):
        return state, 0.0
    err_sum = state.err_sum + error
    cmd = kp * error + ki * err_sum + kd * (error - state.last_err)
    return PIDStateNp(err_sum, error), cmd


def plant_drift_np(state: PlantStateNp, k: int,
                   params: FlightSimParams) -> PlantStateNp:
    """Plant evolution half of the tick (scan step part 1): scenario ramp,
    heating envelope, beta relaxation, uncontrolled R/Z drift."""
    dt = params.control_dt
    phase = min(max(k * dt / params.shot_duration_s, 0.0), 1.0)
    heating_req = 20.0 + 60.0 * phase
    heating = _envelope_np(heating_req, state.heating,
                           params.heating_rate_limit,
                           params.heating_abs_max, dt)
    heating = min(max(heating, 0.0), params.heating_abs_max)
    beta_target = 0.6 + 0.03 * heating
    beta = min(max(state.beta + 0.5 * (beta_target - state.beta) * dt,
                   0.2), 10.0)
    r = min(max(state.r + 0.01 * beta * dt, 2.0), 10.0)
    z = min(max(state.z + 0.02 * dt, -6.0), 6.0)
    return state._replace(r=r, z=z, beta=beta, heating=heating)


def plant_apply_np(state: PlantStateNp, cmd_r: float, cmd_z: float,
                   params: FlightSimParams) -> PlantStateNp:
    """Control application half of the tick (scan step parts 2b-4):
    safety envelope, actuator delay line, position update."""
    dt = params.control_dt
    ctrl_r = _envelope_np(cmd_r, state.pf_r, params.pf_rate_limit,
                          params.pf_abs_max, dt)
    ctrl_z = _envelope_np(cmd_z, state.pf_z, params.pf_rate_limit,
                          params.pf_abs_max, dt)
    buf = state.delay_buf.copy()
    buf[state.cursor] = (ctrl_r, ctrl_z)
    nbuf = buf.shape[0]
    applied = buf[(state.cursor + 1) % nbuf]
    cursor = (state.cursor + 1) % nbuf
    r = min(max(state.r + float(applied[0]) * dt, 2.0), 10.0)
    z = min(max(state.z + float(applied[1]) * dt, -6.0), 6.0)
    return state._replace(r=r, z=z, pf_r=ctrl_r, pf_z=ctrl_z,
                          delay_buf=buf, cursor=cursor)


def reduced_step_np(state: PlantStateNp, pid_r: PIDStateNp,
                    pid_z: PIDStateNp, k: int, params: FlightSimParams):
    """One full reduced-lane tick in the EXACT scan ordering: drift, PID
    on the drifted state, envelope+delay+apply.  Returns
    (state, pid_r, pid_z, telemetry_row)."""
    g_r, g_z = _scaled_gains(params)
    dt = params.control_dt
    phase = min(max(k * dt / params.shot_duration_s, 0.0), 1.0)
    state = plant_drift_np(state, k, params)
    pid_r, cmd_r = pid_step_np(g_r, pid_r, params.target_r - state.r)
    pid_z, cmd_z = pid_step_np(g_z, pid_z, params.target_z - state.z)
    state = plant_apply_np(state, cmd_r, cmd_z, params)
    r_err = abs(state.r - params.target_r)
    z_err = abs(state.z - params.target_z)
    row = {
        "r": state.r, "z": state.z, "ip_ma": 5.0 + 10.0 * phase,
        "beta": state.beta, "heating": state.heating,
        "r_err": r_err, "z_err": z_err,
        "disrupted": (r_err > params.disruption_limit_m
                      or z_err > params.disruption_limit_m),
    }
    return state, pid_r, pid_z, row


def run_monolithic_twin(params: FlightSimParams) -> dict[str, np.ndarray]:
    """Whole reduced shot through the NumPy twin, same ordering as the
    jitted ``lax.scan`` — the parity oracle for the distributed lane."""
    state = plant_init_np(params)
    pid_r = pid_z = PIDStateNp(0.0, 0.0)
    rows: list[dict[str, float]] = []
    for k in range(params.n_steps):
        state, pid_r, pid_z, row = reduced_step_np(
            state, pid_r, pid_z, k, params)
        rows.append(row)
    return {key: np.asarray([row[key] for row in rows])
            for key in rows[0]}


# ── node processes ───────────────────────────────────────────────────────


def _wait_for(bus, key: str, timeout_s: float, stop_event) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not stop_event.is_set():
        if bus.get(key):
            return True
        time.sleep(0.005)
    return bool(bus.get(key))


def physics_node(bus, stop_event, params: FlightSimParams, n_ticks: int,
                 tick_interval_s: float) -> None:
    """Plant process: paced tick loop — drift, apply the LATEST bus
    action through envelope+delay, publish sequence-tagged telemetry."""
    try:
        bus["physics_ready"] = True
        if not (_wait_for(bus, "control_ready", 30.0, stop_event)
                and _wait_for(bus, "diagnostics_ready", 30.0, stop_event)):
            raise RuntimeError("peer nodes did not come up within 30 s")
        state = plant_init_np(params)
        dt = params.control_dt
        stale_reads = 0
        last_action_seq = -1
        for k in range(n_ticks):
            if stop_event.is_set():
                break
            t0 = time.monotonic()
            state = plant_drift_np(state, k, params)
            action = bus.get(KEY_ACTION)
            cmd_r = cmd_z = 0.0
            if action is not None:
                validate_action(action)
                if action["seq"] == last_action_seq:
                    stale_reads += 1
                last_action_seq = action["seq"]
                cmd_r, cmd_z = action["cmd_r"], action["cmd_z"]
            state = plant_apply_np(state, cmd_r, cmd_z, params)
            r_err = abs(state.r - params.target_r)
            z_err = abs(state.z - params.target_z)
            phase = min(max(k * dt / params.shot_duration_s, 0.0), 1.0)
            bus[KEY_TELEMETRY] = {
                "seq": k, "t_sim": k * dt,
                "r": state.r, "z": state.z, "ip_ma": 5.0 + 10.0 * phase,
                "beta": state.beta, "heating": state.heating,
                "disrupted": bool(r_err > params.disruption_limit_m
                                  or z_err > params.disruption_limit_m),
            }
            sleep_s = tick_interval_s - (time.monotonic() - t0)
            if sleep_s > 0:
                time.sleep(sleep_s)
        bus["physics_summary"] = {
            "ticks": k + 1 if n_ticks else 0,
            "stale_action_reads": stale_reads,
            "final_r_err": abs(state.r - params.target_r),
            "final_z_err": abs(state.z - params.target_z),
        }
    except Exception as exc:  # noqa: BLE001 — surfaced to the runner
        bus["physics_error"] = f"{type(exc).__name__}: {exc}"
    finally:
        stop_event.set()


def control_node(bus, stop_event, params: FlightSimParams) -> None:
    """Controller process: PID on the latest telemetry, publish
    sequence-tagged raw commands (envelope enforcement stays plant-side,
    exactly like the fused lane)."""
    try:
        bus["control_ready"] = True
        g_r, g_z = _scaled_gains(params)
        pid_r = pid_z = PIDStateNp(0.0, 0.0)
        n_actions = 0
        last_seen = -1
        while not stop_event.is_set():
            telem = bus.get(KEY_TELEMETRY)
            if telem is None or telem["seq"] == last_seen:
                time.sleep(0.0005)
                continue
            validate_telemetry(telem)
            last_seen = telem["seq"]
            pid_r, cmd_r = pid_step_np(g_r, pid_r,
                                       params.target_r - telem["r"])
            pid_z, cmd_z = pid_step_np(g_z, pid_z,
                                       params.target_z - telem["z"])
            bus[KEY_ACTION] = {
                "seq": n_actions, "telemetry_seq": last_seen,
                "cmd_r": cmd_r, "cmd_z": cmd_z,
            }
            n_actions += 1
        bus["control_summary"] = {"actions": n_actions,
                                  "last_telemetry_seq": last_seen}
    except Exception as exc:  # noqa: BLE001
        bus["control_error"] = f"{type(exc).__name__}: {exc}"
        stop_event.set()


def diagnostics_node(bus, stop_event, params: FlightSimParams,
                     window: int = 64) -> None:
    """Diagnostics process: consumes telemetry, maintains a rolling
    window, publishes running closed-loop metrics onto the bus."""
    try:
        bus["diagnostics_ready"] = True
        seen: list[dict[str, Any]] = []
        last_seen = -1
        disrupted_any = False
        while True:
            # Read once more after the stop: the physics node publishes
            # its last tick and then stops the session.
            stopping = stop_event.is_set()
            telem = bus.get(KEY_TELEMETRY)
            if telem is None or telem["seq"] == last_seen:
                if stopping:
                    break
                time.sleep(0.0005)
                continue
            validate_telemetry(telem)
            last_seen = telem["seq"]
            disrupted_any = disrupted_any or bool(telem["disrupted"])
            seen.append(telem)
            if len(seen) > window:
                seen = seen[-window:]
            r_errs = [abs(t["r"] - params.target_r) for t in seen]
            bus[KEY_DIAGNOSTICS] = {
                "n_seen": last_seen + 1,
                "n_distinct": len({t["seq"] for t in seen}),
                "r_err_rms_window": math.sqrt(
                    sum(e * e for e in r_errs) / len(r_errs)),
                "disrupted_any": disrupted_any,
            }
        bus["diagnostics_summary"] = dict(bus.get(KEY_DIAGNOSTICS) or {})
    except Exception as exc:  # noqa: BLE001
        bus["diagnostics_error"] = f"{type(exc).__name__}: {exc}"
        stop_event.set()


# ── session runner ───────────────────────────────────────────────────────


class RealtimeSessionResult(NamedTuple):
    n_ticks: int
    final_r_err: float
    final_z_err: float
    open_loop_r_err: float       # same shot with the controller muted
    controller_actions: int
    stale_action_reads: int
    diagnostics: dict[str, Any]
    wall_s: float


def _open_loop_final_r_err(params: FlightSimParams, n_ticks: int) -> float:
    """Uncontrolled drift baseline: what |r - target| the plant reaches
    with zero commands — the floor the closed loop must beat."""
    state = plant_init_np(params)
    for k in range(n_ticks):
        state = plant_drift_np(state, k, params)
        state = plant_apply_np(state, 0.0, 0.0, params)
    return abs(state.r - params.target_r)


def run_realtime_session(
    n_ticks: int = 400,
    tick_interval_s: float = 0.002,
    params: FlightSimParams | None = None,
    join_timeout_s: float = 120.0,
) -> RealtimeSessionResult:
    """Spawn the three nodes, run one paced shot, fail-closed aggregate.

    Workers spawn with ``JAX_PLATFORMS=cpu`` in the inherited environment:
    the nodes run host-side NumPy, and without the pin every worker would
    initialise the accelerator and compete for its memory with the parent
    (``tests/test_multiprocess_tiles.py`` pins its workers the same way).
    """
    if params is None:
        # 100 Hz control-room pacing; shot duration covers the tick budget.
        params = FlightSimParams(control_hz=100.0,
                                 shot_duration_s=n_ticks / 100.0)
    t0 = time.monotonic()
    prev_env = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        # Everything spawns (manager server included): the parent is
        # multi-threaded once jax initialises, and forking a threaded
        # process can deadlock the child.
        ctx = multiprocessing.get_context("spawn")
        with ctx.Manager() as manager:
            bus = manager.dict()
            stop_event = manager.Event()
            procs = [
                ctx.Process(target=physics_node,
                            args=(bus, stop_event, params, n_ticks,
                                  tick_interval_s)),
                ctx.Process(target=control_node,
                            args=(bus, stop_event, params)),
                ctx.Process(target=diagnostics_node,
                            args=(bus, stop_event, params)),
            ]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=join_timeout_s)
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.terminate()
                p.join(timeout=10.0)
            errors = {k: bus[k] for k in
                      ("physics_error", "control_error", "diagnostics_error")
                      if k in bus}
            if errors:
                raise RuntimeError(f"node errors: {errors}")
            if alive:
                raise RuntimeError(
                    f"{len(alive)} node(s) had to be terminated after "
                    f"{join_timeout_s:.0f}s — session did not complete")
            phys = bus.get("physics_summary")
            ctrl = bus.get("control_summary")
            diag = bus.get("diagnostics_summary")
            if not (phys and ctrl and diag is not None):
                raise RuntimeError("missing node summaries on the bus")
            return RealtimeSessionResult(
                n_ticks=int(phys["ticks"]),
                final_r_err=float(phys["final_r_err"]),
                final_z_err=float(phys["final_z_err"]),
                open_loop_r_err=_open_loop_final_r_err(params, n_ticks),
                controller_actions=int(ctrl["actions"]),
                stale_action_reads=int(phys["stale_action_reads"]),
                diagnostics=dict(diag),
                wall_s=time.monotonic() - t0,
            )
    finally:
        if prev_env is None:
            os.environ.pop("JAX_PLATFORMS", None)
        else:
            os.environ["JAX_PLATFORMS"] = prev_env
