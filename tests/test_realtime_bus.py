"""Multi-process realtime bus: twin parity + closed loop across real
process boundaries.

Counterpart of the reference's ``run_realtime_simulation.py`` demo
(SURVEY.md §2.12 row "Multi-process realtime bus"), held to actual gates:

* the NumPy twin the nodes run is pinned to the jitted fused-scan lane
  at 1e-12 in f64 — the distributed plant is provably the same dynamics;
* a three-process session (physics / controller / diagnostics over a
  ``Manager`` dict proxy) converges the R channel through genuine
  process boundaries, beating the open-loop drift floor;
* the bus schema is fail-closed: malformed and non-finite payloads
  raise, they are never silently consumed.
"""

import math

import numpy as np
import pytest

from scpn_fusion_tpu.control.flight_sim import FlightSimParams
from scpn_fusion_tpu.control.realtime_bus import (
    BusSchemaError,
    run_monolithic_twin,
    run_realtime_session,
    validate_action,
    validate_telemetry,
)


def test_twin_matches_jitted_scan_lane_f64():
    """The NumPy twin replays the fused ``lax.scan`` lane bit-tight."""
    import jax.numpy as jnp

    from scpn_fusion_tpu.control.flight_sim import run_shot_reduced

    params = FlightSimParams(control_hz=100.0, shot_duration_s=2.0)
    trace, metrics = run_shot_reduced(params, dtype=jnp.float64)
    twin = run_monolithic_twin(params)

    for key, jax_arr in (("r", trace.r), ("z", trace.z),
                         ("beta", trace.beta), ("heating", trace.heating_mw),
                         ("ip_ma", trace.ip_ma), ("r_err", trace.r_err),
                         ("z_err", trace.z_err)):
        np.testing.assert_allclose(
            twin[key], np.asarray(jax_arr), rtol=0.0, atol=1e-12,
            err_msg=f"twin diverges from the jitted lane on {key!r}")
    assert np.array_equal(twin["disrupted"],
                          np.asarray(trace.disrupted))
    # Sanity: this configuration actually converges.
    assert float(metrics["r_err_final"]) < 0.05


def test_schema_validation_fail_closed():
    good_telem = {"seq": 3, "t_sim": 0.03, "r": 6.25, "z": 0.01,
                  "ip_ma": 5.5, "beta": 0.7, "heating": 25.0,
                  "disrupted": False}
    validate_telemetry(good_telem)          # passes

    with pytest.raises(BusSchemaError):
        validate_telemetry({k: v for k, v in good_telem.items()
                            if k != "r"})   # missing field
    with pytest.raises(BusSchemaError):
        validate_telemetry({**good_telem, "beta": float("nan")})
    with pytest.raises(BusSchemaError):
        validate_telemetry({**good_telem, "r": "6.2"})
    with pytest.raises(BusSchemaError):
        validate_telemetry({**good_telem, "seq": -1})
    with pytest.raises(BusSchemaError):
        validate_telemetry([("r", 6.2)])    # not a mapping

    validate_action({"seq": 0, "telemetry_seq": 0,
                     "cmd_r": 0.1, "cmd_z": -0.2})
    with pytest.raises(BusSchemaError):
        validate_action({"seq": 0, "telemetry_seq": 0,
                         "cmd_r": math.inf, "cmd_z": 0.0})


def test_three_process_closed_loop_session():
    """Physics, controller and diagnostics in REAL separate OS processes
    over the dict-proxy bus: the loop closes and converges."""
    n_ticks = 400
    res = run_realtime_session(n_ticks=n_ticks, tick_interval_s=0.002)

    assert res.n_ticks == n_ticks
    # Closed loop beats the uncontrolled drift floor and lands inside
    # the disruption envelope.
    assert res.final_r_err < 0.5 * res.open_loop_r_err
    assert res.final_r_err < 0.05
    assert res.final_z_err < 0.05
    # The controller genuinely participated (more than a handful of
    # actions, through the bus, while physics ticked).
    assert res.controller_actions >= n_ticks // 4
    # Diagnostics node saw the stream and reported its running metrics.
    assert res.diagnostics["n_seen"] == n_ticks
    assert res.diagnostics["disrupted_any"] is False
    assert res.diagnostics["r_err_rms_window"] < 0.05


def test_diagnostics_counts_the_tick_published_before_stop():
    """The physics node publishes its last tick and then stops the
    session; the diagnostics node still reads and counts that tick."""
    import threading

    from scpn_fusion_tpu.control.realtime_bus import (
        KEY_TELEMETRY,
        diagnostics_node,
    )

    bus = {KEY_TELEMETRY: {"seq": 399, "t_sim": 3.99, "r": 6.2, "z": 0.0,
                           "ip_ma": 15.0, "beta": 0.7, "heating": 25.0,
                           "disrupted": False}}
    stop = threading.Event()
    stop.set()
    diagnostics_node(bus, stop, FlightSimParams())
    assert "diagnostics_error" not in bus
    assert bus["diagnostics_summary"]["n_seen"] == 400
