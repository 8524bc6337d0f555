"""Hypothesis property sweeps for the newest control surfaces.

Round-5 depth pass (VERDICT r4 weak #8 / next #9): the realtime bus,
the FPGA fixed-point export and the batched ensemble carried one
example-based test file each; the reference's analogous surfaces carry
hypothesis properties (SURVEY.md section 4 "property-based via
hypothesis").  Properties here are invariants for ALL inputs, not
fixtures:

* bus payload validation is fail-closed under arbitrary mutation
  (missing field / wrong type / non-finite / negative seq all raise);
* the safety envelope and PID fail-safe hold for arbitrary commands;
* the actuator delay line applies exactly the command enforced
  ``delay_steps`` ticks earlier, and the plant never leaves its clip
  box, for arbitrary command sequences;
* the physics node's staleness ledger and sequence numbering are exact,
  and a malformed action surfaces as a bus error key (never a silent
  ride-through) — driven in-process through stub bus/event doubles;
* FPGA quantisation round-trip error is bounded by half an LSB for any
  in-range value and any Q format, saturation clips exactly, and the
  two's-complement hex images decode back to the quantised integers;
* a batched ensemble element equals the standalone solve for arbitrary
  batch composition and seed (the sweep behind the campaign's fixed
  B=16 datapoint, ``validation/run_batched_amortisation.py`` lane 1).
"""

import math

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from scpn_fusion_tpu.control import realtime_bus as rb
from scpn_fusion_tpu.control.flight_sim import FlightSimParams
from scpn_fusion_tpu.control.realtime_bus import BusSchemaError, PIDStateNp

SETTINGS = settings(max_examples=25, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])

finite = st.floats(min_value=-1e6, max_value=1e6,
                   allow_nan=False, allow_infinity=False)


def good_telemetry(seq: int = 0) -> dict:
    return {"seq": seq, "t_sim": 0.01 * seq, "r": 6.2, "z": 0.0,
            "ip_ma": 5.0, "beta": 0.6, "heating": 20.0,
            "disrupted": False}


def good_action(seq: int = 0) -> dict:
    return {"seq": seq, "telemetry_seq": seq, "cmd_r": 0.1, "cmd_z": -0.1}


# ── bus schema validation: fail-closed under arbitrary mutation ─────────


class TestBusSchemaProperties:
    @SETTINGS
    @given(values=st.lists(finite, min_size=8, max_size=8),
           seq=st.integers(0, 10**9))
    def test_any_finite_payload_passes(self, values, seq):
        fields = ("t_sim", "r", "z", "ip_ma", "beta", "heating")
        telem = {f: v for f, v in zip(fields, values)}
        telem.update(seq=seq, disrupted=bool(values[6] > 0))
        rb.validate_telemetry(telem)
        rb.validate_action({"seq": seq, "telemetry_seq": seq,
                            "cmd_r": values[0], "cmd_z": values[1]})

    @SETTINGS
    @given(drop=st.sampled_from(rb._TELEMETRY_FIELDS))
    def test_missing_field_always_raises(self, drop):
        telem = {k: v for k, v in good_telemetry().items() if k != drop}
        with pytest.raises(BusSchemaError):
            rb.validate_telemetry(telem)

    @SETTINGS
    @given(field=st.sampled_from(("t_sim", "r", "z", "ip_ma", "beta",
                                  "heating", "seq")),
           bad=st.sampled_from((float("nan"), float("inf"),
                                -float("inf"), "6.2", None, [6.2])))
    def test_corrupt_value_always_raises(self, field, bad):
        with pytest.raises(BusSchemaError):
            rb.validate_telemetry({**good_telemetry(), field: bad})

    @SETTINGS
    @given(field=st.sampled_from(rb._ACTION_FIELDS),
           bad=st.sampled_from((float("nan"), float("inf"), "0.1", None)))
    def test_corrupt_action_always_raises(self, field, bad):
        with pytest.raises(BusSchemaError):
            rb.validate_action({**good_action(), field: bad})

    @SETTINGS
    @given(seq=st.integers(-10**9, -1))
    def test_negative_sequence_always_raises(self, seq):
        with pytest.raises(BusSchemaError):
            rb.validate_telemetry(good_telemetry(seq))


# ── safety envelope + PID fail-safe ─────────────────────────────────────


class TestEnvelopeAndPIDProperties:
    @SETTINGS
    @given(requested=finite, prev_frac=st.floats(-1.0, 1.0),
           rate=st.floats(1e-3, 1e3), amax=st.floats(1e-3, 1e3),
           dt=st.floats(1e-4, 1.0))
    def test_envelope_always_inside_both_bounds(self, requested, prev_frac,
                                                rate, amax, dt):
        """For any reachable actuator state (|prev| <= amax — the plant
        starts at 0 and the envelope itself keeps it inside), the output
        respects BOTH the rate window and the absolute clamp."""
        prev = prev_frac * amax
        out = rb._envelope_np(requested, prev, rate, amax, dt)
        assert out <= min(prev + rate * dt, amax) + 1e-12
        assert out >= max(prev - rate * dt, -amax) - 1e-12

    @SETTINGS
    @given(requested=st.floats(-0.5, 0.5), prev=st.floats(-0.5, 0.5),
           rate=st.floats(10.0, 100.0), dt=st.floats(0.5, 1.0))
    def test_envelope_identity_when_feasible(self, requested, prev,
                                             rate, dt):
        """A request already inside rate and absolute bounds passes
        through unchanged (no spurious actuation distortion)."""
        out = rb._envelope_np(requested, prev, rate, 1e3, dt)
        assert out == pytest.approx(requested, abs=0.0)

    @SETTINGS
    @given(err_sum=finite, last_err=finite,
           kp=st.floats(0, 10), ki=st.floats(0, 10), kd=st.floats(0, 10),
           bad=st.sampled_from((float("nan"), float("inf"),
                                -float("inf"))))
    def test_pid_nan_failsafe_for_any_state(self, err_sum, last_err,
                                            kp, ki, kd, bad):
        """Non-finite error: zero command AND untouched integrator, for
        every gain set and accumulated state (reference semantics:
        ``tokamak_flight_sim.py:239`` fail-safe hold)."""
        state = PIDStateNp(err_sum, last_err)
        out_state, cmd = rb.pid_step_np((kp, ki, kd), state, bad)
        assert cmd == 0.0
        assert out_state == state

    @SETTINGS
    @given(error=finite, kp=st.floats(0, 10), ki=st.floats(0, 10),
           kd=st.floats(0, 10), err_sum=st.floats(-100, 100),
           last_err=st.floats(-100, 100))
    def test_pid_closed_form(self, error, kp, ki, kd, err_sum, last_err):
        state = PIDStateNp(err_sum, last_err)
        out_state, cmd = rb.pid_step_np((kp, ki, kd), state, error)
        expect = kp * error + ki * (err_sum + error) + kd * (error - last_err)
        assert cmd == pytest.approx(expect, rel=1e-12, abs=1e-12)
        assert out_state.err_sum == pytest.approx(err_sum + error)
        assert out_state.last_err == error


# ── actuator delay line + clip box under arbitrary command sequences ────


class TestPlantDelayLineProperties:
    @SETTINGS
    @given(cmds=st.lists(st.tuples(st.floats(-5, 5), st.floats(-5, 5)),
                         min_size=6, max_size=40),
           delay=st.integers(0, 4))
    def test_delay_line_applies_k_minus_delay(self, cmds, delay):
        """The position update at tick k uses the ENFORCED command from
        tick k - delay_steps (zeros before warm-up) — exact cursor
        discipline for arbitrary command sequences and delays."""
        params = FlightSimParams(control_hz=100.0, shot_duration_s=1.0,
                                 delay_steps=delay)
        dt = params.control_dt
        state = rb.plant_init_np(params)
        enforced: list[tuple[float, float]] = []
        for k, (cmd_r, cmd_z) in enumerate(cmds):
            drifted = rb.plant_drift_np(state, k, params)
            # Enforcement happens against the PREVIOUS enforced command.
            exp_r = rb._envelope_np(cmd_r, drifted.pf_r,
                                    params.pf_rate_limit,
                                    params.pf_abs_max, dt)
            exp_z = rb._envelope_np(cmd_z, drifted.pf_z,
                                    params.pf_rate_limit,
                                    params.pf_abs_max, dt)
            enforced.append((exp_r, exp_z))
            applied_idx = k - delay           # delay==0 applies same-tick
            exp_applied = (enforced[applied_idx]
                           if applied_idx >= 0 else (0.0, 0.0))
            new_state = rb.plant_apply_np(drifted, cmd_r, cmd_z, params)
            exp_r_pos = min(max(drifted.r + exp_applied[0] * dt, 2.0), 10.0)
            exp_z_pos = min(max(drifted.z + exp_applied[1] * dt, -6.0), 6.0)
            assert new_state.r == pytest.approx(exp_r_pos, abs=1e-12)
            assert new_state.z == pytest.approx(exp_z_pos, abs=1e-12)
            state = new_state

    @SETTINGS
    @given(cmds=st.lists(st.tuples(finite, finite),
                         min_size=1, max_size=60),
           hz=st.sampled_from((50.0, 100.0, 1000.0)))
    def test_plant_never_leaves_clip_box(self, cmds, hz):
        params = FlightSimParams(control_hz=hz, shot_duration_s=1.0)
        state = rb.plant_init_np(params)
        for k, (cmd_r, cmd_z) in enumerate(cmds):
            state = rb.plant_drift_np(state, k, params)
            state = rb.plant_apply_np(state, cmd_r, cmd_z, params)
            assert 2.0 <= state.r <= 10.0
            assert -6.0 <= state.z <= 6.0
            assert abs(state.pf_r) <= params.pf_abs_max
            assert abs(state.pf_z) <= params.pf_abs_max
            assert 0.0 <= state.heating <= params.heating_abs_max


# ── physics node driven in-process: staleness ledger + fail-closed ──────


class _StubEvent:
    """threading.Event-shaped double for in-process node driving."""

    def __init__(self) -> None:
        self._set = False

    def is_set(self) -> bool:
        return self._set

    def set(self) -> None:
        self._set = True


def _ready_bus(**extra) -> dict:
    bus = {"control_ready": True, "diagnostics_ready": True}
    bus.update(extra)
    return bus


class TestPhysicsNodeLedger:
    @SETTINGS
    @given(n_ticks=st.integers(2, 40))
    def test_stale_ledger_exact_with_frozen_action(self, n_ticks):
        """One action published before the shot and never updated: the
        first read is fresh, every later read is stale — the ledger must
        equal n_ticks - 1 exactly (staleness bound, VERDICT #9)."""
        bus = _ready_bus(**{rb.KEY_ACTION: good_action(0)})
        ev = _StubEvent()
        params = FlightSimParams(control_hz=100.0,
                                 shot_duration_s=n_ticks / 100.0)
        rb.physics_node(bus, ev, params, n_ticks, tick_interval_s=0.0)
        assert "physics_error" not in bus
        assert bus["physics_summary"]["stale_action_reads"] == n_ticks - 1
        assert bus["physics_summary"]["ticks"] == n_ticks
        assert ev.is_set()

    @SETTINGS
    @given(n_ticks=st.integers(1, 30))
    def test_telemetry_sequence_monotone_and_validated(self, n_ticks):
        """Every published telemetry payload passes the consumer-side
        schema check and the sequence number is exactly the tick index
        (monotone, gapless)."""
        seen: list[int] = []

        class RecordingBus(dict):
            def __setitem__(self, key, value):
                if key == rb.KEY_TELEMETRY:
                    rb.validate_telemetry(value)
                    seen.append(value["seq"])
                super().__setitem__(key, value)

        bus = RecordingBus(_ready_bus())
        params = FlightSimParams(control_hz=100.0,
                                 shot_duration_s=n_ticks / 100.0)
        rb.physics_node(bus, _StubEvent(), params, n_ticks,
                        tick_interval_s=0.0)
        assert "physics_error" not in bus
        assert seen == list(range(n_ticks))

    @SETTINGS
    @given(bad=st.sampled_from((float("nan"), float("inf"), "0.3", None)),
           field=st.sampled_from(("cmd_r", "cmd_z")))
    def test_malformed_action_fails_closed(self, bad, field):
        """A corrupted action on the bus must surface as physics_error
        (and stop the session) — never silently steer the plant."""
        bus = _ready_bus(**{rb.KEY_ACTION: {**good_action(), field: bad}})
        ev = _StubEvent()
        params = FlightSimParams(control_hz=100.0, shot_duration_s=0.1)
        rb.physics_node(bus, ev, params, n_ticks=10, tick_interval_s=0.0)
        assert "physics_error" in bus
        assert "BusSchemaError" in bus["physics_error"]
        assert "physics_summary" not in bus
        assert ev.is_set()

    def test_missing_peer_fails_closed_not_openloop(self):
        """Without peer readiness the physics clock must NOT start: the
        node errors out instead of running the shot open-loop.  (Guarded
        by a short stub-event trip so the 30 s handshake wait is not
        actually served.)"""
        bus = {"control_ready": True}          # diagnostics never ready
        ev = _StubEvent()

        real_wait = rb._wait_for

        def impatient(bus_, key, timeout_s, stop_event):
            return real_wait(bus_, key, 0.02, stop_event)

        orig = rb._wait_for
        rb._wait_for = impatient
        try:
            params = FlightSimParams(control_hz=100.0, shot_duration_s=0.1)
            rb.physics_node(bus, ev, params, n_ticks=5, tick_interval_s=0.0)
        finally:
            rb._wait_for = orig
        assert "physics_error" in bus
        assert rb.KEY_TELEMETRY not in bus     # clock never started


# ── FPGA fixed-point export properties ──────────────────────────────────


class TestFixedPointProperties:
    @SETTINGS
    @given(total=st.integers(4, 24), data=st.data())
    def test_round_trip_half_lsb_for_any_format(self, total, data):
        from scpn_fusion_tpu.control.fpga_export import FixedPointFormat

        frac = data.draw(st.integers(0, total - 1))
        fmt = FixedPointFormat(total_bits=total, frac_bits=frac)
        # In-range representable span for this format.
        lo = fmt.min_int / fmt.scale
        hi = fmt.max_int / fmt.scale
        xs = data.draw(st.lists(st.floats(lo, hi, allow_nan=False),
                                min_size=1, max_size=16))
        x = np.asarray(xs)
        back = fmt.dequantize(fmt.quantize(x))
        assert np.max(np.abs(back - x)) <= 0.5 / fmt.scale + 1e-15

    @SETTINGS
    @given(total=st.integers(4, 24), data=st.data(),
           mag=st.floats(1.1, 1e6))
    def test_out_of_range_saturates_exactly(self, total, data, mag):
        from scpn_fusion_tpu.control.fpga_export import FixedPointFormat

        frac = data.draw(st.integers(0, total - 1))
        fmt = FixedPointFormat(total_bits=total, frac_bits=frac)
        hi_val = (fmt.max_int / fmt.scale) * mag + 1.0
        q = fmt.quantize(np.asarray([hi_val, -hi_val]))
        assert q[0] == fmt.max_int
        assert q[1] == fmt.min_int

    @SETTINGS
    @given(total=st.integers(4, 24), data=st.data())
    def test_hex_images_decode_to_quantised_ints(self, total, data):
        """Two's-complement hex ROM words decode (with sign extension)
        back to the exact quantised integers — the on-device ROM load is
        lossless for every format width."""
        from scpn_fusion_tpu.control.fpga_export import FixedPointFormat

        frac = data.draw(st.integers(0, total - 1))
        fmt = FixedPointFormat(total_bits=total, frac_bits=frac)
        q = np.asarray(data.draw(st.lists(
            st.integers(fmt.min_int, fmt.max_int),
            min_size=1, max_size=32)), dtype=np.int64)
        decoded = []
        for word in fmt.to_hex(q):
            v = int(word, 16)
            if v >= 1 << (fmt.total_bits - 1):
                v -= 1 << fmt.total_bits
            decoded.append(v)
        np.testing.assert_array_equal(np.asarray(decoded), q)

    def test_quantisation_error_shrinks_with_frac_bits(self):
        """More fractional bits never worsens the measured closed-loop
        action deviation (monotone refinement on the same trace)."""
        import jax.numpy as jnp

        from scpn_fusion_tpu.control.fpga_export import (
            FixedPointFormat, quantization_report,
        )
        from scpn_fusion_tpu.scpn.controller import ControllerConfig
        from tests.test_neuro_closed_loop import build_rz_controller

        ctrl = build_rz_controller(dtype=jnp.float32)
        cfg = ControllerConfig()
        rng = np.random.default_rng(3)
        n_axes = int(ctrl.axis_targets.shape[0])
        trace = (np.asarray(ctrl.axis_targets)[None, :]
                 + 0.3 * rng.standard_normal((40, n_axes)))
        devs = []
        for frac in (6, 10, 14):
            rep = quantization_report(
                ctrl, cfg, fmt=FixedPointFormat(16, frac),
                obs_trace=trace)
            devs.append(rep.max_action_dev)
        assert devs[2] <= devs[1] <= devs[0]
        assert devs[2] <= 0.02 * (np.abs(trace).max() + 1.0)


# ── batched ensemble element parity sweep (CPU f64) ─────────────────────


class TestBatchedElementParitySweep:
    @settings(max_examples=6, deadline=None,
              suppress_health_check=[HealthCheck.too_slow,
                                     HealthCheck.data_too_large])
    @given(seed=st.integers(0, 10**6), data=st.data())
    def test_element_equals_standalone_for_any_batch(self, seed, data):
        """Arbitrary batch composition and seed: every probed element of
        the vmapped solve matches its standalone solve at 1e-12 span-rel
        in f64 (the guarded while-body freezes converged elements, so
        batch context cannot perturb a member's trajectory).  This is
        the hypothesis sweep behind the campaign's single B=16 f32
        datapoint (``validation/run_batched_amortisation.py`` lane 1)."""
        import jax.numpy as jnp

        from scpn_fusion_tpu.core.grid import Grid
        from scpn_fusion_tpu.parallel.ensemble import solve_equilibrium_batch
        from tests.test_fixed_boundary import make_cfg

        b = data.draw(st.sampled_from((2, 4)))   # two compiled programs
        elem = data.draw(st.integers(0, b - 1))
        cfg = make_cfg("multigrid", n=33, max_iter=200)
        grid = Grid.from_config(cfg, dtype=np.float64)
        base = jnp.asarray([c.current * c.turns for c in cfg.coils],
                           jnp.float64)
        rng = np.random.default_rng(seed)
        scale = jnp.asarray(1.0 + 0.1 * rng.standard_normal(b))
        batch = scale[:, None] * base[None, :]
        i_t = jnp.asarray(15.0 + 2.0 * rng.standard_normal(b))

        psi_b, conv_b, iters_b = solve_equilibrium_batch(
            cfg, grid, batch, i_t)
        psi_1, conv_1, iters_1 = solve_equilibrium_batch(
            cfg, grid, batch[elem:elem + 1], i_t[elem:elem + 1])
        # The invariant holds CONVERGED OR NOT: an element that runs out
        # of iterations in the batch must run out identically standalone
        # (same trajectory, same verdict) — extreme random i_targets DO
        # produce non-convergent draws, and they must agree too.
        assert bool(np.asarray(conv_b)[elem]) == bool(np.asarray(conv_1)[0])
        span = float(jnp.max(psi_b[elem]) - jnp.min(psi_b[elem]))
        dev = float(jnp.max(jnp.abs(psi_b[elem] - psi_1[0]))) / span
        assert dev < 1e-12, (dev, seed, b, elem)
        assert int(np.asarray(iters_b)[elem]) == int(np.asarray(iters_1)[0])
