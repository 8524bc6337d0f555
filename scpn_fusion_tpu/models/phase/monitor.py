"""Phase observability: realtime UPDE monitor, stream codec, GK bridge.

JAX-native port of the reference's phase-observability trio
(VERDICT r1 missing #7):

* ``phase/realtime_monitor.py:47-320`` — tick-by-tick UPDE monitor with
  LyapunovGuard and a trajectory recorder.  Here the monitored run is ONE
  compiled ``lax.scan`` (UPDE tick + guard + recording fused); snapshots
  come back as stacked arrays, and ``save_npz`` persists the recorder.
* ``phase/ws_phase_stream.py:61-244`` — authenticated snapshot streaming.
  The reference serves WebSockets; this image has zero egress, so the
  SAME framing/authorization semantics (bearer token compared in constant
  time, loopback-only binding guard, JSON snapshot frames, bounded
  command messages) are realised transport-agnostically: a frame codec +
  writer that works over any byte stream (file, pipe, local socket).
* ``phase/gk_upde_bridge.py:29-110`` — GK->UPDE coupling: turbulence
  growth rates and fluxes modulate the layer coupling matrix K_nm and the
  turbulence layer's natural frequency.  Implemented as pure ``jnp`` on
  this framework's native GK outputs (``TGLFNativeFluxes``), so the
  bridge composes under jit with the path-A native model.
"""

from __future__ import annotations

import dataclasses
import hmac
import json
from functools import partial
from pathlib import Path
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.models.phase.guard import (
    GuardConfig,
    GuardState,
    guard_check,
    init_guard,
)
from scpn_fusion_tpu.models.phase.knm import KnmSpec, plasma_omega
from scpn_fusion_tpu.models.phase.upde import (
    layer_order_parameters,
    upde_tick,
)

# ── Realtime monitor (fused tick stream) ─────────────────────────────────


class MonitorState(NamedTuple):
    theta: jnp.ndarray        # (L, n) padded phases
    guard: GuardState
    tick: jnp.ndarray


class MonitorTrace(NamedTuple):
    """Stacked snapshots — the TrajectoryRecorder as arrays."""

    r_global: jnp.ndarray     # (T,)
    r_layer: jnp.ndarray      # (T, L)
    v_global: jnp.ndarray     # (T,)
    v_layer: jnp.ndarray      # (T, L)
    lambda_exp: jnp.ndarray   # (T,)
    guard_approved: jnp.ndarray
    guard_violations: jnp.ndarray

    @property
    def n_ticks(self) -> int:
        return int(self.r_global.shape[0])

    def snapshot(self, i: int) -> dict[str, Any]:
        """One dashboard snapshot dict (reference ``tick`` return shape)."""
        return {
            "tick": int(i) + 1,
            "R_global": float(self.r_global[i]),
            "R_layer": np.asarray(self.r_layer[i]).tolist(),
            "V_global": float(self.v_global[i]),
            "V_layer": np.asarray(self.v_layer[i]).tolist(),
            "lambda_exp": float(self.lambda_exp[i]),
            "guard_approved": bool(self.guard_approved[i]),
            "guard_violations": int(self.guard_violations[i]),
        }

    def save_npz(self, path: str | Path) -> Path:
        path = Path(path)
        np.savez(path, **{k: np.asarray(v) for k, v in self._asdict().items()})
        return path


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    dt: float = 1e-3
    psi_driver: float = 0.0
    pac_gamma: float = 0.0
    guard: GuardConfig = GuardConfig()


def init_monitor(spec: KnmSpec, *, n_per: int = 50, seed: int = 42,
                 cfg: MonitorConfig = MonitorConfig(),
                 dtype=jnp.float32):
    """Build (state, static arrays) from a plasma Knm spec (reference
    ``from_plasma`` :150-185)."""
    n_layers = spec.n_layers
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, (n_layers, n_per))
    omega_base = plasma_omega(n_layers)
    omega = omega_base[:, None] + rng.normal(0, 0.2, (n_layers, n_per))
    mask = np.ones((n_layers, n_per))
    k_matrix, alpha, zeta = spec.arrays(dtype)
    state = MonitorState(
        theta=jnp.asarray(theta, dtype),
        guard=init_guard(cfg.guard, dtype),
        tick=jnp.int32(0))
    arrays = {
        "omega": jnp.asarray(omega, dtype),
        "mask": jnp.asarray(mask, dtype),
        "k_matrix": k_matrix, "alpha": alpha, "zeta": zeta,
    }
    return state, arrays


@partial(jax.jit, static_argnames=("cfg",))
def monitor_tick(
    state: MonitorState,
    arrays: dict,
    *,
    cfg: MonitorConfig = MonitorConfig(),
    k_override: jnp.ndarray | None = None,
):
    """One monitored UPDE tick; returns (new_state, snapshot pytree)."""
    k_matrix = arrays["k_matrix"] if k_override is None else k_override
    theta1, aux = upde_tick(
        state.theta, arrays["omega"], arrays["mask"], k_matrix,
        arrays["alpha"], arrays["zeta"], dt=cfg.dt,
        psi_global=jnp.asarray(cfg.psi_driver, state.theta.dtype),
        pac_gamma=cfg.pac_gamma)
    flat = theta1.reshape(-1)
    verdict, guard_state = guard_check(
        cfg.guard, state.guard, flat,
        jnp.asarray(cfg.psi_driver, state.theta.dtype))
    new_state = MonitorState(theta=theta1, guard=guard_state,
                             tick=state.tick + 1)
    snap = {
        "r_global": aux["R_global"], "r_layer": aux["R_layer"],
        "v_global": aux["V_global"], "v_layer": aux["V_layer"],
        "lambda_exp": verdict.lambda_exp,
        "guard_approved": verdict.approved,
        "guard_violations": verdict.consecutive_violations,
    }
    return new_state, snap


@partial(jax.jit, static_argnames=("cfg", "n_ticks"))
def run_monitor(
    state: MonitorState,
    arrays: dict,
    *,
    cfg: MonitorConfig = MonitorConfig(),
    n_ticks: int = 1000,
) -> tuple[MonitorState, MonitorTrace]:
    """The whole monitored run — UPDE + guard + recorder — in one scan."""

    def step(s, _):
        s, snap = monitor_tick(s, arrays, cfg=cfg)
        return s, snap

    final, snaps = jax.lax.scan(step, state, None, length=n_ticks)
    return final, MonitorTrace(
        r_global=snaps["r_global"], r_layer=snaps["r_layer"],
        v_global=snaps["v_global"], v_layer=snaps["v_layer"],
        lambda_exp=snaps["lambda_exp"],
        guard_approved=snaps["guard_approved"],
        guard_violations=snaps["guard_violations"])


# ── Stream codec (transport-agnostic ws_phase_stream semantics) ──────────


def constant_time_token_eq(candidate: str, expected: str) -> bool:
    """Constant-time bearer-token comparison (reference
    ``_constant_time_eq`` :61-64)."""
    return hmac.compare_digest(candidate.encode("utf-8"),
                               expected.encode("utf-8"))


def is_loopback_host(host: str) -> bool:
    """Reference ``_is_loopback_host`` :66-68: non-loopback binds require
    explicit opt-in (the stream carries machine state)."""
    return host in ("127.0.0.1", "::1", "localhost")


class StreamAuthError(PermissionError):
    pass


@dataclasses.dataclass(frozen=True)
class PhaseStreamCodec:
    """Authenticated JSON frame codec for monitor snapshots.

    Frames: one JSON object per line with a ``token`` field; decoding
    validates the token in constant time and bounds command values
    (reference ``_message_authorized`` + ``_coerce_command_value``
    :106-146).  Transport-agnostic by design: any byte stream works.
    """

    token: str
    max_frame_bytes: int = 65536
    command_bounds: tuple[float, float] = (-10.0, 10.0)

    def encode_snapshot(self, snap: dict[str, Any]) -> bytes:
        payload = {"type": "snapshot", "token": self.token, **snap}
        return (json.dumps(payload) + "\n").encode("utf-8")

    def decode(self, frame: bytes) -> dict[str, Any]:
        if len(frame) > self.max_frame_bytes:
            raise StreamAuthError("frame exceeds size bound")
        try:
            payload = json.loads(frame.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise StreamAuthError(f"malformed frame: {exc}") from exc
        if not isinstance(payload, dict):
            raise StreamAuthError("frame must be a JSON object")
        token = payload.get("token")
        if not (isinstance(token, str)
                and constant_time_token_eq(token, self.token)):
            raise StreamAuthError("bad or missing bearer token")
        return payload

    def decode_command(self, frame: bytes) -> tuple[str, float]:
        """Authorised (name, value) command with bounded value."""
        payload = self.decode(frame)
        if payload.get("type") != "command":
            raise StreamAuthError("not a command frame")
        name = payload.get("name")
        if not isinstance(name, str) or not name.strip():
            raise StreamAuthError("command needs a non-empty name")
        try:
            value = float(payload.get("value"))
        except (TypeError, ValueError) as exc:
            raise StreamAuthError("command value must be numeric") from exc
        lo, hi = self.command_bounds
        if not (np.isfinite(value) and lo <= value <= hi):
            raise StreamAuthError(
                f"command value {value} outside bounds [{lo}, {hi}]")
        return name, value


def stream_trace(trace: MonitorTrace, codec: PhaseStreamCodec,
                 writer) -> int:
    """Write every snapshot of a trace as authenticated frames; returns
    the frame count.  ``writer`` is any object with ``write(bytes)``."""
    n = trace.n_ticks
    for i in range(n):
        writer.write(codec.encode_snapshot(trace.snapshot(i)))
    return n


# ── GK -> UPDE bridge ────────────────────────────────────────────────────


def adaptive_knm_from_gk(
    k_base: jnp.ndarray,          # (L, L)
    gamma_max,                    # dominant GK growth rate [c_s/a]
    chi_e,                        # electron heat diffusivity [m^2/s]
    chi_i_profile: jnp.ndarray | None = None,
    *,
    gamma_ref: float = 0.2,
    chi_ref: float = 1.0,
) -> jnp.ndarray:
    """Modulate K_nm from GK outputs (reference ``adaptive_knm`` :29-73).

    Layer semantics (plasma Knm convention): 0 = microturbulence,
    1 = zonal flows, 3 = sawtooth/ELM, 4 = transport barrier.
    Pure jnp: composes under jit with the native TGLF lane.
    """
    el = k_base.shape[0]
    if el < 6:
        return k_base
    k = k_base
    dt = k_base.dtype
    gamma_max = jnp.asarray(gamma_max, dt)
    chi_e = jnp.asarray(chi_e, dt)

    # P0<->P1: microturbulence <-> zonal flows.
    f01 = 1.0 + 0.5 * jnp.tanh(gamma_max / max(gamma_ref, 1e-10))
    k = k.at[0, 1].set(k_base[0, 1] * f01)
    k = k.at[1, 0].set(k_base[0, 1] * f01)

    # P1<->P4: zonal flow <-> transport barrier.
    f14 = 1.0 + 0.3 * jnp.clip(jnp.maximum(chi_e, 1e-10) / chi_ref,
                               0.0, 2.0)
    k = k.at[1, 4].set(k_base[1, 4] * f14)
    k = k.at[4, 1].set(k_base[1, 4] * f14)

    # P3<->P4: pedestal ratio from the chi_i profile.
    if chi_i_profile is not None:
        chi_i_profile = jnp.asarray(chi_i_profile, dt)
        n = chi_i_profile.shape[0]
        chi_core = jnp.maximum(jnp.mean(chi_i_profile[: n // 3]), 1e-10)
        chi_ped = jnp.maximum(jnp.mean(chi_i_profile[-(n // 5):]), 1e-10)
        f34 = 1.0 + 0.4 * (chi_ped / chi_core - 1.0)
        k = k.at[3, 4].set(k_base[3, 4] * f34)
        k = k.at[4, 3].set(k_base[3, 4] * f34)
    return k


def gk_natural_frequencies(
    omega_base: jnp.ndarray,      # (L,) layer frequencies
    gamma_max,
    *,
    gamma_scale: float = 0.1,
) -> jnp.ndarray:
    """Turbulence layer frequency rises with the dominant growth rate
    (reference ``gk_natural_frequencies`` :76-110)."""
    return omega_base.at[0].add(
        gamma_scale * jnp.maximum(gamma_max, 0.0))
