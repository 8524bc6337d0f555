"""Realtime digital-twin ingest + SNN scenario planning — one device program.

Compiled re-design of the reference's realtime twin hook
(``control/digital_twin_ingest.py``): ``RealtimeTwinHook`` there ingests
``TelemetryPacket`` objects one at a time into a Python list ring buffer
(:156-170), replans every ``plan_every`` packets with a host loop that calls
``controller.step`` and ``predict_disruption_risk`` per horizon tick
(:180-244), and injects chaos-monkey faults per channel in Python
(:246-277).  Here the telemetry stream is a structure-of-arrays, chaos
injection is one vectorised random op, and the whole session — EVERY plan
point x horizon rollout, with the fused SCPN controller tick and the
linear-logit disruption-risk estimator in the loop — is a single jitted
program: plan points are vmapped, the horizon is a ``lax.scan``.

Risk model: the deterministic linear-logit estimator of
``control/disruption_risk_runtime.py:154-242`` (feature layout
[mean, std, max, slope, energy, last, n1, n2, n3, asym, spread], published
weights, bias -4.0), evaluated with masked statistics over the growing
signal history exactly as the reference grows its ``signal_history`` list.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.scpn.controller import (
    CompiledController,
    ControllerConfig,
    ControllerState,
    build_controller,
    controller_step,
    initial_controller_state,
)
from scpn_fusion_tpu.scpn.structure import StochasticPetriNet

VALID_MACHINES = ("NSTX-U", "SPARC")

# disruption_risk_runtime.py:19-33 — published linear-logit weights.
RISK_BIAS = -4.0
RISK_WEIGHTS = jnp.asarray(
    [0.02, 0.55, 0.03, 0.50, 0.005, 0.02,   # mean std max slope energy last
     1.10, 0.70, 0.45, 0.50, 0.15])         # n1 n2 n3 asym spread

HISTORY_WINDOW = 64  # reference scenario_plan buffer[-64:] (:192)


class TelemetryStream(NamedTuple):
    """Structure-of-arrays telemetry (the reference's packet list, SoA)."""

    t_ms: jnp.ndarray          # (n,) int32
    ip_ma: jnp.ndarray         # (n,)
    beta_n: jnp.ndarray        # (n,)
    q95: jnp.ndarray           # (n,)
    density_1e19: jnp.ndarray  # (n,)


class PlanSummary(NamedTuple):
    """Per-plan-point outputs (each leaf (n_plans,))."""

    safe_horizon_rate: jnp.ndarray
    mean_risk: jnp.ndarray
    recommended_action: jnp.ndarray
    passes: jnp.ndarray


def _normalize_machine(machine: str) -> str:
    key = machine.strip().upper()
    if key not in VALID_MACHINES:
        raise ValueError("machine must be 'NSTX-U' or 'SPARC'")
    return key


def generate_emulated_stream(
    machine: str, *, samples: int = 320, dt_ms: int = 5,
    key: jnp.ndarray | None = None,
) -> TelemetryStream:
    """Deterministic machine telemetry with a mid-shot disruption burst
    (reference ``generate_emulated_stream`` :108-151), fully vectorised."""
    machine = _normalize_machine(machine)
    if samples < 32:
        raise ValueError("samples must be >= 32.")
    if dt_ms < 1:
        raise ValueError("dt_ms must be >= 1.")
    if key is None:
        key = jax.random.PRNGKey(42)
    if machine == "NSTX-U":
        ip0, beta0, q0, d0 = 1.2, 1.95, 4.7, 6.5
    else:
        ip0, beta0, q0, d0 = 8.7, 1.65, 3.9, 8.2

    phase = jnp.arange(samples) / max(samples - 1, 1)
    burst = jnp.where(
        (phase >= 0.58) & (phase <= 0.76),
        0.18 * jnp.sin(jnp.pi * (phase - 0.58) / 0.18), 0.0)
    k1, k2 = jax.random.split(key)
    return TelemetryStream(
        t_ms=(jnp.arange(samples) * dt_ms).astype(jnp.int32),
        ip_ma=ip0 + 0.03 * jnp.sin(2 * jnp.pi * phase)
            + 0.004 * jax.random.normal(k1, (samples,)),
        beta_n=beta0 + 0.05 * jnp.cos(2 * jnp.pi * 1.4 * phase) + burst,
        q95=q0 - 0.12 * burst + 0.01 * jax.random.normal(k2, (samples,)),
        density_1e19=d0 + 0.10 * jnp.sin(2 * jnp.pi * 0.6 * phase),
    )


def apply_chaos_monkey(
    stream: TelemetryStream, key: jnp.ndarray, *,
    dropout_prob: float = 0.0, noise_std: float = 0.0,
) -> tuple[TelemetryStream, jnp.ndarray, jnp.ndarray]:
    """Vectorised channel dropout + Gaussian noise injection (reference
    ``_apply_chaos_monkey`` :246-277).  Returns (stream, n_dropouts,
    n_noise_injections)."""
    drop = jnp.clip(dropout_prob, 0.0, 1.0)
    sigma = jnp.maximum(noise_std, 0.0)
    n = stream.beta_n.shape[0]
    kd, kn = jax.random.split(key)
    channels = jnp.stack([stream.ip_ma, stream.beta_n, stream.q95,
                          stream.density_1e19])            # (4, n)
    dropped = jax.random.uniform(kd, channels.shape) < drop
    noisy = jnp.where(dropped, 0.0, channels) \
        + sigma * jax.random.normal(kn, channels.shape)
    out = TelemetryStream(
        t_ms=stream.t_ms,
        ip_ma=noisy[0], beta_n=noisy[1], q95=noisy[2],
        density_1e19=jnp.maximum(noisy[3], 0.0),
    )
    n_noise = jnp.where(sigma > 0.0, 4 * n, 0)
    return out, jnp.sum(dropped).astype(jnp.int32), n_noise


def risk_signal(stream: TelemetryStream) -> jnp.ndarray:
    """Elementwise scalar risk channel (reference ``_risk_signal``
    :172-178)."""
    return (0.45
            + 0.40 * jnp.maximum(stream.beta_n - 2.0, 0.0)
            + 0.30 * jnp.maximum(4.2 - stream.q95, 0.0)
            + 0.10 * jnp.maximum(stream.density_1e19 - 8.8, 0.0))


def disruption_risk_masked(signal: jnp.ndarray, mask: jnp.ndarray,
                           toroidal: jnp.ndarray) -> jnp.ndarray:
    """Linear-logit risk over a masked signal buffer
    (``disruption_risk_runtime.py:154-242``).  ``toroidal`` is
    ``[n1, n2, n3, asym, spread]``."""
    m = mask.astype(signal.dtype)
    n = jnp.maximum(jnp.sum(m), 1.0)
    mean = jnp.sum(signal * m) / n
    var = jnp.sum(m * (signal - mean) ** 2) / n
    std = jnp.sqrt(jnp.maximum(var, 0.0))
    mx = jnp.max(jnp.where(mask, signal, -jnp.inf))
    first = signal[jnp.argmax(mask)]
    last_idx = signal.shape[0] - 1 - jnp.argmax(mask[::-1])
    last = signal[last_idx]
    slope = (last - first) / jnp.maximum(n - 1.0, 1.0)
    energy = jnp.sum(m * signal * signal) / n
    features = jnp.concatenate(
        [jnp.stack([mean, std, mx, slope, energy, last]), toroidal])
    return jax.nn.sigmoid(RISK_BIAS + jnp.dot(RISK_WEIGHTS, features))


def build_snn_planner(
    *, seed_base: int = 161803399,
) -> tuple[CompiledController, ControllerConfig]:
    """The 4-place/2-transition mitigation-planning net
    (reference ``_build_snn_planner`` :53-105: gain 1800 A, |dI| <= 3500 A,
    R target 1.9 m / scale 0.9 m), compiled to the fused controller tick."""
    net = StochasticPetriNet()
    net.add_place("x_R_pos", initial_tokens=0.0)
    net.add_place("x_R_neg", initial_tokens=0.0)
    net.add_place("a_R_pos", initial_tokens=0.0)
    net.add_place("a_R_neg", initial_tokens=0.0)
    net.add_transition("T_Rp", threshold=0.1)
    net.add_transition("T_Rn", threshold=0.1)
    net.add_arc("x_R_pos", "T_Rp", weight=1.0)
    net.add_arc("x_R_neg", "T_Rn", weight=1.0)
    net.add_arc("T_Rp", "a_R_pos", weight=1.0)
    net.add_arc("T_Rn", "a_R_neg", weight=1.0)
    compiled = net.compile()
    ctrl = build_controller(
        compiled,
        axis_targets=[1.9], axis_scales=[0.9],
        injections=[("x_R_pos", 0, True, 1.0, 0.0),
                    ("x_R_neg", 0, False, 1.0, 0.0)],
        actions=[("a_R_pos", "a_R_neg", 1800.0, 3500.0, 1.0e6)],
    )
    cfg = ControllerConfig(firing_mode="binary", dt=1.0e-3,
                           seed_base=seed_base)
    return ctrl, cfg


def scenario_plan(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    hist: jnp.ndarray,        # (HISTORY_WINDOW,) recent risk signals
    hist_mask: jnp.ndarray,   # (HISTORY_WINDOW,) bool validity (left-padded)
    beta0, q95_0, dens0,
    *, horizon: int = 24,
) -> PlanSummary:
    """Project near-term risk under SNN mitigation (reference
    ``scenario_plan`` :180-244), the horizon as one ``lax.scan``."""
    if horizon < 4:
        raise ValueError("horizon must be >= 4.")
    buf = jnp.concatenate([hist, jnp.zeros((horizon,), hist.dtype)])
    base_mask = jnp.concatenate(
        [hist_mask, jnp.zeros((horizon,), jnp.bool_)])
    state0 = initial_controller_state(ctrl, cfg)

    # The signal history accumulates across ticks (the reference appends to
    # ``signal_history`` per tick, :211), so the buffer rides the scan carry.
    def step_threaded(carry, k):
        (cstate, beta, q95, dens, buf_c) = carry
        obs = jnp.asarray([beta], ctrl.initial_marking.dtype)
        cstate, actions, _ = controller_step(ctrl, cfg, cstate, obs, k)
        control = jnp.clip(actions[0] / 3500.0, -0.8, 0.8)
        beta = beta + 0.025 * (0.9 * control - (beta - 1.9))
        q95 = q95 + 0.030 * (0.12 - 0.28 * control - 0.15 * (q95 - 4.4))
        dens = dens + 0.010 * (0.05 * control - 0.08 * (dens - 7.4))
        sig = (0.45 + 0.40 * jnp.maximum(beta - 2.0, 0.0)
               + 0.30 * jnp.maximum(4.2 - q95, 0.0)
               + 0.10 * jnp.maximum(dens - 8.8, 0.0))
        buf_c = buf_c.at[HISTORY_WINDOW + k].set(sig.astype(buf_c.dtype))
        mask_k = base_mask | (
            jnp.arange(buf_c.shape[0]) < HISTORY_WINDOW + k + 1)
        ac = jnp.abs(control)
        toroidal = jnp.stack([
            0.06 + 0.04 * ac, 0.04 + 0.03 * ac, 0.02 + 0.02 * ac,
            0.07 + 0.06 * ac, 0.02 + 0.01 * ac])
        risk = disruption_risk_masked(buf_c, mask_k, toroidal)
        return (cstate, beta, q95, dens, buf_c), (risk, control)

    carry0 = (state0, jnp.asarray(beta0, buf.dtype),
              jnp.asarray(q95_0, buf.dtype), jnp.asarray(dens0, buf.dtype),
              buf)
    _, (risks, controls) = jax.lax.scan(
        step_threaded, carry0, jnp.arange(horizon))
    safe_rate = jnp.mean((risks < 0.85).astype(buf.dtype))
    mean_risk = jnp.mean(risks)
    return PlanSummary(
        safe_horizon_rate=safe_rate,
        mean_risk=mean_risk,
        recommended_action=controls[-1],
        passes=(safe_rate >= 0.90) & (mean_risk <= 0.75),
    )


@partial(jax.jit,
         static_argnames=("machine", "samples", "dt_ms", "horizon",
                          "plan_every"))
def run_realtime_twin_session(
    machine: str,
    *,
    seed: int = 42,
    samples: int = 320,
    dt_ms: int = 5,
    horizon: int = 24,
    plan_every: int = 8,
    chaos_dropout_prob: float = 0.0,
    chaos_noise_std: float = 0.0,
):
    """Full ingest+planning session (reference ``run_realtime_twin_session``
    :280-372) as one compiled program; plan points are vmapped.

    Returns ``(plans: PlanSummary, info: dict of scalars)``.
    """
    machine = _normalize_machine(machine)
    if plan_every < 1:
        raise ValueError("plan_every must be >= 1.")
    key = jax.random.PRNGKey(seed)
    stream = generate_emulated_stream(
        machine, samples=samples, dt_ms=dt_ms, key=key)
    stream, n_drop, n_noise = apply_chaos_monkey(
        stream, jax.random.fold_in(key, 2026),
        dropout_prob=chaos_dropout_prob, noise_std=chaos_noise_std)
    signals = risk_signal(stream)

    ctrl, cfg = build_snn_planner()
    plan_idx = jnp.arange(plan_every, samples, plan_every)

    def plan_at(i):
        offs = jnp.arange(-(HISTORY_WINDOW - 1), 1)
        pos = i + offs
        hist = signals[jnp.clip(pos, 0, samples - 1)]
        mask = pos >= 0
        return scenario_plan(ctrl, cfg, hist, mask,
                             stream.beta_n[i], stream.q95[i],
                             stream.density_1e19[i], horizon=horizon)

    plans = jax.vmap(plan_at)(plan_idx)
    info = {
        "n_plans": plan_idx.shape[0],
        "chaos_dropouts": n_drop,
        "chaos_noise_injections": n_noise,
        "all_pass_rate": jnp.mean(plans.passes.astype(jnp.float32)),
        "worst_mean_risk": jnp.max(plans.mean_risk),
        "min_safe_horizon_rate": jnp.min(plans.safe_horizon_rate),
    }
    return plans, info
