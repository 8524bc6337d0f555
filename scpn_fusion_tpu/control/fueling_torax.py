"""Fueling mode + TORAX-style hybrid loop (SCPN-in-the-loop campaigns).

JAX-native port of two reference control lanes (VERDICT r1 missing #10):

* ``control/fueling_mode.py:97-217`` — ice-pellet density control: a PI
  path for tight convergence plus a GATED neuromorphic (SCPN) term that
  stays active away from the setpoint and fades near convergence, driving
  a reduced 0D ITER-like density model.
* ``control/torax_hybrid_loop.py:33-250`` — an NSTX-U-like hybrid
  campaign: a reduced TORAX-style 4-state plant (beta_N, q95, li3, W_th),
  a linear policy head, an SCPN corrector, and a risk signal, across
  disturbance episodes.

The reference iterates both loops in Python per tick; here each shot is
ONE ``lax.scan`` (controller tick fused with the plant), and the torax
campaign ``vmap``s all episodes concurrently.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.scpn.controller import (
    CompiledController,
    ControllerConfig,
    build_controller,
    controller_step,
    initial_controller_state,
)
from scpn_fusion_tpu.scpn.structure import StochasticPetriNet


def _build_axis_controller(gain: float, dtype) -> CompiledController:
    """Small R-axis regulation net reused as the neuromorphic pathway
    (the reference's fueling/hybrid controllers are the same shape)."""
    net = StochasticPetriNet()
    for p in ("e+", "e-", "c+", "c-", "sink"):
        net.add_place(p)
    for t, src, dst in (("t+", "e+", "c+"), ("t-", "e-", "c-")):
        net.add_transition(t, threshold=0.02)
        net.add_arc(src, t)
        net.add_arc(t, dst)
    for t, src in (("d+", "c+"), ("d-", "c-")):
        net.add_transition(t, threshold=0.0)
        net.add_arc(src, t)
        net.add_arc(t, "sink")
    compiled = net.compile()
    return build_controller(
        compiled,
        axis_targets=[6.2], axis_scales=[0.5],
        injections=[("e+", 0, True, 1.0, 0.0), ("e-", 0, False, 1.0, 0.0)],
        actions=[("c+", "c-", gain, 5000.0, 1e9)],
        dtype=dtype)


# ── Fueling mode ─────────────────────────────────────────────────────────


class FuelingResult(NamedTuple):
    final_density: jnp.ndarray
    final_abs_error: jnp.ndarray
    rmse: jnp.ndarray
    density_trace: jnp.ndarray
    command_trace: jnp.ndarray


@partial(jax.jit, static_argnames=("steps", "dtype"))
def run_fueling_mode(
    *,
    target_density: float = 1.0,
    initial_density: float = 0.82,
    steps: int = 3000,
    dt_s: float = 1e-3,
    dtype=jnp.float32,
) -> FuelingResult:
    """PI + gated-SCPN density control on the 0D model, one scan
    (reference ``simulate_iter_density_control`` :132-186 dynamics:
    leak 1.15, fueling gain 1.15, commands clipped to [-2, 2])."""
    ctrl = _build_axis_controller(5000.0, dtype)
    cfg = ControllerConfig(firing_mode="fractional", firing_margin=0.5,
                           dt=dt_s)
    cstate0 = initial_controller_state(ctrl, cfg)

    leak = 1.15
    fueling_gain = 1.15
    baseline = leak * target_density

    def step(carry, k):
        density, integ, cstate = carry
        error = target_density - density
        integ = jnp.clip(integ + error * dt_s, -0.5, 0.5)

        # Neuromorphic pathway on a mapped pseudo-observation of the
        # error (reference maps density error onto the R-axis channel).
        obs = jnp.asarray(
            [6.2 - 0.25 * jnp.clip(error, -1.0, 1.0)], dtype)
        cstate, actions, _ = controller_step(ctrl, cfg, cstate, obs, k)
        u_snn_raw = actions[0] / 5000.0
        gate = jnp.clip(jnp.abs(error) / 0.05, 0.0, 1.0)
        u_snn = 0.25 * gate * u_snn_raw

        u_pi = 1.95 * error + 7.2 * integ
        command = jnp.clip(u_pi + u_snn, -2.0, 2.0)

        density = jnp.maximum(
            density + dt_s * (baseline + fueling_gain * command
                              - leak * density), 0.0)
        return (density, integ, cstate), (density, command, error)

    init = (jnp.asarray(initial_density, dtype),
            jnp.asarray(0.0, dtype), cstate0)
    (density_f, _, _), (dens, cmd, err) = jax.lax.scan(
        step, init, jnp.arange(steps))
    return FuelingResult(
        final_density=density_f,
        final_abs_error=jnp.abs(target_density - density_f),
        rmse=jnp.sqrt(jnp.mean(err**2)),
        density_trace=dens, command_trace=cmd)


# ── TORAX-style hybrid campaign ──────────────────────────────────────────


class ToraxCampaignResult(NamedTuple):
    beta_n_final: jnp.ndarray      # (episodes,)
    q95_final: jnp.ndarray
    beta_rmse: jnp.ndarray         # (episodes,) vs the 1.85 target
    risk_peak: jnp.ndarray
    within_limits: jnp.ndarray     # (episodes,) bool


def _torax_policy(beta_n, q95):
    """Reduced TORAX-like policy head (reference :105-111)."""
    return jnp.clip(1.10 * (1.85 - beta_n) - 0.32 * (q95 - 4.9),
                    -1.6, 1.6)


def _risk_signal(beta_n, q95, li3, disturbance):
    return (0.40 + 0.42 * jnp.maximum(beta_n - 2.05, 0.0)
            + 0.38 * jnp.maximum(4.4 - q95, 0.0)
            + 0.22 * jnp.maximum(li3 - 1.25, 0.0)
            + 0.30 * disturbance)


@partial(jax.jit, static_argnames=("episodes", "steps", "dtype"))
def run_torax_hybrid_campaign(
    *,
    seed: int = 42,
    episodes: int = 16,
    steps: int = 220,
    dtype=jnp.float32,
) -> ToraxCampaignResult:
    """All episodes vmapped; each episode one scan (reference
    ``run_nstxu_torax_hybrid_campaign`` :153-250 dynamics/limits)."""
    ctrl = _build_axis_controller(5000.0, dtype)
    cfg = ControllerConfig(firing_mode="fractional", firing_margin=0.5,
                           dt=1e-3)

    def episode(ep_key, ep_idx):
        cstate0 = initial_controller_state(ctrl, cfg)
        # Episode disturbance: a mid-shot burst whose amplitude varies.
        amp = 0.25 + 0.5 * jax.random.uniform(ep_key)
        keys = jax.random.split(jax.random.fold_in(ep_key, 1), steps)

        def step(carry, inputs):
            beta_n, q95, li3, w_th, cstate = carry
            k, key = inputs
            t_frac = k.astype(dtype) / steps
            disturbance = amp * jnp.exp(-((t_frac - 0.5) / 0.12) ** 2)

            cmd_policy = _torax_policy(beta_n, q95)
            # SCPN corrector rides on the beta error channel.
            obs = jnp.asarray(
                [6.2 - 0.25 * jnp.clip(1.85 - beta_n, -1.0, 1.0)], dtype)
            cstate, actions, _ = controller_step(ctrl, cfg, cstate, obs, k)
            cmd = jnp.clip(cmd_policy + 0.2 * actions[0] / 5000.0,
                           -2.0, 2.0)

            n1 = 0.004 * jax.random.normal(key)
            n2 = 0.006 * jax.random.normal(jax.random.fold_in(key, 1))
            beta_n = beta_n + 0.045 * (0.85 * cmd - (beta_n - 1.85)
                                       - 0.52 * disturbance + n1)
            q95 = q95 + 0.060 * (0.18 - 0.33 * cmd + 0.62 * disturbance
                                 - 0.16 * (q95 - 4.9) + n2)
            li3 = li3 + 0.050 * (0.06 * cmd - 0.11 * disturbance
                                 - 0.09 * (li3 - 0.95))
            w_th = w_th + 0.110 * (10.0 * cmd - 5.0 * disturbance
                                   - 0.06 * (w_th - 140.0))
            beta_n = jnp.clip(beta_n, 0.6, 3.2).astype(dtype)
            q95 = jnp.clip(q95, 2.8, 7.5).astype(dtype)
            li3 = jnp.clip(li3, 0.45, 1.8).astype(dtype)
            w_th = jnp.clip(w_th, 50.0, 260.0).astype(dtype)
            risk = _risk_signal(beta_n, q95, li3, disturbance)
            return ((beta_n, q95, li3, w_th, cstate),
                    (beta_n, q95, risk))

        init = (jnp.asarray(1.7, dtype), jnp.asarray(5.1, dtype),
                jnp.asarray(0.95, dtype), jnp.asarray(140.0, dtype),
                cstate0)
        (beta_f, q95_f, _, _, _), (beta_tr, q95_tr, risk_tr) = \
            jax.lax.scan(step, init, (jnp.arange(steps), keys))
        beta_rmse = jnp.sqrt(jnp.mean((beta_tr - 1.85) ** 2))
        within = (jnp.all(beta_tr < 2.6) & jnp.all(q95_tr > 3.2))
        return beta_f, q95_f, beta_rmse, jnp.max(risk_tr), within

    keys = jax.random.split(jax.random.PRNGKey(seed), episodes)
    beta_f, q95_f, rmse, risk_peak, within = jax.vmap(episode)(
        keys, jnp.arange(episodes))
    return ToraxCampaignResult(
        beta_n_final=beta_f, q95_final=q95_f, beta_rmse=rmse,
        risk_peak=risk_peak, within_limits=within)
