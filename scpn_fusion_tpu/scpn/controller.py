"""Neuro-symbolic SCPN controller runtime, fully jitted and on-device.

Compiled redesign of the reference's controller tick
(``scpn/controller.py:345-469`` + ``controller_backend_mixin.py`` +
``controller_features_mixin.py``): feature extraction (error -> unipolar
pos/neg), place injection, float "oracle" path AND deterministic stochastic
path (antithetic Bernoulli passes, mantissa bit-flip fault injection,
per-transition delay ring buffer), and action decoding with gain /
slew-rate / absolute clamps — all as one pure jitted step on dense arrays.

Design deltas vs the reference (deliberate, accelerator-first):
* The packed-uint64 bitstream stochastic-computing path (AND+popcount,
  ``compiler.py:81-216``) is replaced by antithetic-pair Bernoulli sampling
  with ``jax.random.fold_in(key, k)`` — the same deterministic-by-tick
  estimator contract without 64-bit integer ops the VPU dislikes.
* Rust/NumPy backend dispatch disappears: XLA is the backend; the float
  "oracle" path remains available for diagnostics parity.
* State (marking, delay ring buffer, cursor, previous actions) is an
  explicit pytree, so the controller composes with ``lax.scan`` and can be
  fused into the same compiled program as a plant model (>10 kHz closed
  loop without host involvement; reference needed Rust for this).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.scpn.structure import CompiledNet


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Static controller configuration (hashable, jit-static)."""

    firing_mode: str = "binary"          # "binary" | "fractional"
    firing_margin: float = 0.05
    sc_n_passes: int = 1
    sc_binary_margin: float = 0.0
    sc_antithetic: bool = True
    sc_bitflip_rate: float = 0.0
    max_delay_ticks: int = 0
    dt: float = 1e-4
    seed_base: int = 42

    def __post_init__(self) -> None:
        if self.firing_mode not in ("binary", "fractional"):
            raise ValueError("firing_mode must be 'binary' or 'fractional'")
        if self.sc_n_passes < 1:
            raise ValueError("sc_n_passes must be >= 1")
        if not 0.0 <= self.sc_bitflip_rate < 1.0:
            raise ValueError("sc_bitflip_rate must be in [0, 1)")


class CompiledController(NamedTuple):
    """Traced controller weights/specs (pytree).

    Feature axes: ``err = clip((target - obs)/scale, -1, 1)`` split into
    pos/neg channels.  Injections write ``value*scale + offset`` into
    ``inj_place_ids``.  Actions difference pos/neg places with gain and
    clamps (reference ``contracts.py:100-242``).
    """

    w_in: jnp.ndarray          # (nT, nP)
    w_out: jnp.ndarray         # (nP, nT)
    thresholds: jnp.ndarray    # (nT,)
    delays: jnp.ndarray        # (nT,) int32
    initial_marking: jnp.ndarray  # (nP,)
    # feature axes
    axis_targets: jnp.ndarray  # (nA,)
    axis_scales: jnp.ndarray   # (nA,)
    # injections
    inj_place_ids: jnp.ndarray  # (nI,) int32
    inj_axis_idx: jnp.ndarray   # (nI,) int32
    inj_is_pos: jnp.ndarray     # (nI,) bool
    inj_scale: jnp.ndarray      # (nI,)
    inj_offset: jnp.ndarray     # (nI,)
    # actions
    act_pos: jnp.ndarray       # (nAct,) int32
    act_neg: jnp.ndarray       # (nAct,) int32
    act_gain: jnp.ndarray      # (nAct,)
    act_abs_max: jnp.ndarray   # (nAct,)
    act_slew_per_s: jnp.ndarray  # (nAct,)


class ControllerState(NamedTuple):
    marking: jnp.ndarray       # (nP,)
    pending: jnp.ndarray       # (max_delay+1, nT) delay ring buffer
    cursor: jnp.ndarray        # int32
    prev_actions: jnp.ndarray  # (nAct,)


def build_controller(
    net: CompiledNet,
    *,
    axis_targets,
    axis_scales,
    injections,      # list of (place_name, axis_idx, is_pos, scale, offset)
    actions,         # list of (pos_place_name, neg_place_name, gain, abs_max, slew)
    dtype=jnp.float32,
) -> CompiledController:
    """Assemble the traced controller pytree from a compiled net + specs."""
    pid = {n: i for i, n in enumerate(net.place_names)}
    inj = list(injections)
    act = list(actions)
    return CompiledController(
        w_in=jnp.asarray(net.w_in, dtype),
        w_out=jnp.asarray(net.w_out, dtype),
        thresholds=jnp.asarray(net.thresholds, dtype),
        delays=jnp.asarray(net.delays, jnp.int32),
        initial_marking=jnp.asarray(net.initial_marking, dtype),
        axis_targets=jnp.asarray(axis_targets, dtype),
        axis_scales=jnp.asarray(axis_scales, dtype),
        inj_place_ids=jnp.asarray([pid[p] for p, *_ in inj], jnp.int32),
        inj_axis_idx=jnp.asarray([a for _, a, *_ in inj], jnp.int32),
        inj_is_pos=jnp.asarray([bool(s) for _, _, s, *_ in inj]),
        inj_scale=jnp.asarray([sc for *_, sc, _ in inj], dtype),
        inj_offset=jnp.asarray([off for *_, off in inj], dtype),
        act_pos=jnp.asarray([pid[p] for p, *_ in act], jnp.int32),
        act_neg=jnp.asarray([pid[n] for _, n, *_ in act], jnp.int32),
        act_gain=jnp.asarray([g for *_, g, _, _ in act], dtype),
        act_abs_max=jnp.asarray([m for *_, m, _ in act], dtype),
        act_slew_per_s=jnp.asarray([s for *_, s in act], dtype),
    )


def initial_controller_state(
    ctrl: CompiledController, cfg: ControllerConfig
) -> ControllerState:
    n_t = ctrl.thresholds.shape[0]
    n_act = ctrl.act_gain.shape[0]
    dtype = ctrl.initial_marking.dtype
    return ControllerState(
        marking=ctrl.initial_marking,
        pending=jnp.zeros((cfg.max_delay_ticks + 1, n_t), dtype),
        cursor=jnp.int32(0),
        prev_actions=jnp.zeros((n_act,), dtype),
    )


def extract_features(ctrl: CompiledController, obs_vec: jnp.ndarray):
    """obs -> unipolar pos/neg feature channels (``contracts.py:100-165``)."""
    scale = jnp.where(jnp.abs(ctrl.axis_scales) > 1e-12, ctrl.axis_scales, 1e-12)
    err = jnp.clip((ctrl.axis_targets - obs_vec) / scale, -1.0, 1.0)
    pos = jnp.clip(jnp.maximum(err, 0.0), 0.0, 1.0)
    neg = jnp.clip(jnp.maximum(-err, 0.0), 0.0, 1.0)
    return pos, neg


def _bitflip(values: jnp.ndarray, rate: float, key) -> jnp.ndarray:
    """Mantissa bit-flip fault injection (``controller_features_mixin.py:
    167-187``), f32 variant: flip one of the 23 mantissa bits."""
    k1, k2 = jax.random.split(key)
    flips = jax.random.uniform(k1, values.shape) < rate
    bits = jax.random.randint(k2, values.shape, 0, 23, dtype=jnp.int32)
    raw = jax.lax.bitcast_convert_type(values.astype(jnp.float32), jnp.int32)
    flipped = jax.lax.bitcast_convert_type(
        raw ^ (jnp.int32(1) << bits), jnp.float32).astype(values.dtype)
    out = jnp.where(flips, flipped, values)
    out = jnp.where(jnp.isfinite(out), out, 0.0)
    return jnp.clip(out, 0.0, 1.0)


def _sample_firing(p_fire: jnp.ndarray, cfg: ControllerConfig, key) -> jnp.ndarray:
    """Deterministic antithetic-pair Bernoulli estimator of p_fire
    (replaces the reference's packed-bitstream popcount path)."""
    n = cfg.sc_n_passes
    n_t = p_fire.shape[0]
    if cfg.sc_antithetic and n >= 2:
        n_pairs = (n + 1) // 2
        base = jax.random.uniform(key, (n_pairs, n_t))
        low = jnp.sum(base < p_fire[None, :], axis=0)
        if n % 2 == 0:
            high = jnp.sum(base > (1.0 - p_fire)[None, :], axis=0)
        else:
            high = jnp.sum(base[:-1, :] > (1.0 - p_fire)[None, :], axis=0)
        counts = low + high
    else:
        u = jax.random.uniform(key, (n, n_t))
        counts = jnp.sum(u < p_fire[None, :], axis=0)
    return counts.astype(p_fire.dtype) / float(n)


@partial(jax.jit, static_argnames=("cfg",))
def controller_step(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    state: ControllerState,
    obs_vec: jnp.ndarray,
    k: jnp.ndarray,
):
    """One control tick: features -> inject -> SC Petri step -> actions.

    Returns (new_state, actions, diagnostics) where diagnostics carries the
    firing and marking vectors (the reference's ``last_sc_*`` surface).
    """
    dtype = state.marking.dtype
    pos, neg = extract_features(ctrl, obs_vec)

    # Place injection.
    values = jnp.where(ctrl.inj_is_pos, pos[ctrl.inj_axis_idx], neg[ctrl.inj_axis_idx])
    values = jnp.clip(values * ctrl.inj_scale + ctrl.inj_offset, 0.0, 1.0)
    m = state.marking.at[ctrl.inj_place_ids].set(values)

    # Activations and firing probability.
    a = ctrl.w_in @ m
    if cfg.firing_mode == "fractional":
        margin = max(cfg.firing_margin, 1e-12)
        p_fire = jnp.clip((a - ctrl.thresholds) / margin, 0.0, 1.0)
    elif cfg.sc_binary_margin > 0.0:
        p_fire = jnp.clip(
            0.5 + 0.5 * (a - ctrl.thresholds) / cfg.sc_binary_margin, 0.0, 1.0)
    else:
        p_fire = (a >= ctrl.thresholds).astype(dtype)

    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed_base), k)
    deterministic = cfg.sc_n_passes <= 1 or (
        cfg.firing_mode == "binary" and cfg.sc_binary_margin <= 0.0)
    if deterministic:
        f = p_fire
    else:
        f = _sample_firing(p_fire, cfg, jax.random.fold_in(key, 1))

    if cfg.sc_bitflip_rate > 0.0:
        f = _bitflip(f, cfg.sc_bitflip_rate, jax.random.fold_in(key, 2))

    # Per-transition delay ring buffer (``_apply_transition_timing``).
    if cfg.max_delay_ticks > 0:
        pending = state.pending
        fired_now = pending[state.cursor]
        pending = pending.at[state.cursor].set(0.0)
        immediate = ctrl.delays == 0
        fired_now = jnp.clip(fired_now + jnp.where(immediate, f, 0.0), 0.0, 1.0)
        n_t = f.shape[0]
        slots = (state.cursor + ctrl.delays) % pending.shape[0]
        delayed_add = jnp.where(immediate, 0.0, f)
        pending = pending.at[slots, jnp.arange(n_t)].add(delayed_add)
        pending = jnp.clip(pending, 0.0, 1.0)
        cursor = (state.cursor + 1) % pending.shape[0]
        f_timed = fired_now
    else:
        pending, cursor, f_timed = state.pending, state.cursor, f

    # Marking update: m' = clip(m - W_in^T f + W_out f, 0, 1).
    m2 = jnp.clip(m - ctrl.w_in.T @ f_timed + ctrl.w_out @ f_timed, 0.0, 1.0)
    if cfg.sc_bitflip_rate > 0.0:
        m2 = _bitflip(m2, cfg.sc_bitflip_rate, jax.random.fold_in(key, 3))

    # Action decode: gain * (pos - neg), slew limit, abs clamp.
    raw = (m2[ctrl.act_pos] - m2[ctrl.act_neg]) * ctrl.act_gain
    max_delta = ctrl.act_slew_per_s * cfg.dt
    raw = jnp.clip(raw, state.prev_actions - max_delta,
                   state.prev_actions + max_delta)
    actions = jnp.clip(raw, -ctrl.act_abs_max, ctrl.act_abs_max)

    new_state = ControllerState(m2, pending, cursor, actions)
    return new_state, actions, {"firing": f_timed, "marking": m2}


def oracle_step(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    marking: jnp.ndarray,
):
    """Float-path Petri step for diagnostics (``_oracle_step``)."""
    a = ctrl.w_in @ marking
    if cfg.firing_mode == "fractional":
        margin = max(cfg.firing_margin, 1e-12)
        f = jnp.clip((a - ctrl.thresholds) / margin, 0.0, 1.0)
    else:
        f = (a >= ctrl.thresholds).astype(marking.dtype)
    m2 = jnp.clip(marking - ctrl.w_in.T @ f + ctrl.w_out @ f, 0.0, 1.0)
    return f, m2


@partial(jax.jit, static_argnames=("cfg",))
def run_controller(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    state: ControllerState,
    obs_sequence: jnp.ndarray,   # (n_steps, nA)
):
    """Run a whole observation sequence under ``lax.scan``; returns the final
    state and the (n_steps, nAct) action trace."""
    def step(carry, inputs):
        s, k = carry
        obs = inputs
        s2, actions, _ = controller_step(ctrl, cfg, s, obs, k)
        return (s2, k + 1), actions

    (final, _), trace = jax.lax.scan(step, (state, jnp.int32(0)), obs_sequence)
    return final, trace
