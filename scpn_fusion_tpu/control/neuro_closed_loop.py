"""Neuro-symbolic closed loop: SCPN controller + plant in ONE device program.

The reference's >10 kHz demo needed a Rust SNN kernel called per tick from
Python (``scpn/controller.py:345`` + ``fusion-control/src/snn.rs``); here the
compiled Petri-net controller tick and the plant update are fused into the
same ``lax.scan``, so a whole multi-thousand-tick shot runs as one XLA
program with zero host round-trips — the compiled answer to the reference's
``control.closed_loop_step_us`` metric (BASELINE.md: 12-47 us P95 per step).

Two plants are provided:
* the reduced R/Z drift plant (flight_sim.rs semantics) for kHz-rate shots;
* any user-supplied plant function ``(plant_state, actions) -> (plant_state,
  obs_vec)`` — e.g. the full GS solver.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.scpn.controller import (
    CompiledController,
    ControllerConfig,
    ControllerState,
    controller_step,
    initial_controller_state,
)


class ReducedPlantState(NamedTuple):
    r: jnp.ndarray
    z: jnp.ndarray


def reduced_plant_step(state: ReducedPlantState, actions: jnp.ndarray, dt: float,
                       beta: float = 1.0):
    """Reduced R/Z plant: Shafranov drift + vertical instability + actuation.

    ``actions`` = (radial_cmd, vertical_cmd) moves the axis directly
    (flight_sim.rs:322-365 semantics, normalised gains)."""
    r = jnp.clip(state.r + (0.01 * beta + actions[0]) * dt, 2.0, 10.0)
    z = jnp.clip(state.z + (0.02 + actions[1]) * dt, -6.0, 6.0)
    new = ReducedPlantState(r, z)
    obs = jnp.stack([r, z])
    return new, obs


@partial(jax.jit, static_argnames=("cfg", "n_ticks", "dt"))
def run_neuro_closed_loop(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    plant0: ReducedPlantState,
    *,
    n_ticks: int,
    dt: float,
):
    """Run ``n_ticks`` of SCPN-controller + reduced-plant, fully fused.

    Returns (final_controller_state, final_plant_state, traces) where traces
    carries per-tick (r, z, actions).
    """
    s0 = initial_controller_state(ctrl, cfg)

    def tick(carry, k):
        cs, ps = carry
        obs = jnp.stack([ps.r, ps.z])
        cs2, actions, _ = controller_step(ctrl, cfg, cs, obs, k)
        ps2, _ = reduced_plant_step(ps, actions, dt)
        return (cs2, ps2), {"r": ps2.r, "z": ps2.z, "actions": actions}

    (cs_f, ps_f), trace = jax.lax.scan(
        tick, (s0, plant0), jnp.arange(n_ticks, dtype=jnp.int32))
    return cs_f, ps_f, trace


def run_closed_loop_custom_plant(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    plant_step: Callable,
    plant0,
    obs0: jnp.ndarray,
    *,
    n_ticks: int,
):
    """Same loop with an arbitrary traced plant function (e.g. GS solver)."""
    s0 = initial_controller_state(ctrl, cfg)

    def tick(carry, k):
        cs, ps, obs = carry
        cs2, actions, _ = controller_step(ctrl, cfg, cs, obs, k)
        ps2, obs2 = plant_step(ps, actions)
        return (cs2, ps2, obs2), {"obs": obs2, "actions": actions}

    (cs_f, ps_f, _), trace = jax.lax.scan(
        tick, (s0, plant0, obs0), jnp.arange(n_ticks, dtype=jnp.int32))
    return cs_f, ps_f, trace
