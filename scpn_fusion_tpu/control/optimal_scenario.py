"""Optimal shot-trajectory design: gradients THROUGH the integrated shot.

Role-parity with the reference's optimal-control lane
(``control/fusion_optimal_control.py`` waveform/trajectory optimisation
and the ``VoltSecondOptimizer`` ramp optimisation in
``control/volt_second_manager.py:75``), built on this framework's
differentiability: the whole integrated scenario
(:func:`~scpn_fusion_tpu.models.physics.integrated_scenario.run_shot` —
schedule -> L-H -> dynamic burn -> flux budget, one ``lax.scan``) is a
traceable function of the waveform knobs, so the shot design problem

    maximise  Q_flattop
    s.t.      flux budget not exhausted, Greenwald fraction < 0.9

is solved by Adam on ``jax.grad`` of one compiled objective — no finite
differences, no surrogate of the simulator.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from typing import TYPE_CHECKING

from scpn_fusion_tpu.control.scenario import FluxBudget, ScenarioSchedule, Waveform

if TYPE_CHECKING:  # pragma: no cover
    from scpn_fusion_tpu.models.physics.integrated_scenario import ScenarioMachine

# integrated_scenario imports control.scenario (-> control/__init__ -> this
# module), so its symbols must be imported lazily to break the cycle.


def _scenario_mod():
    from scpn_fusion_tpu.models.physics import integrated_scenario
    return integrated_scenario


class ShotKnobs(NamedTuple):
    """Differentiable waveform parameters (raw, unconstrained)."""

    p_aux_flat_mw: jnp.ndarray
    ne_flat_19: jnp.ndarray
    ip_flat_ma: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    ramp_s: float = 60.0
    flattop_s: float = 300.0
    dt_s: float = 0.5
    greenwald_cap: float = 0.9
    flux_margin_vs: float = 5.0
    penalty: float = 50.0
    learning_rate: float = 0.05
    n_iters: int = 40
    # box bounds (projected)
    p_aux_bounds: tuple = (5.0, 120.0)
    ne_bounds: tuple = (2.0, 15.0)
    ip_bounds: tuple = (5.0, 17.0)


def _schedule_from_knobs(k: ShotKnobs, cfg: OptimizerConfig
                         ) -> ScenarioSchedule:
    """Build the staged schedule with TRACED values (times are static)."""
    ramp, flat = cfg.ramp_s, cfg.flattop_s
    end = 2 * ramp + flat
    t_full_ne = ramp + 0.3 * flat
    return ScenarioSchedule(waveforms=(
        ("ip_ma", Waveform((0.0, ramp, ramp + flat, end),
                           (0.1, k.ip_flat_ma, k.ip_flat_ma, 0.1))),
        ("ne19", Waveform((0.0, ramp, t_full_ne, ramp + flat,
                           ramp + flat + 0.5 * ramp, end),
                          (0.5, 0.5 * k.ne_flat_19, k.ne_flat_19,
                           k.ne_flat_19, 0.3, 0.3))),
        ("p_aux_mw", Waveform((0.0, 0.5 * ramp, ramp, ramp + flat, end),
                              (0.0, 0.0, k.p_aux_flat_mw,
                               k.p_aux_flat_mw, 0.0))),
    ))


def shot_objective(k: ShotKnobs, budget: FluxBudget,
                   m: "ScenarioMachine", cfg: OptimizerConfig):
    """Negative soft-constrained Q (to MINIMISE); returns (loss, aux)."""
    sched = _schedule_from_knobs(k, cfg)
    trace, report = _scenario_mod().run_shot(sched, budget, m, dt_s=cfg.dt_s)
    # soft constraints from the trace (differentiable)
    flux_deficit = jnp.maximum(
        cfg.flux_margin_vs - jnp.min(trace.flux_remaining_vs), 0.0)
    gw_excess = jnp.maximum(
        jnp.max(jnp.where(trace.ip_ma > 1.0, trace.greenwald_fraction,
                          0.0)) - cfg.greenwald_cap, 0.0)
    loss = (-report.q_flattop
            + cfg.penalty * (flux_deficit / cfg.flux_margin_vs) ** 2
            + cfg.penalty * gw_excess ** 2)
    return loss, report


class OptimalShotResult(NamedTuple):
    knobs: ShotKnobs
    q_flattop: jnp.ndarray
    loss_history: jnp.ndarray
    feasible: jnp.ndarray


def optimize_shot(k0: ShotKnobs, budget: FluxBudget,
                  m: "ScenarioMachine | None" = None,
                  cfg: OptimizerConfig = OptimizerConfig()
                  ) -> OptimalShotResult:
    """Adam on the differentiable shot objective with box projection."""
    if m is None:
        m = _scenario_mod().ScenarioMachine()
    lo = jnp.asarray([cfg.p_aux_bounds[0], cfg.ne_bounds[0],
                      cfg.ip_bounds[0]])
    hi = jnp.asarray([cfg.p_aux_bounds[1], cfg.ne_bounds[1],
                      cfg.ip_bounds[1]])

    def loss_fn(vec):
        k = ShotKnobs(vec[0], vec[1], vec[2])
        loss, _ = shot_objective(k, budget, m, cfg)
        return loss

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(cfg.learning_rate)
    # No explicit dtype: inherit the default (f32, or f64 with x64 on
    # CPU) so the knob vector matches the scenario constants' dtype instead
    # of silently truncating with a per-call warning (ADVICE.md r1).
    vec = jnp.asarray([k0.p_aux_flat_mw, k0.ne_flat_19, k0.ip_flat_ma])
    state = opt.init(vec)
    losses = []
    for _ in range(cfg.n_iters):
        loss, g = value_and_grad(vec)
        # normalise the raw gradient so one lr fits all knob scales
        g = g / jnp.maximum(jnp.linalg.norm(g), 1e-12)
        updates, state = opt.update(g, state, vec)
        vec = jnp.clip(optax.apply_updates(vec, updates), lo, hi)
        losses.append(float(loss))

    k_final = ShotKnobs(vec[0], vec[1], vec[2])
    _, report = shot_objective(k_final, budget, m, cfg)
    feasible = (~report.flux_exhausted) & (~report.greenwald_violated)
    return OptimalShotResult(knobs=k_final, q_flattop=report.q_flattop,
                             loss_history=jnp.asarray(losses),
                             feasible=feasible)
