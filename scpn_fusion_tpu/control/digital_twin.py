"""Tokamak digital twin: MRE islands + 2D transport + control, one scan.

JAX-native port of the reference's
``control/tokamak_digital_twin.py:47-370``: a poloidal-cross-section
twin where a Modified-Rutherford-Equation island model modulates a 2D
diffusion-reaction temperature field, a current-drive action reshapes
the q-profile, and the closed loop trains/evaluates controllers against
confinement degradation at rational surfaces.

The reference steps the twin in a Python loop over mutable objects; here
the twin state is a pytree and the WHOLE shot — q-profile update, MRE
island evolution, danger-map rasterisation, 2D diffusion stencil,
control — runs as one ``lax.scan`` under jit.  IDS export reuses the
IMAS-lite tree (reference ``run_digital_twin_ids`` role).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

RESONANCES = (1.5, 2.0, 2.5, 3.0)


@dataclasses.dataclass(frozen=True)
class TwinConfig:
    """Twin knobs (reference defaults :47-160)."""

    grid_size: int = 48
    q0: float = 1.0
    qa: float = 3.0
    eta: float = 1e-5          # resistive MRE timescale
    beta_p: float = 0.6
    w_crit: float = 0.05
    d_base: float = 0.01
    d_turb: float = 0.5
    core_heat: float = 5.0
    dt_island: float = 0.1
    edge_sink: float = 0.05


class TwinState(NamedTuple):
    t_field: jnp.ndarray        # (N, N) temperature
    island_widths: jnp.ndarray  # (len(RESONANCES),)


class TwinTrace(NamedTuple):
    t_core: jnp.ndarray         # (n_steps,)
    island_widths: jnp.ndarray  # (n_steps, n_res)
    danger_fraction: jnp.ndarray


def _geometry(cfg: TwinConfig, dtype=jnp.float32):
    n = cfg.grid_size
    half = n / 2.0
    ax = jnp.arange(n, dtype=dtype) - half
    r_map = jnp.sqrt(ax[None, :] ** 2 + ax[:, None] ** 2) / half
    mask = r_map <= 1.0
    return r_map, mask


def twin_init(cfg: TwinConfig, dtype=jnp.float32) -> TwinState:
    n = cfg.grid_size
    return TwinState(
        t_field=jnp.zeros((n, n), dtype),
        island_widths=jnp.full((len(RESONANCES),), 0.01, dtype))


def q_map(cfg: TwinConfig, r_map: jnp.ndarray, action) -> jnp.ndarray:
    """Parabolic q(r) with current-drive modulation (reference :75-79)."""
    q0 = cfg.q0 - 0.2 * action
    qa = cfg.qa + 0.5 * action
    return q0 + (qa - q0) * r_map**2


def mre_step(cfg: TwinConfig, widths: jnp.ndarray) -> jnp.ndarray:
    """Modified Rutherford Equation with neoclassical bootstrap drive:
    dw/dt = eta (Delta'(w) + beta_p w / (w^2 + w_crit^2))."""
    delta_prime = -0.2 - 5.0 * widths
    f_bs = cfg.beta_p * widths / (widths**2 + cfg.w_crit**2)
    return jnp.maximum(widths + cfg.dt_island * cfg.eta
                       * (delta_prime + f_bs), 1e-3)


def danger_map(cfg: TwinConfig, qm: jnp.ndarray, mask: jnp.ndarray,
               widths: jnp.ndarray) -> jnp.ndarray:
    """Boolean island map: |q - m/n| < w at each rational surface."""
    res = jnp.asarray(RESONANCES, qm.dtype)
    hit = jnp.any(jnp.abs(qm[None, :, :] - res[:, None, None])
                  < widths[:, None, None], axis=0)
    return hit & mask


def twin_step(cfg: TwinConfig, r_map, mask, state: TwinState, action):
    """One twin tick (reference ``Plasma2D.step`` :105-160)."""
    qm = q_map(cfg, r_map, action)
    widths = mre_step(cfg, state.island_widths)
    danger = danger_map(cfg, qm, mask, widths)

    n = cfg.grid_size
    t = state.t_field.at[n // 2, n // 2].add(cfg.core_heat)
    diffusivity = jnp.where(danger, cfg.d_turb, cfg.d_base)
    lap = (jnp.roll(t, 1, 0) + jnp.roll(t, -1, 0)
           + jnp.roll(t, 1, 1) + jnp.roll(t, -1, 1) - 4.0 * t)
    t = t + diffusivity * lap - cfg.edge_sink * t * (~mask)
    t = jnp.where(mask, jnp.maximum(t, 0.0), 0.0)

    new_state = TwinState(t_field=t, island_widths=widths)
    core = t[n // 2, n // 2]
    frac = jnp.mean(danger.astype(t.dtype))
    return new_state, (core, widths, frac)


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run_digital_twin(
    cfg: TwinConfig = TwinConfig(),
    *,
    n_steps: int = 200,
    actions: jnp.ndarray | None = None,
    dtype=jnp.float32,
) -> tuple[TwinState, TwinTrace]:
    """Whole twin shot under one scan.  ``actions`` is a per-step
    current-drive trace in [-1, 1] (zeros = uncontrolled)."""
    r_map, mask = _geometry(cfg, dtype)
    if actions is None:
        actions = jnp.zeros((n_steps,), dtype)

    def step(state, action):
        return twin_step(cfg, r_map, mask, state, action)

    state0 = twin_init(cfg, dtype)
    final, (core, widths, frac) = jax.lax.scan(step, state0, actions)
    return final, TwinTrace(t_core=core, island_widths=widths,
                            danger_fraction=frac)


def avoidance_action_trace(cfg: TwinConfig, n_steps: int,
                           gain: float = 1.0,
                           dtype=jnp.float32) -> jnp.ndarray:
    """Simple island-avoidance schedule: drive current to push the
    q-profile span away from the dominant low-order rational surfaces
    (the role the reference's tiny policy net learns online)."""
    return jnp.full((n_steps,), jnp.clip(gain, -1.0, 1.0), dtype)


def twin_to_ids(state: TwinState, cfg: TwinConfig,
                *, time_s: float = 0.0) -> dict:
    """Snapshot -> IMAS-lite IDS tree (reference
    ``run_digital_twin_ids`` :370-420 role)."""
    t = np.asarray(state.t_field)
    return {
        "ids_properties": {"homogeneous_time": 1,
                           "comment": "scpn-fusion-tpu digital twin"},
        "time": [float(time_s)],
        "summary": {
            "t_core": float(t[cfg.grid_size // 2, cfg.grid_size // 2]),
            "t_mean": float(t.mean()),
            "island_widths": {
                f"q_{res}": float(w) for res, w in
                zip(RESONANCES, np.asarray(state.island_widths))},
        },
        "profiles_2d": [{"temperature": t.tolist(),
                         "grid_type": {"index": 1,
                                       "name": "rectangular"}}],
    }
