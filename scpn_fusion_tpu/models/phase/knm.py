"""Plasma-layer coupling matrices (Knm) + adaptive online tuning.

JAX-native equivalent of the reference Knm stack (``phase/knm.py:52-80``,
``phase/plasma_knm.py:112-380``, ``phase/adaptive_knm.py:39-160``): the
8-layer plasma process hierarchy (micro-turbulence ... plasma-wall
interaction) with a distance-decay coupling backbone, literature-motivated
pair overlays, instability-mode biases, and a diagnostic-driven adaptive
engine (beta scaling, disruption-risk pair boosts, per-layer coherence PI,
rate limiting, guard-veto revert).

Matrix construction is host-side NumPy (static configuration); the
adaptive update is a pure jnp function over an explicit state so it can
live inside a jitted control loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax.numpy as jnp
import numpy as np

PLASMA_LAYER_NAMES = (
    "micro_turbulence", "zonal_flows", "mhd_tearing", "sawtooth_elm",
    "transport_barrier", "current_profile", "global_equilibrium",
    "plasma_wall",
)

# Natural frequencies per layer (fast -> slow), reference
# ``plasma_knm.py:112-124``.
OMEGA_PLASMA_8 = np.array([8.50, 5.20, 4.80, 3.10, 2.40, 0.85, 0.72, 0.18])

_VALID_MODES = frozenset({"baseline", "elm", "ntm", "sawtooth", "hybrid"})


@dataclasses.dataclass(frozen=True)
class KnmSpec:
    """Coupling spec: K[n, m] = source n -> target m; optional lags/driver."""

    k: np.ndarray
    alpha: Optional[np.ndarray] = None
    zeta: Optional[np.ndarray] = None
    layer_names: Optional[Sequence[str]] = None

    def __post_init__(self):
        k = np.asarray(self.k, dtype=np.float64)
        if k.ndim != 2 or k.shape[0] != k.shape[1]:
            raise ValueError("K must be square (L, L)")
        n = k.shape[0]
        if self.alpha is not None and np.shape(self.alpha) != (n, n):
            raise ValueError(f"alpha shape {np.shape(self.alpha)} != ({n},{n})")
        if self.zeta is not None and np.shape(self.zeta) != (n,):
            raise ValueError(f"zeta shape {np.shape(self.zeta)} != ({n},)")

    @property
    def n_layers(self) -> int:
        return np.asarray(self.k).shape[0]

    def arrays(self, dtype=jnp.float32):
        """(K, alpha, zeta) as device arrays with zero defaults."""
        n = self.n_layers
        k = jnp.asarray(self.k, dtype)
        alpha = jnp.asarray(self.alpha if self.alpha is not None
                            else np.zeros((n, n)), dtype)
        zeta = jnp.asarray(self.zeta if self.zeta is not None
                           else np.zeros(n), dtype)
        return k, alpha, zeta


def plasma_omega(n_layers: int = 8) -> np.ndarray:
    """Layer natural frequencies: table for L<=8, log-interp beyond."""
    if n_layers <= 8:
        return OMEGA_PLASMA_8[:n_layers].copy()
    return np.logspace(np.log10(OMEGA_PLASMA_8[0]),
                       np.log10(OMEGA_PLASMA_8[-1]), num=n_layers)


def build_knm_plasma(mode: str = "baseline", n_layers: int = 8,
                     k_base: float = 0.30, zeta_uniform: float = 0.0,
                     custom_overrides: Optional[dict] = None) -> KnmSpec:
    """Distance-decay backbone + physics pair overlays + mode bias
    (reference ``build_knm_plasma``)."""
    if mode not in _VALID_MODES:
        raise ValueError(f"unknown plasma mode {mode!r}")
    idx = np.arange(n_layers)
    k = k_base * np.exp(-0.5 * np.abs(idx[:, None] - idx[None, :]))

    if n_layers >= 8:
        s = n_layers // 8
        pairs = {   # literature-motivated couplings (see module docstring)
            (0, 1): 0.42,   # drift-wave <-> zonal flow predator-prey
            (1, 4): 0.28,   # ExB shear suppression of transport
            (2, 5): 0.35,   # NTM <-> bootstrap current
            (3, 5): 0.30,   # sawtooth <-> current redistribution
            (3, 4): 0.32,   # ELM crash depletes pedestal
            (4, 6): 0.25,   # transport <-> equilibrium
            (7, 4): 0.20,   # PWI <-> edge transport
            (7, 6): 0.15,   # wall conditioning <-> equilibrium
        }
        for (i, j), val in pairs.items():
            k[i * s, j * s] = k[j * s, i * s] = val

        if mode == "elm":
            k[3 * s, 4 * s] *= 1.8
            k[4 * s, 3 * s] *= 1.8
            k[3 * s, 7 * s] = max(k[3 * s, 7 * s], 0.22)
            k[7 * s, 3 * s] = max(k[7 * s, 3 * s], 0.22)
        elif mode == "ntm":
            k[2 * s, 5 * s] *= 1.6
            k[5 * s, 2 * s] *= 1.6
            k[2 * s, 4 * s] = max(k[2 * s, 4 * s], 0.25)
            k[4 * s, 2 * s] = max(k[4 * s, 2 * s], 0.25)
        elif mode == "sawtooth":
            k[3 * s, 5 * s] *= 1.7
            k[5 * s, 3 * s] *= 1.7
            k[3 * s, 0 * s] = max(k[3 * s, 0 * s], 0.18)
            k[0 * s, 3 * s] = max(k[0 * s, 3 * s], 0.18)
        elif mode == "hybrid":
            k *= 1.15

    if custom_overrides:
        for (i, j), val in custom_overrides.items():
            if not (0 <= i < n_layers and 0 <= j < n_layers):
                raise IndexError(f"override ({i},{j}) out of range L={n_layers}")
            k[i, j] = k[j, i] = val

    k = np.maximum(0.5 * (k + k.T), 0.0)
    zeta = (np.full(n_layers, zeta_uniform) if zeta_uniform != 0.0 else None)
    return KnmSpec(k=k, zeta=zeta,
                   layer_names=PLASMA_LAYER_NAMES[:min(n_layers, 8)])


def build_knm_plasma_from_config(r0: float, a: float, b0: float, ip_ma: float,
                                 n_e_19: float, *, mode: str = "baseline",
                                 n_layers: int = 8,
                                 zeta_uniform: float = 0.0) -> KnmSpec:
    """Machine-scaled backbone: K_base = 0.30 (1 + 0.5 beta_proxy),
    beta_proxy = n_e a / B0^2."""
    beta_proxy = n_e_19 * a / max(b0**2, 1e-9)
    return build_knm_plasma(mode=mode, n_layers=n_layers,
                            k_base=0.30 * (1.0 + 0.5 * beta_proxy),
                            zeta_uniform=zeta_uniform)


# ---------------------------------------------------------------------------
# Adaptive Knm engine (functional state; jit-compatible update)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdaptiveKnmConfig:
    beta_scale: float = 0.3
    beta_max_boost: float = 0.5
    risk_pairs: tuple = ((2, 5), (3, 5), (2, 4))
    risk_gain: float = 0.4
    coherence_kp: float = 0.15
    coherence_ki: float = 0.02
    coherence_r_target: float = 0.6
    coherence_max_boost: float = 0.3
    max_delta_per_tick: float = 0.02
    revert_on_guard_refusal: bool = True


class AdaptiveKnmState(NamedTuple):
    k_current: jnp.ndarray
    k_last_good: jnp.ndarray
    integral: jnp.ndarray      # (L,) coherence PI integrator


def init_adaptive_state(spec: KnmSpec, dtype=jnp.float32) -> AdaptiveKnmState:
    k = jnp.asarray(spec.k, dtype)
    return AdaptiveKnmState(k, k, jnp.zeros(spec.n_layers, dtype))


def adaptive_knm_update(
    cfg: AdaptiveKnmConfig,
    baseline_k: jnp.ndarray,
    state: AdaptiveKnmState,
    *,
    r_layer: jnp.ndarray,
    beta_n,
    disruption_risk,
    guard_approved,
) -> AdaptiveKnmState:
    """One adaptation tick (reference ``AdaptiveKnmEngine.update``), pure.

    Channels: beta matrix scaling, risk-pair boosts, per-layer coherence
    PI on the diagonal; invariants (symmetry, K>=0) and per-tick rate
    limit; guard refusal reverts to the last approved matrix.
    """
    n = baseline_k.shape[0]
    beta_boost = jnp.minimum(cfg.beta_scale * beta_n, cfg.beta_max_boost)
    k_new = baseline_k * (1.0 + beta_boost)

    delta = cfg.risk_gain * disruption_risk
    for i, j in cfg.risk_pairs:
        if i < n and j < n:
            k_new = k_new.at[i, j].add(delta).at[j, i].add(delta)

    error = cfg.coherence_r_target - r_layer[:n]
    integral = jnp.clip(state.integral + cfg.coherence_ki * error,
                        0.0, cfg.coherence_max_boost)
    diag_boost = jnp.minimum(
        cfg.coherence_kp * jnp.maximum(error, 0.0) + integral,
        cfg.coherence_max_boost)
    k_new = k_new + jnp.diag(diag_boost)

    k_new = jnp.maximum(0.5 * (k_new + k_new.T), 0.0)
    dk = jnp.clip(k_new - state.k_current,
                  -cfg.max_delta_per_tick, cfg.max_delta_per_tick)
    k_new = jnp.maximum(0.5 * ((state.k_current + dk)
                               + (state.k_current + dk).T), 0.0)

    adapted = AdaptiveKnmState(k_new, k_new, integral)
    if not cfg.revert_on_guard_refusal:
        return adapted
    reverted = AdaptiveKnmState(state.k_last_good, state.k_last_good,
                                jnp.zeros_like(state.integral))
    approved = jnp.asarray(guard_approved)
    return AdaptiveKnmState(
        jnp.where(approved, adapted.k_current, reverted.k_current),
        jnp.where(approved, adapted.k_last_good, reverted.k_last_good),
        jnp.where(approved, adapted.integral, reverted.integral))
