"""HEAT-ML magnetic-shadow divertor surrogate (GAI-03 lane).

Covers the reference's ``core/heat_ml_shadow_surrogate.py``: a
deterministic ridge-fit polynomial surrogate for the divertor
magnetic-shadow fraction, with a synthetic reference law for dataset
generation, shadow->heat-flux attenuation, and an RMSE% quality metric.

JAX-native design: the model is a *functional* weights vector (a
pytree leaf) rather than a mutable class — ``fit`` returns weights,
``predict`` is a pure jitted function of ``(weights, features)``, so
the surrogate composes with ``vmap``/``grad`` and can sit inside other
jitted programs (e.g. the divertor-lab heat-load loop).  The ridge
normal equations solve via Cholesky on-device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

N_FEATURES = 7


class ShadowDataset(NamedTuple):
    features: jnp.ndarray        # (N, 7)
    shadow_fraction: jnp.ndarray  # (N,)


def _as_2d(features) -> jnp.ndarray:
    x = jnp.asarray(features)
    if x.ndim == 1:
        x = x[None, :]
    if x.shape[1] != N_FEATURES:
        raise ValueError(
            "Expected shape (N, 7): [R, B_pol, P_sol, fx, kappa, delta, xpt_z]")
    return x


def synthetic_shadow_reference(features) -> jnp.ndarray:
    """Synthetic reference law for the divertor magnetic-shadow fraction
    (reference ``synthetic_shadow_reference:38-50``)."""
    x = _as_2d(features)
    r, b_pol, p_sol, fx, kappa, delta, xpt_z = [x[:, i] for i in range(7)]
    field_term = 0.20 + 0.24 * jnp.tanh(0.65 * (b_pol - 1.3))
    geometry_term = (0.16 * jnp.tanh(0.20 * (fx - 10.0))
                     + 0.10 * jnp.tanh(1.1 * (kappa - 1.5)))
    xpt_term = 0.08 * jnp.exp(-((xpt_z + 1.7) ** 2) / 0.28)
    power_penalty = 0.18 * jnp.tanh(0.020 * (p_sol - 70.0))
    shaping_bonus = 0.06 * delta
    shadow = (field_term + geometry_term + xpt_term + shaping_bonus
              - power_penalty)
    return jnp.clip(shadow, 0.03, 0.82)


def generate_shadow_dataset(seed: int, samples: int) -> ShadowDataset:
    """Deterministic synthetic training dataset (reference ``:53-66``)."""
    if samples < 8:
        raise ValueError("samples must be >= 8")
    rng = np.random.default_rng(seed)
    feats = np.column_stack([
        rng.uniform(1.0, 3.5, samples),
        rng.uniform(0.8, 3.8, samples),
        rng.uniform(20.0, 180.0, samples),
        rng.uniform(6.0, 24.0, samples),
        rng.uniform(1.2, 2.2, samples),
        rng.uniform(0.05, 0.65, samples),
        rng.uniform(-2.6, -1.1, samples),
    ])
    feats = jnp.asarray(feats)
    return ShadowDataset(features=feats,
                         shadow_fraction=synthetic_shadow_reference(feats))


def _feature_map(features) -> jnp.ndarray:
    """Compact polynomial basis (reference ``_feature_map:76-92``)."""
    x = _as_2d(features)
    r, b_pol, p_sol, fx, kappa, delta, xpt_z = [x[:, i] for i in range(7)]
    return jnp.column_stack([
        jnp.ones(x.shape[0], x.dtype),
        x,
        b_pol * fx,
        p_sol / jnp.maximum(fx, 1e-6),
        kappa * delta,
        jnp.exp(-((xpt_z + 1.7) ** 2) / 0.30),
        jnp.tanh(0.02 * (p_sol - 70.0)),
        jnp.tanh(0.20 * (fx - 10.0)),
        jnp.tanh(0.65 * (b_pol - 1.3)),
    ])


def fit_shadow_surrogate(features, target, ridge: float = 1e-4) -> jnp.ndarray:
    """Ridge-regularised weights via Cholesky normal equations
    (reference ``fit:94-102``).  Returns the weights vector."""
    ridge = max(float(ridge), 1e-10)
    phi = _feature_map(features)
    y = jnp.asarray(target).reshape(-1)
    if y.shape[0] != phi.shape[0]:
        raise ValueError("features and target row count mismatch")
    lhs = phi.T @ phi + ridge * jnp.eye(phi.shape[1], dtype=phi.dtype)
    rhs = phi.T @ y
    factor = jax.scipy.linalg.cho_factor(lhs)
    return jax.scipy.linalg.cho_solve(factor, rhs)


def fit_synthetic(seed: int = 42, samples: int = 2048,
                  ridge: float = 1e-4) -> jnp.ndarray:
    ds = generate_shadow_dataset(seed=seed, samples=samples)
    return fit_shadow_surrogate(ds.features, ds.shadow_fraction, ridge)


@jax.jit
def predict_shadow_fraction(weights: jnp.ndarray, features) -> jnp.ndarray:
    """Clipped shadow-fraction prediction (reference ``:109-115``)."""
    return jnp.clip(_feature_map(features) @ weights, 0.0, 0.85)


@jax.jit
def predict_divertor_flux(weights: jnp.ndarray, q_div_baseline_w_m2,
                          features) -> jnp.ndarray:
    """Shadow-attenuated divertor heat flux, ``q (1 - 0.58 s)``
    (reference ``predict_divertor_flux:117-127``)."""
    shadow = predict_shadow_fraction(weights, features)
    return jnp.maximum(jnp.asarray(q_div_baseline_w_m2) * (1.0 - 0.58 * shadow),
                       1e-6)


def rmse_percent(y_true, y_pred) -> float:
    """RMSE as % of mean |reference| (reference ``rmse_percent:130-138``)."""
    yt = np.asarray(y_true, np.float64).reshape(-1)
    yp = np.asarray(y_pred, np.float64).reshape(-1)
    if yt.size == 0 or yt.shape != yp.shape:
        raise ValueError("y_true/y_pred must be non-empty and same shape")
    rmse = float(np.sqrt(np.mean((yt - yp) ** 2)))
    return 100.0 * rmse / float(max(np.mean(np.abs(yt)), 1e-9))
