"""QLKNN-class neural-turbulence feature pipeline and training lane.

Covers the reference's ``core/neural_turbulence.py``: banana-regime
electron collisionality (``electron_collisionality_star:28``), the
profile -> 10-feature QLKNN normalizer
(``TransportInputNormalizer.from_profiles:205``), the synthetic
parameter-scan + Jenko critical-gradient analytic target generator
(``TrainingDataGenerator:274-359``), and the features -> fluxes
transport wrapper (``QLKNNTransportModel:467``).

JAX-native design: every stage is pure jnp — the per-sample Python loop
in the reference's target generator (``:323-358``) is one vectorised
expression; training rides the repo's shared MLP backbone
(``models/surrogates/mlp.py``: pytree params, whole fit as one
``lax.scan``); the feature normalizer uses the non-uniform second-order
gradient so it vmaps over profile batches.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.models.surrogates.mlp import (
    MLPParams,
    init_mlp,
    mlp_apply,
    train_mlp,
)

E_CHARGE = 1.602176634e-19
M_ELECTRON = 9.1093837015e-31
EPS0 = 8.8541878128e-12
LN_LAMBDA = 17.0
MU0 = 4.0e-7 * np.pi

# Uniform sampling bounds of the 10D QLKNN space (reference ``:281-295``):
# [R/L_Ti, R/L_Te, R/L_ne, q, s_hat, alpha_MHD, Ti/Te, nu*, Z_eff, eps]
FEATURE_BOUNDS = np.array([
    [0.0, 15.0], [0.0, 15.0], [-5.0, 10.0], [0.5, 5.0], [-1.0, 3.0],
    [0.0, 2.0], [0.1, 2.0], [1e-3, 1.0], [1.0, 3.0], [0.01, 0.3]])


def _grad_nonuniform(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Second-order gradient on a non-uniform strictly increasing grid."""
    h_l = x[1:-1] - x[:-2]
    h_r = x[2:] - x[1:-1]
    interior = (h_l**2 * y[2:] - h_r**2 * y[:-2]
                + (h_r**2 - h_l**2) * y[1:-1]) / (h_l * h_r * (h_l + h_r))
    first = (y[1] - y[0]) / (x[1] - x[0])
    last = (y[-1] - y[-2]) / (x[-1] - x[-2])
    return jnp.concatenate([first[None], interior, last[None]])


def electron_collisionality_star(ne_19, te_kev, q, r0: float, epsilon,
                                 z_eff=1.5) -> jnp.ndarray:
    """Banana-regime electron collisionality ``nu* = nu_ee q R0 /
    (eps^1.5 v_the)`` (reference ``:28-64``)."""
    if r0 <= 0.0 or not np.isfinite(r0):
        raise ValueError("R0 must be finite and positive")
    ne_m3 = jnp.asarray(ne_19) * 1e19
    te_j = jnp.maximum(jnp.asarray(te_kev), 1e-3) * 1e3 * E_CHARGE
    v_the = jnp.sqrt(2.0 * te_j / M_ELECTRON)
    nu_ee = (ne_m3 * jnp.maximum(jnp.asarray(z_eff), 1.0) * E_CHARGE**4
             * LN_LAMBDA
             / (12.0 * jnp.pi**1.5 * EPS0**2 * jnp.sqrt(M_ELECTRON)
                * te_j**1.5))
    nu_star = nu_ee * jnp.asarray(q) * r0 / (
        jnp.maximum(jnp.asarray(epsilon), 1e-4) ** 1.5 * v_the)
    return jnp.maximum(nu_star, 0.0)


def qlknn_features_from_profiles(te, ti, ne, q, r, *, r0: float, a: float,
                                 b0: float) -> jnp.ndarray:
    """Physical profiles -> (N, 10) dimensionless QLKNN inputs
    (reference ``from_profiles:205-272``)."""
    r = jnp.asarray(r)
    if r.ndim != 1 or r.shape[0] < 2:
        raise ValueError("r profile must be 1D with at least two points")
    if r0 <= 0.0 or a <= 0.0 or b0 <= 0.0:
        raise ValueError("R0, a, and B0 must be positive")
    te, ti, ne, q = (jnp.asarray(v) for v in (te, ti, ne, q))
    for name, v in (("Te", te), ("Ti", ti), ("ne", ne), ("q", q)):
        if v.shape != r.shape:
            raise ValueError(
                "Te, Ti, ne, q, and r profiles must have the same shape")

    grad_te = _grad_nonuniform(te, r)
    grad_ti = _grad_nonuniform(ti, r)
    grad_ne = _grad_nonuniform(ne, r)
    grad_q = _grad_nonuniform(q, r)

    r_l_ti = -r0 / jnp.maximum(ti, 1e-3) * grad_ti
    r_l_te = -r0 / jnp.maximum(te, 1e-3) * grad_te
    r_l_ne = -r0 / jnp.maximum(ne, 1e-3) * grad_ne
    s_hat = r / jnp.maximum(q, 1e-3) * grad_q
    p = 2.0 * ne * 1e19 * te * 1e3 * E_CHARGE
    alpha_mhd = -(q**2) * r0 * _grad_nonuniform(p, r) * 2.0 * MU0 / b0**2
    ti_te = ti / jnp.maximum(te, 1e-3)
    epsilon = r / r0
    z_eff = jnp.full_like(r, 1.5)
    nu_star = electron_collisionality_star(ne, te, q, r0, epsilon, z_eff)
    return jnp.stack([r_l_ti, r_l_te, r_l_ne, q, s_hat, alpha_mhd, ti_te,
                      nu_star, z_eff, epsilon], axis=1)


def generate_parameter_scan(key: jax.Array, n_samples: int) -> jnp.ndarray:
    """Uniform random sampling of the 10D QLKNN space (reference ``:278``)."""
    lo = jnp.asarray(FEATURE_BOUNDS[:, 0], jnp.float32)
    hi = jnp.asarray(FEATURE_BOUNDS[:, 1], jnp.float32)
    u = jax.random.uniform(key, (n_samples, 10), jnp.float32)
    return lo + u * (hi - lo)


def analytic_targets(inputs: jnp.ndarray) -> jnp.ndarray:
    """Jenko critical-gradient quasilinear targets ``[Q_i, Q_e, Gamma_e]``
    in gyro-Bohm units, fully vectorised (reference ``:306-359``)."""
    x = jnp.asarray(inputs)
    if x.ndim != 2 or x.shape[1] != 10:
        raise ValueError("inputs must have shape (n_samples, 10)")
    r_l_ti, ti_te = x[:, 0], x[:, 6]
    r_l_ne, q = x[:, 2], x[:, 3]
    s_hat, eps, nu_star = x[:, 4], x[:, 9], x[:, 7]

    crit = ((1.0 + ti_te) * jnp.maximum(1.33 + 1.91 * s_hat / q, 0.0)
            * (1.0 - 1.5 * eps))
    crit = jnp.maximum(crit, 0.0)
    q_i = jnp.where(r_l_ti > crit, 5.0 * jnp.maximum(r_l_ti - crit, 0.0) ** 1.5,
                    0.0)
    drive = r_l_ne - 2.0
    tem_damping = 1.0 / jnp.sqrt(1.0 + jnp.maximum(nu_star, 0.0))
    q_e = jnp.where(drive > 0.0, 2.0 * drive * tem_damping, 0.0)
    gamma_e = jnp.where(drive > 0.0, drive * tem_damping, 0.0)
    return jnp.stack([q_i, q_e, gamma_e], axis=1)


class QLKNNModel(NamedTuple):
    """Trained surrogate + input standardisation (pytree)."""

    params: MLPParams
    x_mean: jnp.ndarray
    x_std: jnp.ndarray
    y_scale: jnp.ndarray


def train_qlknn(key: jax.Array, *, n_samples: int = 8192,
                hidden: tuple[int, ...] = (64, 64),
                n_steps: int = 3000, lr: float = 1e-3) -> QLKNNModel:
    """Distil the analytic quasilinear closure into an MLP — the same
    teacher-student path as the reference trainer (``:362-456``), but the
    whole fit is one compiled scan."""
    k_data, k_init, k_train = jax.random.split(key, 3)
    x = generate_parameter_scan(k_data, n_samples)
    y = analytic_targets(x)
    x_mean, x_std = jnp.mean(x, 0), jnp.maximum(jnp.std(x, 0), 1e-6)
    y_scale = jnp.maximum(jnp.std(y, 0), 1e-6)
    params = init_mlp(k_init, (10, *hidden, 3))
    result = train_mlp(params, (x - x_mean) / x_std, y / y_scale, k_train,
                       n_steps=n_steps, lr=lr)
    return QLKNNModel(params=result.params, x_mean=x_mean, x_std=x_std,
                      y_scale=y_scale)


@jax.jit
def predict_fluxes(model: QLKNNModel, features: jnp.ndarray) -> jnp.ndarray:
    """(N, 10) features -> (N, 3) non-negative GB fluxes
    (reference ``QLKNNTransportModel.predict:467``)."""
    z = (jnp.asarray(features) - model.x_mean) / model.x_std
    return jnp.maximum(mlp_apply(model.params, z) * model.y_scale, 0.0)


def fluxes_from_profiles(model: QLKNNModel, te, ti, ne, q, r, *,
                         r0: float, a: float, b0: float) -> jnp.ndarray:
    """End-to-end: profiles -> features -> GB fluxes."""
    feats = qlknn_features_from_profiles(te, ti, ne, q, r, r0=r0, a=a, b0=b0)
    return predict_fluxes(model, feats)
