"""Multi-regime FNO training data: one-step spectral evolution pairs.

Covers the reference's ``core/fno_training_multi_regime.py``: training
pairs that span the SPARC ITG / TEM / ETG turbulence regimes, each
sample drawn from a regime-specific parameter box (drive ``alpha``,
gradient ``kappa``, viscosity ``nu``, damping, spectral cutoff) and
evolved one step under the modified Hasegawa-Wakatani dispersion
(``omega = alpha k_y / (alpha + k^2)``, growth
``gamma = kappa k_y k^2/(alpha+k^2)^2 - nu k^4``) with low-k forcing
(reference ``_generate_multi_regime_pairs:61-152``).

JAX-native design: the reference builds samples one at a time in a
Python loop over ``np.fft`` calls; here parameters are sampled for the
whole batch at once and ALL pairs are generated in one vmapped
spectral program (batched ``fft2``/``ifft2``).  The trained operator
rides the repo's shared FNO backbone (``models/surrogates/fno.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Regime parameter boxes (reference ``SPARC_REGIMES``, ``:25-50``):
# (alpha, kappa, nu, damp, k_cut) bounds per regime.
SPARC_REGIMES = {
    "itg": {"alpha": (0.5, 2.0), "kappa": (0.5, 3.0), "nu": (0.005, 0.05),
            "damp": (0.05, 0.15), "k_cut": (4.0, 8.0)},
    "tem": {"alpha": (1.0, 2.5), "kappa": (1.5, 6.0), "nu": (0.01, 0.08),
            "damp": (0.10, 0.20), "k_cut": (6.0, 12.0)},
    "etg": {"alpha": (1.0, 3.0), "kappa": (3.0, 12.0), "nu": (0.01, 0.1),
            "damp": (0.15, 0.30), "k_cut": (10.0, 20.0)},
}
REGIME_NAMES = tuple(SPARC_REGIMES.keys())
_PARAM_KEYS = ("alpha", "kappa", "nu", "damp", "k_cut")


def sample_regime_params(key: jax.Array, regime_idx: jnp.ndarray
                         ) -> dict[str, jnp.ndarray]:
    """Sample per-sample parameter vectors given regime indices (batched)."""
    lo = jnp.asarray([[SPARC_REGIMES[r][k][0] for k in _PARAM_KEYS]
                      for r in REGIME_NAMES])
    hi = jnp.asarray([[SPARC_REGIMES[r][k][1] for k in _PARAM_KEYS]
                      for r in REGIME_NAMES])
    n = regime_idx.shape[0]
    u = jax.random.uniform(key, (n, len(_PARAM_KEYS)))
    vals = lo[regime_idx] + u * (hi[regime_idx] - lo[regime_idx])
    return {k: vals[:, i] for i, k in enumerate(_PARAM_KEYS)}


@partial(jax.jit, static_argnames=("n_samples", "grid_size"))
def generate_multi_regime_pairs(
    key: jax.Array,
    *,
    n_samples: int,
    grid_size: int,
    regime_probs: tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3),
    dt: float = 0.01,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Return ``(x, y, regime_idx)`` with ``x, y`` of shape
    ``(n_samples, grid, grid)`` — the full batch in one fused program."""
    k_reg, k_par, k_field, k_fr, k_fi = jax.random.split(key, 5)
    probs = jnp.asarray(regime_probs) / sum(regime_probs)
    regime_idx = jax.random.choice(k_reg, len(REGIME_NAMES),
                                   (n_samples,), p=probs)
    params = sample_regime_params(k_par, regime_idx)
    alpha = params["alpha"][:, None, None]
    kappa = params["kappa"][:, None, None]
    nu = params["nu"][:, None, None]
    damp = params["damp"][:, None, None]
    k_cut = params["k_cut"][:, None, None]

    k1 = jnp.fft.fftfreq(grid_size) * grid_size
    kx, ky = jnp.meshgrid(k1, k1)
    k2 = (kx**2 + ky**2)[None, :, :]
    k4 = k2**2
    k2_safe = k2.at[:, 0, 0].set(1.0)

    denom = alpha + k2_safe
    omega = alpha * ky[None] / denom
    growth = kappa * ky[None] * k2 / denom**2 - nu * k4
    spectral_filter = jnp.exp(-((k2 / k_cut**2) ** 2))
    phase_shift = jnp.exp(-1j * omega * dt)
    amplitude = jnp.exp(growth * dt) * spectral_filter * (1.0 - damp)
    mask_low_k = (k2 < (k_cut * 0.5) ** 2).astype(spectral_filter.dtype)

    field = 0.1 * jax.random.normal(k_field, (n_samples, grid_size, grid_size))
    field_k = jnp.fft.fft2(field) * spectral_filter

    forcing = (jax.random.normal(k_fr, (n_samples, grid_size, grid_size))
               + 1j * jax.random.normal(k_fi, (n_samples, grid_size,
                                               grid_size)))
    forcing_k = jnp.fft.fft2(forcing) * mask_low_k * kappa * 0.5

    next_k = field_k * phase_shift * amplitude + forcing_k * dt
    x = jnp.fft.ifft2(field_k).real
    y = jnp.fft.ifft2(next_k).real
    return x, y, regime_idx


def train_fno_multi_regime(
    key: jax.Array,
    *,
    n_samples: int = 256,
    grid_size: int = 32,
    modes: int = 8,
    width: int = 16,
    n_layers: int = 3,
    n_steps: int = 600,
    lr: float = 2e-3,
):
    """Train the shared FNO backbone on multi-regime one-step pairs
    (reference ``train_fno_multi_regime:154``).  Returns
    ``(params, val_rel_l2, regime_idx)``."""
    from scpn_fusion_tpu.models.surrogates.fno import (
        fno_apply_batched,
        init_fno,
        train_fno,
    )

    k_data, k_val, k_init, k_train = jax.random.split(key, 4)
    x, y, regime_idx = generate_multi_regime_pairs(
        k_data, n_samples=n_samples, grid_size=grid_size)
    scale = jnp.maximum(jnp.std(y), 1e-9)
    x_b = (x / scale)[..., None].astype(jnp.float32)
    y_b = (y / scale)[..., None].astype(jnp.float32)

    params = init_fno(k_init, width=width, modes=modes, n_layers=n_layers)
    result = train_fno(params, x_b, y_b, k_train, n_steps=n_steps, lr=lr)

    xv, yv, _ = generate_multi_regime_pairs(
        k_val, n_samples=max(n_samples // 4, 8), grid_size=grid_size)
    pred = fno_apply_batched(result.params,
                             (xv / scale)[..., None].astype(jnp.float32))
    yv_b = (yv / scale)[..., None].astype(jnp.float32)
    num = jnp.sqrt(jnp.sum((pred - yv_b) ** 2, axis=(1, 2, 3)))
    den = jnp.maximum(jnp.sqrt(jnp.sum(yv_b**2, axis=(1, 2, 3))), 1e-12)
    return result.params, float(jnp.mean(num / den)), regime_idx
