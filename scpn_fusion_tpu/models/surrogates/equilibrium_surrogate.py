"""Neural equilibrium surrogate: O(1) psi prediction from scalar inputs.

Reference lane: ``core/neural_equilibrium.py:135-258`` (SimpleMLP +
MinimalPCA, 1.05 ms inference) and ``core/neural_equilibrium_kernel.py``
(the O(1) surrogate used by the HPC bridge).  accelerator-first twist: the training
data is generated by this framework's own compiled free-boundary solver —
sampling coil currents, solving in a vmapped batch, fitting PCA + MLP —
so the entire generate->reduce->train pipeline runs on device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.models.surrogates.mlp import (
    MLPParams,
    init_mlp,
    mlp_apply,
    train_mlp,
)


class EquilibriumSurrogate(NamedTuple):
    """PCA basis + MLP coefficients + input/output standardisation."""

    mlp: MLPParams
    components: jnp.ndarray   # (n_modes, NZ*NR)
    psi_mean: jnp.ndarray     # (NZ*NR,)
    x_mean: jnp.ndarray
    x_std: jnp.ndarray
    coeff_scale: jnp.ndarray  # (n_modes,)
    shape: tuple

    def predict(self, x: jnp.ndarray) -> jnp.ndarray:
        """x: (n_inputs,) -> psi (NZ, NR). O(1) — one MLP + one matmul."""
        xn = (x - self.x_mean) / self.x_std
        coeffs = mlp_apply(self.mlp, xn[None, :])[0] * self.coeff_scale
        psi_flat = self.psi_mean + coeffs @ self.components
        return psi_flat.reshape(self.shape)


def _pca(psi_batch: jnp.ndarray, n_modes: int):
    """Truncated PCA via SVD: psi_batch (N, D) -> (components, mean)."""
    mean = jnp.mean(psi_batch, axis=0)
    centred = psi_batch - mean
    _, _, vt = jnp.linalg.svd(centred, full_matrices=False)
    return vt[:n_modes], mean


def train_equilibrium_surrogate(
    inputs: jnp.ndarray,      # (N, n_inputs) e.g. coil currents + Ip
    psi_maps: jnp.ndarray,    # (N, NZ, NR) solved equilibria
    key,
    *,
    n_modes: int = 16,
    hidden: tuple = (64, 64),
    n_steps: int = 3000,
    lr: float = 1e-3,
) -> EquilibriumSurrogate:
    """Fit PCA + MLP on solver-generated equilibria (all on device)."""
    n, nz, nr = psi_maps.shape
    flat = psi_maps.reshape(n, nz * nr)
    components, psi_mean = _pca(flat, n_modes)
    coeffs = (flat - psi_mean) @ components.T        # (N, n_modes)
    coeff_scale = jnp.maximum(jnp.std(coeffs, axis=0), 1e-12)
    targets = coeffs / coeff_scale

    x_mean = jnp.mean(inputs, axis=0)
    x_std = jnp.maximum(jnp.std(inputs, axis=0), 1e-12)
    xn = (inputs - x_mean) / x_std

    sizes = (inputs.shape[1],) + hidden + (n_modes,)
    params0 = init_mlp(key, sizes, dtype=inputs.dtype)
    result = train_mlp(params0, xn, targets, jax.random.fold_in(key, 1),
                       n_steps=n_steps, batch_size=min(256, n), lr=lr)

    return EquilibriumSurrogate(
        mlp=result.params,
        components=components,
        psi_mean=psi_mean,
        x_mean=x_mean,
        x_std=x_std,
        coeff_scale=coeff_scale,
        shape=(nz, nr),
    )
