"""Polynomial chaos expansion (Hermite, total order) + Sobol indices.

JAX-native equivalent of the reference PCE engine (Rust
``fusion-ml/src/pce.rs:20-200``): multivariate probabilists'-Hermite chaos
with a total-order multi-index basis, least-squares coefficient fit via
SVD pseudo-inverse, single-point prediction, first-order Sobol indices
from coefficient energies, and Latin-hypercube sampling.

The basis construction is fully vectorised: a Hermite value table
He_0..He_P is built once by recurrence for every (sample, dim), then each
basis term is a product gather — the design matrix assembly is two fused
elementwise passes and one transpose-free gather, no per-term loops, and
the fit itself is one (n_samples, n_terms) SVD as one matmul.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def total_order_multi_index(n_dims: int, order: int) -> tuple:
    """All exponent tuples alpha with sum(alpha) <= order (host/static)."""
    out = []

    def rec(prefix, remaining, dims_left):
        if dims_left == 0:
            out.append(tuple(prefix))
            return
        for p in range(remaining + 1):
            rec(prefix + [p], remaining - p, dims_left - 1)

    rec([], order, n_dims)
    # Sort by total order then lexicographically for a stable layout with
    # the constant term first.
    out.sort(key=lambda a: (sum(a), a))
    return tuple(out)


def hermite_table(x: jnp.ndarray, max_order: int) -> jnp.ndarray:
    """Probabilists' Hermite He_0..He_max by recurrence: (..., P+1)."""
    he = [jnp.ones_like(x), x]
    for n in range(1, max_order):
        he.append(x * he[n] - n * he[n - 1])
    return jnp.stack(he[: max_order + 1], axis=-1)


def design_matrix(samples: jnp.ndarray, multi_index: tuple) -> jnp.ndarray:
    """(n_samples, n_terms) with Psi[s, t] = prod_d He_{alpha[t,d]}(x[s,d])."""
    alpha = jnp.asarray(np.array(multi_index), jnp.int32)   # (T, D)
    max_order = int(np.max(np.array(multi_index))) if multi_index else 0
    he = hermite_table(samples, max_order)                  # (S, D, P+1)
    # Gather He_{alpha[t, d]}(x[s, d]) -> (S, T, D), then product over D.
    gathered = he[:, jnp.arange(alpha.shape[1])[None, :], alpha[:, :]]
    return jnp.prod(gathered, axis=-1)


class PCEModel(NamedTuple):
    coefficients: jnp.ndarray    # (n_terms, n_outputs)
    multi_index: tuple


def fit_pce(samples: jnp.ndarray, outputs: jnp.ndarray, order: int,
            rcond: float = 1e-10) -> PCEModel:
    """Least-squares Hermite-chaos fit (reference ``PCEModel::fit``).

    samples (S, D) standard-normal inputs; outputs (S, K).
    Fail-closed on shape mismatch / non-finite data like the reference.
    """
    samples = jnp.atleast_2d(jnp.asarray(samples))
    outputs = jnp.atleast_2d(jnp.asarray(outputs))
    if samples.shape[0] != outputs.shape[0]:
        raise ValueError("PCE fit requires matching sample and output rows")
    if samples.shape[0] == 0 or samples.shape[1] == 0 or outputs.shape[1] == 0:
        raise ValueError("PCE fit requires non-empty samples and outputs")
    if not (bool(jnp.all(jnp.isfinite(samples)))
            and bool(jnp.all(jnp.isfinite(outputs)))):
        raise ValueError("PCE fit received non-finite values")

    mi = total_order_multi_index(samples.shape[1], order)
    psi = design_matrix(samples, mi)
    # SVD pseudo-inverse with relative cutoff (reference pinv_svd).
    u, s, vt = jnp.linalg.svd(psi, full_matrices=False)
    cutoff = rcond * jnp.max(s)
    s_inv = jnp.where(s > cutoff, 1.0 / jnp.maximum(s, 1e-300), 0.0)
    coeff = (vt.T * s_inv[None, :]) @ (u.T @ outputs)
    if not bool(jnp.all(jnp.isfinite(coeff))):
        raise ValueError("PCE coefficients contain non-finite values")
    return PCEModel(coeff, mi)


def predict_pce(model: PCEModel, x: jnp.ndarray) -> jnp.ndarray:
    """Evaluate at one point (D,) or a batch (S, D) -> (K,) or (S, K)."""
    x = jnp.asarray(x)
    single = x.ndim == 1
    psi = design_matrix(jnp.atleast_2d(x), model.multi_index)
    out = psi @ model.coefficients
    return out[0] if single else out


def sobol_first_order(model: PCEModel) -> jnp.ndarray:
    """First-order Sobol indices from coefficient energies
    (reference ``sobol_indices``)."""
    mi = model.multi_index
    if not mi:
        return jnp.zeros(0)
    n_dims = len(mi[0])
    import math
    norms = np.array([float(np.prod([math.factorial(a) for a in alpha]))
                      for alpha in mi])
    energy = jnp.sum(model.coefficients**2, axis=1) * jnp.asarray(
        norms, model.coefficients.dtype)

    first = np.zeros((len(mi), n_dims))
    total_mask = np.zeros(len(mi))
    for t, alpha in enumerate(mi):
        if sum(alpha) == 0:
            continue
        total_mask[t] = 1.0
        nz = [d for d, a in enumerate(alpha) if a > 0]
        if len(nz) == 1:
            first[t, nz[0]] = 1.0
    total_var = jnp.sum(energy * jnp.asarray(total_mask, energy.dtype))
    first_var = jnp.asarray(first, energy.dtype).T @ energy
    return jnp.clip(first_var / jnp.maximum(total_var, 1e-16), 0.0, 1.0)


@partial(jax.jit, static_argnames=("n_samples", "n_dims"))
def latin_hypercube(key, n_samples: int, n_dims: int) -> jnp.ndarray:
    """LHS in [0,1]^D: stratified jitter + per-dim permutation."""
    keys = jax.random.split(key, 2 * n_dims)
    cols = []
    for d in range(n_dims):
        jitter = jax.random.uniform(keys[2 * d], (n_samples,))
        vals = (jnp.arange(n_samples) + jitter) / n_samples
        cols.append(jax.random.permutation(keys[2 * d + 1], vals))
    return jnp.stack(cols, axis=1)
