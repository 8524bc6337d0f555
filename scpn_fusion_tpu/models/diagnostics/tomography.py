"""Tomographic inversion of line-integrated chord signals.

JAX-native equivalent of the reference tomography stack
(``diagnostics/tomography.py:29-205`` + its Rust ``PyTomography`` twin):
reconstruct a 2D emissivity map on an ``res x res`` pixel grid from
bolometer chord brightness by solving the Tikhonov-regularised
non-negative inverse problem  min ||A x - b||^2 + lam ||x||^2, x >= 0.

Geometry assembly — the reference loops 100 sample points per chord in
Python (and again in Rust); here the whole (n_chords, n_samples) sample
cloud is binned at once and accumulated into the geometry matrix with a
one-hot contraction (one matmul, no scatters).  ``floor`` binning keeps
out-of-grid samples excluded rather than aliased, matching the reference's
Rust-parity behaviour.

Three device-resident solvers mirror the reference's methods:

* ``nnls``  — accelerated projected gradient (FISTA) on the augmented
  Tikhonov system, the same algorithm as the reference's Rust backend
  (shared with ``ops/lstsq.bounded_lstsq``).
* ``sart``  — simultaneous algebraic reconstruction with row/column
  weights inside ``lax.fori_loop``.
* ``ridge`` — Phillips-Twomey: Laplacian-smoothness normal equations by
  direct solve.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.ops.lstsq import bounded_lstsq


@partial(jax.jit, static_argnames=("res", "n_samples"))
def build_geometry_matrix(
    starts: jnp.ndarray,      # (n_chords, 2) chord start (R, Z)
    ends: jnp.ndarray,        # (n_chords, 2)
    r_min: float, r_max: float,
    z_min: float, z_max: float,
    *,
    res: int = 20,
    n_samples: int = 100,
) -> jnp.ndarray:
    """Path-length geometry matrix A (n_chords, res*res), vectorised.

    Column-major pixel layout ``pixel = iz * res + ir`` (reference parity).
    """
    r_grid = jnp.linspace(r_min, r_max, res)
    z_grid = jnp.linspace(z_min, z_max, res)
    dr = r_grid[1] - r_grid[0]
    dz = z_grid[1] - z_grid[0]

    t = jnp.linspace(0.0, 1.0, n_samples)[None, :, None]   # (1, S, 1)
    pts = starts[:, None, :] + t * (ends - starts)[:, None, :]
    dl = jnp.linalg.norm(ends - starts, axis=1) / n_samples   # (n_chords,)

    ir = jnp.floor((pts[..., 0] - r_min) / dr).astype(jnp.int32)
    iz = jnp.floor((pts[..., 1] - z_min) / dz).astype(jnp.int32)
    inside = (ir >= 0) & (ir < res) & (iz >= 0) & (iz < res)
    pixel = jnp.where(inside, iz * res + ir, 0)

    onehot = jax.nn.one_hot(pixel, res * res, dtype=starts.dtype)
    onehot = onehot * inside[..., None].astype(starts.dtype)
    return jnp.einsum("cs,csp->cp", jnp.broadcast_to(dl[:, None],
                                                     pixel.shape), onehot)


def _laplacian_operator(res: int, dtype) -> jnp.ndarray:
    """2D 5-point Laplacian as a dense (P, P) matrix (Phillips-Twomey)."""
    n = res * res
    idx = jnp.arange(n)
    lap = 4.0 * jnp.eye(n, dtype=dtype)
    col = idx % res
    has_l = col > 0
    has_r = col < res - 1
    has_d = idx >= res
    has_u = idx < n - res
    lap = lap.at[idx, jnp.clip(idx - 1, 0, n - 1)].add(
        jnp.where(has_l, -1.0, 0.0))
    lap = lap.at[idx, jnp.clip(idx + 1, 0, n - 1)].add(
        jnp.where(has_r, -1.0, 0.0))
    lap = lap.at[idx, jnp.clip(idx - res, 0, n - 1)].add(
        jnp.where(has_d, -1.0, 0.0))
    lap = lap.at[idx, jnp.clip(idx + res, 0, n - 1)].add(
        jnp.where(has_u, -1.0, 0.0))
    return lap


@partial(jax.jit, static_argnames=("res", "method", "n_iters"))
def reconstruct(
    a_matrix: jnp.ndarray,    # (n_chords, res*res)
    signals: jnp.ndarray,     # (n_chords,)
    *,
    res: int,
    lambda_reg: float = 0.1,
    method: str = "nnls",
    n_iters: int = 300,
) -> jnp.ndarray:
    """Invert chord signals to a (res, res) non-negative emissivity map."""
    b = jnp.nan_to_num(signals, nan=0.0, posinf=0.0, neginf=0.0)
    b = jnp.maximum(b, 0.0)
    n_pix = res * res
    dtype = a_matrix.dtype

    if method == "nnls":
        # Augmented Tikhonov system solved with projected FISTA — same
        # algorithm as the reference's Rust backend.
        a_aug = jnp.concatenate(
            [a_matrix, jnp.sqrt(lambda_reg) * jnp.eye(n_pix, dtype=dtype)])
        b_aug = jnp.concatenate([b, jnp.zeros(n_pix, dtype=dtype)])
        x = bounded_lstsq(a_aug, b_aug,
                          lb=jnp.zeros(n_pix, dtype=dtype),
                          ub=jnp.full((n_pix,), jnp.inf, dtype=dtype),
                          n_iter=n_iters)
    elif method == "sart":
        col_w = jnp.sum(a_matrix, axis=0)
        row_w = jnp.sum(a_matrix, axis=1)
        # Support mask: the 1/coverage weight amplifies noise in pixels a
        # handful of chords barely graze; exclude pixels below 2% of the
        # best-covered pixel (standard SART support masking).
        covered = col_w > 0.02 * jnp.max(col_w)
        col_w = jnp.where(covered, 1.0 / jnp.maximum(col_w, 1e-30), 0.0)
        row_w = jnp.where(row_w > 0, 1.0 / jnp.maximum(row_w, 1e-30), 0.0)

        def body(_, x):
            err = b - a_matrix @ x
            x = x + 0.1 * col_w * (a_matrix.T @ (row_w * err))
            return jnp.maximum(x, 0.0)

        x = jax.lax.fori_loop(0, n_iters, body,
                              jnp.zeros(n_pix, dtype=dtype))
    elif method == "ridge":
        lap = _laplacian_operator(res, dtype)
        lhs = a_matrix.T @ a_matrix + lambda_reg * (lap.T @ lap)
        rhs = a_matrix.T @ b
        x = jnp.maximum(jnp.linalg.solve(lhs, rhs), 0.0)
    else:
        raise ValueError(f"unknown method {method!r}")
    return x.reshape(res, res)


def fan_chords(r_pinhole: float, z_pinhole: float, *, n_chords: int,
               r_target: float, z_span: float, dtype=jnp.float32):
    """Fan-beam chord layout from one pinhole camera toward the plasma
    column (convenience mirroring the reference's bolometer geometry)."""
    z_hits = jnp.linspace(-z_span, z_span, n_chords, dtype=dtype)
    starts = jnp.stack([jnp.full((n_chords,), r_pinhole, dtype=dtype),
                        jnp.full((n_chords,), z_pinhole, dtype=dtype)], axis=1)
    ends = jnp.stack([jnp.full((n_chords,), r_target, dtype=dtype),
                      z_hits], axis=1)
    return starts, ends
