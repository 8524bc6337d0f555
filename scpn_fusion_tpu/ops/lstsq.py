"""Bounded Tikhonov least squares, jittable and differentiable.

JAX-native replacement for the reference's ``scipy.optimize.lsq_linear``
calls in coil-current optimisation (``fusion_kernel_free_boundary.py:
491-559``): a projected FISTA (accelerated projected gradient) on

    min ||A x - b||^2   s.t.  lb <= x <= ub

with a fixed iteration count so the whole solve stays inside ``jit`` and is
reverse-differentiable.  The unconstrained solution is recovered exactly when
the bounds are infinite (the augmented Tikhonov system makes A full rank, so
FISTA converges linearly); coil systems are tiny (n_coils ~ 10), so the cost
is negligible next to one grid stencil sweep.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bounded_lstsq(
    a: jnp.ndarray,
    b: jnp.ndarray,
    lb: jnp.ndarray,
    ub: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    *,
    n_iter: int = 300,
) -> jnp.ndarray:
    """Solve min ||A x - b||^2 subject to box bounds via projected FISTA.

    When ``x0`` is None the iteration warm-starts from the box-projected
    UNCONSTRAINED lstsq solution: exact immediately when no bound is active
    (the common case), and a near-optimal start otherwise — FISTA then only
    repairs the active-set boundary.  A caller-supplied ``x0`` is honored
    verbatim (warm-start contract for tracking loops passing last-tick
    currents) and the O(mn^2) SVD is skipped entirely (ADVICE r2).
    """
    m, n = a.shape
    if x0 is None:
        x_uncon = jnp.linalg.lstsq(a, b)[0]
        x0 = jnp.where(jnp.all(jnp.isfinite(x_uncon)), x_uncon,
                       jnp.zeros_like(x_uncon))
    x0 = jnp.clip(x0, lb, ub)

    ata = a.T @ a
    atb = a.T @ b
    # Lipschitz constant of the gradient: largest eigenvalue of A^T A.
    # Power iteration (fixed count) keeps it jittable.
    def power_body(_, v):
        w = ata @ v
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
    v = power_body(0, jnp.ones((n,), a.dtype))
    v = jax.lax.fori_loop(0, 30, power_body, v)
    lip = jnp.maximum(v @ (ata @ v), 1e-30)
    step = 1.0 / lip

    def body(i, carry):
        x, y, t = carry
        grad = ata @ y - atb
        x_new = jnp.clip(y - step * grad, lb, ub)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        y_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        y_new = jnp.clip(y_new, lb, ub)
        return x_new, y_new, t_new

    x, _, _ = jax.lax.fori_loop(
        0, n_iter, body, (x0, x0, jnp.asarray(1.0, a.dtype)))
    return x


def tikhonov_coil_lstsq(
    response_t: jnp.ndarray,   # (n_pts, n_coils) = M^T
    target: jnp.ndarray,       # (n_pts,)
    tikhonov_alpha: float,
    lb: jnp.ndarray,
    ub: jnp.ndarray,
    prior: jnp.ndarray | None = None,
    *,
    n_iter: int = 300,
) -> jnp.ndarray:
    """Bounded coil-current fit: [M^T; sqrt(a) I] x = [target; sqrt(a) prior].

    Matches the reference's augmented system (``optimize_coil_currents``
    :525-528 uses prior = 0; ``reconstruct_coil_currents_from_magnetic_probes``
    :449-452 regularises around the prior currents).
    """
    n_coils = response_t.shape[1]
    sq = jnp.sqrt(jnp.asarray(tikhonov_alpha, response_t.dtype))
    reg = sq * jnp.eye(n_coils, dtype=response_t.dtype)
    a = jnp.concatenate([response_t, reg], axis=0)
    prior_vec = jnp.zeros((n_coils,), response_t.dtype) if prior is None else prior
    b = jnp.concatenate([target, sq * prior_vec])
    return bounded_lstsq(a, b, lb, ub, x0=prior_vec, n_iter=n_iter)
