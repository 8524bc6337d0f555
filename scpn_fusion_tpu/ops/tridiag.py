"""Tridiagonal (Thomas) solver as ``lax.scan`` sweeps.

JAX-native port of the reference's host-loop Thomas algorithm
(``integrated_transport_solver_runtime_utils.py:22-60``) following the design
of its own JAX lane (``core/jax_solvers.py:123-167``): forward elimination and
back substitution are two ``lax.scan`` passes, so a radial transport solve
stays entirely on device and batches with ``vmap`` (one batched call solves
all channels / all flux surfaces at once — the reference's
``batched_crank_nicolson`` pattern, ``jax_solvers.py:366``).

Numerical guards mirror the reference: pivots floored at 1e-30, non-finite
intermediates replaced by 0 — fail-soft semantics that keep the control loop
alive on degenerate inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PIVOT_FLOOR = 1e-30


def _safe(x):
    return jnp.where(jnp.isfinite(x), x, 0.0)


def thomas_solve(
    a: jnp.ndarray,
    b: jnp.ndarray,
    c: jnp.ndarray,
    d: jnp.ndarray,
) -> jnp.ndarray:
    """Solve tridiagonal A x = d.

    Parameters
    ----------
    a : (n-1,) sub-diagonal
    b : (n,) main diagonal
    c : (n-1,) super-diagonal
    d : (n,) right-hand side
    """
    n = d.shape[0]

    def clamp_pivot(m):
        bad = (~jnp.isfinite(m)) | (jnp.abs(m) < _PIVOT_FLOOR)
        return jnp.where(bad, _PIVOT_FLOOR, m)

    b0 = clamp_pivot(b[0])
    cp0 = _safe(c[0] / b0)
    dp0 = _safe(d[0] / b0)

    # Forward elimination: carry (cp_prev, dp_prev).
    a_pad = a                       # a[i-1] aligns with rows 1..n-1
    c_pad = jnp.concatenate([c[1:], jnp.zeros((1,), c.dtype)])  # c[i] for rows 1..n-1

    def fwd(carry, inputs):
        cp_prev, dp_prev = carry
        ai, bi, ci, di = inputs
        m = clamp_pivot(bi - ai * cp_prev)
        cp_i = _safe(ci / m)
        dp_i = _safe(_safe(di - ai * dp_prev) / m)
        return (cp_i, dp_i), (cp_i, dp_i)

    (_, _), (cps, dps) = jax.lax.scan(
        fwd, (cp0, dp0), (a_pad, b[1:], c_pad, d[1:]))
    cp = jnp.concatenate([cp0[None], cps[:-1]])   # cp[0..n-2]
    dp = jnp.concatenate([dp0[None], dps])        # dp[0..n-1]

    # Back substitution (reverse scan): x[i] = dp[i] - cp[i] x[i+1].
    def bwd(x_next, inputs):
        cp_i, dp_i = inputs
        x_i = _safe(dp_i - cp_i * x_next)
        return x_i, x_i

    x_last = dp[-1]
    _, xs = jax.lax.scan(bwd, x_last, (cp, dp[:-1]), reverse=True)
    return jnp.concatenate([xs, x_last[None]])


# Batched over leading axis: solves B independent systems at once.
thomas_solve_batched = jax.vmap(thomas_solve, in_axes=(0, 0, 0, 0))
