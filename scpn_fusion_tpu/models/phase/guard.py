"""Sliding-window Lyapunov stability guard.

JAX-native equivalent of the reference guard
(``phase/lyapunov_guard.py:42-160``): feed V(t) samples into a fixed-size
ring buffer, estimate the finite-window Lyapunov exponent
lambda = ln(V_last/V_first)/T, count consecutive threshold violations,
and refuse after ``max_violations`` in a row.  The verdict also exposes
the sigmoid stability score 1/(1 + e^{10 lambda}).

State is an explicit NamedTuple so the guard composes with jitted control
loops (the reference uses a Python deque + mutable counters).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

from scpn_fusion_tpu.models.phase.kuramoto import lyapunov_v


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    window: int = 50
    dt: float = 1e-3
    lambda_threshold: float = 0.0
    max_violations: int = 3


class GuardState(NamedTuple):
    v_buffer: jnp.ndarray     # (window,) ring of V samples
    n_seen: jnp.ndarray       # int32 total samples fed
    consecutive: jnp.ndarray  # int32 consecutive violations


class GuardVerdict(NamedTuple):
    v: jnp.ndarray
    lambda_exp: jnp.ndarray
    approved: jnp.ndarray
    consecutive_violations: jnp.ndarray

    @property
    def score(self):
        """Stability score in [0, 1]; 1 = strongly contracting."""
        return jnp.clip(1.0 / (1.0 + jnp.exp(
            jnp.clip(10.0 * self.lambda_exp, -80.0, 80.0))), 0.0, 1.0)


def init_guard(cfg: GuardConfig, dtype=jnp.float32) -> GuardState:
    return GuardState(jnp.zeros(cfg.window, dtype), jnp.int32(0),
                      jnp.int32(0))


def guard_check(cfg: GuardConfig, state: GuardState, theta, psi):
    """Feed one sample; returns (verdict, new_state).  Pure/jittable."""
    v = lyapunov_v(theta, psi).astype(state.v_buffer.dtype)
    buf = jnp.roll(state.v_buffer, -1).at[-1].set(v)
    n_seen = state.n_seen + 1
    n_valid = jnp.minimum(n_seen, cfg.window)

    # lambda over the valid window: oldest valid sample vs newest.
    oldest = buf[cfg.window - n_valid]
    lam = jnp.where(
        n_valid < 2, 0.0,
        jnp.log(jnp.maximum(v, 1e-15) / jnp.maximum(oldest, 1e-15))
        / (n_valid.astype(buf.dtype) * cfg.dt))

    violated = (n_valid >= 2) & (lam > cfg.lambda_threshold)
    consecutive = jnp.where(violated, state.consecutive + 1, 0)
    approved = consecutive < cfg.max_violations
    return (GuardVerdict(v, lam, approved, consecutive),
            GuardState(buf, n_seen, consecutive))


def guard_check_trajectory(cfg: GuardConfig, v_hist) -> GuardVerdict:
    """Batch verdict from a whole V(t) trajectory (reference
    ``check_trajectory``)."""
    v_hist = jnp.asarray(v_hist)
    n = v_hist.shape[0]
    lam = jnp.where(
        n < 2, 0.0,
        jnp.log(jnp.maximum(v_hist[-1], 1e-15)
                / jnp.maximum(v_hist[0], 1e-15)) / (n * cfg.dt))
    approved = lam <= cfg.lambda_threshold
    return GuardVerdict(v_hist[-1], lam, approved,
                        jnp.where(approved, 0, 1).astype(jnp.int32))
