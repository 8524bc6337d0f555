"""Echo-state network (reservoir computing) oracle for chaotic forecasting.

JAX-native port of the reference's ``OracleESN``
(``core/turbulence_oracle.py:145-231``): a fixed random reservoir
``x' = tanh(W_in u + W_res x)`` harvested over a training sequence, a
ridge-regression readout, and closed-loop autoregressive prediction.

Design differences from the reference (all disclosed):

* the sparse reservoir is a dense masked matrix — as one matmul a 500x500
  dense matmul is faster than any sparse format, and the zero pattern is
  preserved exactly;
* the spectral radius is normalised with a power iteration on the device
  (the reference calls ``np.linalg.eigvals``; power iteration gives the
  same dominant-|lambda| scaling without a host-side complex eig);
* state harvesting, training-system assembly, and closed-loop prediction
  are each ONE ``lax.scan``/matmul program — the reference's per-sample
  Python loops (``train`` :194-211, ``predict`` :213-231) disappear.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class ESNParams(NamedTuple):
    w_in: jnp.ndarray    # (reservoir, input)
    w_res: jnp.ndarray   # (reservoir, reservoir), spectral radius scaled


class ESNReadout(NamedTuple):
    w_out: jnp.ndarray   # (output, reservoir)


def _spectral_radius(a: jnp.ndarray, iters: int = 200) -> jnp.ndarray:
    """Dominant |eigenvalue| by power iteration (deterministic start)."""
    v = jnp.ones((a.shape[0],), a.dtype) / jnp.sqrt(a.shape[0])

    def body(v, _):
        w = a @ v
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30), None

    v, _ = jax.lax.scan(body, v, None, length=iters)
    return jnp.linalg.norm(a @ v)


def init_esn(key, input_dim: int, reservoir_size: int = 500,
             spectral_radius: float = 0.95, density: float = 0.1,
             dtype=jnp.float32) -> ESNParams:
    """Random input + sparse-masked reservoir weights (reference :152-190)."""
    k_in, k_res, k_mask = jax.random.split(key, 3)
    w_in = jax.random.uniform(k_in, (reservoir_size, input_dim), dtype,
                              minval=-1.0, maxval=1.0)
    w = jax.random.uniform(k_res, (reservoir_size, reservoir_size), dtype,
                           minval=-1.0, maxval=1.0)
    mask = jax.random.uniform(k_mask, (reservoir_size, reservoir_size),
                              dtype) < density
    w = w * mask
    radius = _spectral_radius(w)
    w = jnp.where(radius > 1e-12, w * (spectral_radius / radius), w)
    return ESNParams(w_in=w_in, w_res=w)


def harvest_states(params: ESNParams, inputs: jnp.ndarray,
                   x0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Run the reservoir over (T, input) rows; return (T, reservoir) states
    (reference ``train`` harvest loop :198-203)."""
    n_res = params.w_in.shape[0]
    inputs = inputs.astype(params.w_in.dtype)
    if x0 is None:
        x0 = jnp.zeros((n_res,), params.w_in.dtype)
    else:
        x0 = x0.astype(params.w_in.dtype)

    def body(x, u):
        x2 = jnp.tanh(params.w_in @ u + params.w_res @ x)
        return x2, x2

    _, states = jax.lax.scan(body, x0, inputs)
    return states


def train_readout(states: jnp.ndarray, targets: jnp.ndarray,
                  reg: float = 1e-4) -> ESNReadout:
    """Ridge readout: W_out (S^T S + reg I) = Y^T S (reference :205-211)."""
    n = states.shape[1]
    targets = targets.astype(states.dtype)
    system = states.T @ states + reg * jnp.eye(n, dtype=states.dtype)
    rhs = targets.T @ states
    w_out = jnp.linalg.solve(system.T, rhs.T).T
    return ESNReadout(w_out=w_out)


def fit_esn(params: ESNParams, inputs: jnp.ndarray, targets: jnp.ndarray,
            reg: float = 1e-4) -> tuple[ESNReadout, jnp.ndarray]:
    """Harvest + train; returns the readout and the final reservoir state
    (the state to continue closed-loop prediction from)."""
    states = harvest_states(params, inputs)
    return train_readout(states, targets, reg), states[-1]


@partial(jax.jit, static_argnames=("steps",))
def predict_closed_loop(params: ESNParams, readout: ESNReadout,
                        x: jnp.ndarray, u0: jnp.ndarray,
                        steps: int) -> jnp.ndarray:
    """Autoregressive rollout feeding predictions back (reference :213-231)."""

    dtype = params.w_in.dtype
    x = x.astype(dtype)
    u0 = u0.astype(dtype)
    w_out = readout.w_out.astype(dtype)

    def body(carry, _):
        x, u = carry
        x2 = jnp.tanh(params.w_in @ u + params.w_res @ x)
        pred = w_out @ x2
        return (x2, pred), pred

    _, preds = jax.lax.scan(body, (x, u0), None, length=steps)
    return preds


def trust_horizon(truth: jnp.ndarray, prediction: jnp.ndarray,
                  threshold_frac: float = 0.5) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Steps until per-step MSE exceeds ``threshold_frac * var(truth)``
    (reference ``run_turbulence_oracle`` :275-283).  Returns (horizon, mse)."""
    mse = jnp.mean((truth - prediction) ** 2, axis=1)
    threshold = threshold_frac * jnp.var(truth)
    exceeded = mse > threshold
    # First True index, or len(mse) when never exceeded.
    idx = jnp.argmax(exceeded)
    horizon = jnp.where(jnp.any(exceeded), idx, mse.shape[0])
    return horizon, mse
