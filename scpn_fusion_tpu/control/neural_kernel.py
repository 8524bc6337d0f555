"""Neural equilibrium kernel: O(1) surrogate as the in-loop plant solver.

JAX-native port of the reference's drop-in surrogate kernel
(``core/neural_equilibrium_kernel.py:48-294`` ``NeuralEquilibriumKernel`` —
"~1000x faster control loops by bypassing the Picard iteration" — and the
HPC-bridge O(1) lane ``hpc_bridge.py:332-357``): the PCA+MLP equilibrium
surrogate (``models/surrogates/equilibrium_surrogate.py``) replaces the full
Grad-Shafranov solve inside a closed-loop shape controller.

Where the reference swaps a Python object into its host-loop controller,
here the surrogate IS the plant map inside one ``lax.scan``: every control
tick is one MLP + one PCA matmul + the PI update — the whole multi-tick
shot compiles to a single device program with no Picard iterations at all.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def soft_axis_position(psi: jnp.ndarray, r_1d: jnp.ndarray,
                       z_1d: jnp.ndarray, *, temperature=200.0):
    """Differentiable magnetic-axis locator: softmax-weighted (R, Z) of the
    flux map (the reference kernel's axis attributes via ``jax_o_point``
    semantics).  Sharp temperature => argmax within a cell."""
    span = jnp.maximum(jnp.max(psi) - jnp.min(psi), 1e-30)
    w = jax.nn.softmax((temperature / span) * psi.reshape(-1))
    rr, zz = jnp.meshgrid(r_1d, z_1d)
    return jnp.sum(w * rr.reshape(-1)), jnp.sum(w * zz.reshape(-1))


class NeuralShapeTrace(NamedTuple):
    axis_r: jnp.ndarray          # (n_ticks,)
    axis_z: jnp.ndarray
    currents: jnp.ndarray        # (n_ticks, n_coils)
    err_r: jnp.ndarray
    final_psi: jnp.ndarray


def run_neural_shape_loop(
    surrogate,
    currents0: jnp.ndarray,
    r_1d: jnp.ndarray,
    z_1d: jnp.ndarray,
    *,
    target_r,
    steer: jnp.ndarray,          # (n_coils,) current direction that moves R
    n_ticks: int = 100,
    kp=4.0,
    ki=0.6,
    current_limit=20.0,
) -> NeuralShapeTrace:
    """Closed-loop radial-position control with the surrogate as plant:
    PI on the axis-R error steering a coil-current direction.  One scan —
    per-tick cost is surrogate.predict (O(1)), not a GS solve.

    The surrogate is closed over (its ``shape`` field is a static Python
    tuple that must not be traced); the loop itself jits on first call per
    (surrogate id, n_ticks)."""
    target_r = jnp.asarray(target_r, currents0.dtype)

    @partial(jax.jit, static_argnames=("n",))
    def loop(c0, tgt, st, n):
        def tick(carry, _):
            currents, integ = carry
            psi = surrogate.predict(currents)
            ax_r, ax_z = soft_axis_position(psi, r_1d, z_1d)
            err = (tgt - ax_r).astype(c0.dtype)
            integ_new = integ + err
            delta = kp * err + ki * integ_new
            currents = jnp.clip(currents + delta * st,
                                -current_limit, current_limit)
            return (currents, integ_new), (ax_r, ax_z, currents, err)

        return jax.lax.scan(
            tick, (c0, jnp.asarray(0.0, c0.dtype)), None, length=n)

    (currents_f, _), (ax_r, ax_z, cur, err) = loop(
        currents0, target_r, steer, n_ticks)
    return NeuralShapeTrace(ax_r, ax_z, cur, err,
                            surrogate.predict(currents_f))
