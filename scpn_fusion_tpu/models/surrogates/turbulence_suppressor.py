"""Spectral turbulence generator + suppression controller closed loop.

JAX-native port of the reference's FNO turbulence-suppression lane
(``core/fno_turbulence_suppressor.py:69-298``): a Fourier-space drift-wave
turbulence generator with predator-prey zonal-flow coupling, a suppression
controller (reduced-order field-statistics backend, with an optional FNO
surrogate backend through ``models/surrogates/fno.py``), and the seeded
closed-loop simulation.

The reference advances the generator with a host Python loop over NumPy
FFTs and calls the controller once per step; here the ENTIRE closed loop —
spectral step, zonal-flow ODE, controller, suppression — is one
``lax.scan`` over jnp FFTs with ``jax.random`` forcing: the 200-step loop
compiles to a single device program and is differentiable through the
controller gain.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

GRID_SIZE = 64


class TurbulenceState(NamedTuple):
    field_k: jnp.ndarray       # complex spectrum (N, N)
    zonal_flow: jnp.ndarray    # predator state (scalar)
    key: jnp.ndarray


def init_turbulence(key, size: int = GRID_SIZE) -> TurbulenceState:
    key, sub = jax.random.split(key)
    field = 0.1 * jax.random.normal(sub, (size, size))
    return TurbulenceState(jnp.fft.fft2(field), jnp.asarray(0.0), key)


def _wavenumbers(size: int):
    k = jnp.fft.fftfreq(size) * size
    kx, ky = jnp.meshgrid(k, k)
    k2 = kx**2 + ky**2
    return kx, ky, k2.at[0, 0].set(1.0)


def turbulence_step(state: TurbulenceState, damping,
                    *, dt: float = 0.01) -> TurbulenceState:
    """One drift-wave spectral step (reference ``SpectralTurbulenceGenerator.
    step:90-121``): predator-prey zonal flow, dispersion phase rotation
    omega = ky/(1+k^2), band-limited stochastic forcing, k^2 dissipation,
    and the (zonal-shear-augmented) suppression factor."""
    size = state.field_k.shape[0]
    _, ky, k2 = _wavenumbers(size)

    field = jnp.fft.ifft2(state.field_k).real
    turb_intensity = jnp.mean(field**2)
    zf = jnp.maximum(
        state.zonal_flow + (5.0 * turb_intensity
                            - 0.5 * state.zonal_flow) * dt, 0.0)
    total_damping = damping + 0.2 * zf

    omega = ky / (1.0 + k2)
    phase = jnp.exp(-1j * omega * dt)

    key, k1, k2_key = jax.random.split(state.key, 3)
    forcing = (jax.random.normal(k1, (size, size))
               + 1j * jax.random.normal(k2_key, (size, size)))
    forcing_k = jnp.fft.fft2(forcing) * (k2 < 25.0) * 5.0

    fk = (state.field_k * phase + forcing_k * dt) \
        * jnp.exp(-0.001 * k2 * dt) \
        * (1.0 - jnp.clip(total_damping, 0.0, 1.0))
    return TurbulenceState(fk, zf, key)


def compat_suppression(field: jnp.ndarray, gain=1.6) -> jnp.ndarray:
    """Reduced-order suppression command from field statistics (reference
    ``_compat_suppression_from_field:58-66``): bounded tanh of RMS +
    gradient-RMS."""
    f = jnp.nan_to_num(field)
    rms = jnp.sqrt(jnp.mean(f**2))
    gr = jnp.gradient(f, axis=0)
    gz = jnp.gradient(f, axis=1)
    grad_rms = jnp.sqrt(jnp.mean(gr**2 + gz**2))
    signal = 0.9 * rms + 0.35 * grad_rms
    return jnp.clip(jnp.tanh(gain * signal), 0.0, 0.98)


def fno_suppression(field: jnp.ndarray, fno_params) -> jnp.ndarray:
    """FNO-surrogate suppression command (reference legacy backend
    ``predict_and_suppress:188-204``): bounded tanh of the surrogate's
    mean response."""
    from scpn_fusion_tpu.models.surrogates.fno import fno_apply

    pred = fno_apply(fno_params, field[None, :, :, None])
    return jnp.clip(jnp.tanh(2.0 * jnp.mean(pred)), 0.0, 0.98)


def postprocess_suppressed_field(field: jnp.ndarray,
                                 suppression) -> jnp.ndarray:
    """Suppressed field with the non-physical DC mode removed (reference
    ``_postprocess_prediction:177-185``)."""
    out = field * (1.0 - jnp.clip(suppression, 0.0, 0.98))
    fk = jnp.fft.fft2(out).at[0, 0].set(0.0)
    return jnp.nan_to_num(jnp.fft.ifft2(fk).real)


class SuppressionRun(NamedTuple):
    energy: jnp.ndarray            # (n_steps,) turbulence energy history
    suppression: jnp.ndarray       # (n_steps,) applied commands
    zonal_flow: jnp.ndarray        # (n_steps,)
    final_field: jnp.ndarray
    mean_energy_last20: jnp.ndarray
    max_energy: jnp.ndarray


@partial(jax.jit, static_argnames=("n_steps", "control_on_step", "size",
                                   "use_fno"))
def run_suppression_loop(
    seed: int = 42,
    *,
    n_steps: int = 200,
    control_on_step: int = 50,
    size: int = GRID_SIZE,
    gain=1.6,
    use_fno: bool = False,
    fno_params=None,
) -> SuppressionRun:
    """Seeded closed-loop suppression run (reference
    ``run_fno_simulation:208-298``): free turbulence growth until
    ``control_on_step``, then the controller damps the drive each step.
    One compiled ``scan``; differentiable in ``gain``."""
    state0 = init_turbulence(jax.random.PRNGKey(seed), size)

    def step(state, k):
        field = jnp.fft.ifft2(state.field_k).real
        if use_fno:
            cmd = fno_suppression(field, fno_params)
        else:
            cmd = compat_suppression(field, gain)
        control = jnp.where(k > control_on_step, cmd, 0.0)
        new = turbulence_step(state, control)
        energy = jnp.mean(jnp.fft.ifft2(new.field_k).real ** 2)
        return new, (energy, control, new.zonal_flow)

    final, (energy, ctrl, zf) = jax.lax.scan(
        step, state0, jnp.arange(n_steps))
    return SuppressionRun(
        energy=energy, suppression=ctrl, zonal_flow=zf,
        final_field=jnp.fft.ifft2(final.field_k).real,
        mean_energy_last20=jnp.mean(energy[-20:]),
        max_energy=jnp.max(energy))
