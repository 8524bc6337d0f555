"""2D Fourier Neural Operator (turbulence-surrogate backbone).

From-scratch JAX FNO (reference lane: ``core/fno_jax_training.py:39-310``
spectral-convolution turbulence surrogate, val rel-L2 0.055): spectral
convolution = rFFT2 -> low-mode complex multiply -> irFFT2, plus a pointwise
(1x1) path, gelu between layers.  Channels-last layout; FFTs run on the
device via XLA.  Training is a jitted Adam scan like the MLP backbone.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax


class SpectralConvParams(NamedTuple):
    w_real: jnp.ndarray    # (c_in, c_out, modes1, modes2) — positive-row corner
    w_imag: jnp.ndarray
    w2_real: jnp.ndarray   # negative-row corner (independent weights)
    w2_imag: jnp.ndarray


class FNOParams(NamedTuple):
    lift_w: jnp.ndarray      # (c_in, width)
    lift_b: jnp.ndarray
    spectral: tuple          # of SpectralConvParams
    pointwise: tuple         # of (width, width) arrays
    proj1_w: jnp.ndarray
    proj1_b: jnp.ndarray
    proj2_w: jnp.ndarray
    proj2_b: jnp.ndarray


def init_fno(
    key,
    *,
    in_channels: int = 1,
    out_channels: int = 1,
    width: int = 32,
    modes: int = 12,
    n_layers: int = 4,
    dtype=jnp.float32,
) -> FNOParams:
    keys = jax.random.split(key, 2 * n_layers + 3)
    scale = 1.0 / (width * width)
    spectral = []
    pointwise = []
    for i in range(n_layers):
        spectral.append(SpectralConvParams(
            w_real=scale * jax.random.normal(keys[2 * i], (width, width, modes, modes), dtype),
            w_imag=scale * jax.random.normal(keys[2 * i + 1], (width, width, modes, modes), dtype),
            w2_real=scale * jax.random.normal(
                jax.random.fold_in(keys[2 * i], 11), (width, width, modes, modes), dtype),
            w2_imag=scale * jax.random.normal(
                jax.random.fold_in(keys[2 * i + 1], 13), (width, width, modes, modes), dtype),
        ))
        pointwise.append(
            jnp.sqrt(2.0 / width)
            * jax.random.normal(jax.random.fold_in(keys[2 * i], 7),
                                (width, width), dtype))
    k_lift, k_p1, k_p2 = keys[-3:]
    return FNOParams(
        lift_w=jnp.sqrt(2.0 / in_channels)
        * jax.random.normal(k_lift, (in_channels, width), dtype),
        lift_b=jnp.zeros((width,), dtype),
        spectral=tuple(spectral),
        pointwise=tuple(pointwise),
        proj1_w=jnp.sqrt(2.0 / width) * jax.random.normal(k_p1, (width, 128), dtype),
        proj1_b=jnp.zeros((128,), dtype),
        proj2_w=jnp.sqrt(2.0 / 128) * jax.random.normal(k_p2, (128, out_channels), dtype),
        proj2_b=jnp.zeros((out_channels,), dtype),
    )


def _spectral_conv(x: jnp.ndarray, p: SpectralConvParams) -> jnp.ndarray:
    """x: (H, W, C_in) -> (H, W, C_out) via truncated-mode complex multiply.

    Uses full complex fft2/ifft2 rather than rfft2/irfft2: the committed
    weight artifacts (``weights/``) were trained through this transform,
    and switching to the real transforms changes the layer's arithmetic.
    The four low-mode corners carry w / conj(w) so the output spectrum
    stays (approximately) Hermitian; ``.real`` projects out residual
    asymmetry, as in standard FNO implementations.
    """
    h, w, _ = x.shape
    m1, m2 = p.w_real.shape[2], p.w_real.shape[3]
    c_out = p.w_real.shape[1]
    x_ft = jnp.fft.fft2(x.astype(jnp.complex64), axes=(0, 1))   # (H, W, C)
    wa = p.w_real + 1j * p.w_imag                                # rows+, cols+
    wb = p.w2_real + 1j * p.w2_imag                              # rows-, cols+

    out_ft = jnp.zeros((h, w, c_out), jnp.complex64)
    out_ft = out_ft.at[:m1, :m2, :].set(
        jnp.einsum("xyi,ioxy->xyo", x_ft[:m1, :m2, :], wa))
    out_ft = out_ft.at[-m1:, :m2, :].set(
        jnp.einsum("xyi,ioxy->xyo", x_ft[-m1:, :m2, :], wb))
    # Hermitian-mirrored column corners carry the conjugate weights so a
    # real input keeps a (near-)Hermitian output spectrum.
    out_ft = out_ft.at[:m1, -m2:, :].set(
        jnp.einsum("xyi,ioxy->xyo", x_ft[:m1, -m2:, :], jnp.conj(wb)))
    out_ft = out_ft.at[-m1:, -m2:, :].set(
        jnp.einsum("xyi,ioxy->xyo", x_ft[-m1:, -m2:, :], jnp.conj(wa)))
    return jnp.fft.ifft2(out_ft, axes=(0, 1)).real.astype(x.dtype)


def fno_apply(params: FNOParams, x: jnp.ndarray) -> jnp.ndarray:
    """Forward pass. x: (H, W, C_in) -> (H, W, C_out)."""
    h = x @ params.lift_w + params.lift_b
    for spec, pw in zip(params.spectral, params.pointwise):
        h = jax.nn.gelu(_spectral_conv(h, spec) + h @ pw)
    h = jax.nn.gelu(h @ params.proj1_w + params.proj1_b)
    return h @ params.proj2_w + params.proj2_b


fno_apply_batched = jax.vmap(fno_apply, in_axes=(None, 0))


class FNOTrainResult(NamedTuple):
    params: FNOParams
    loss_history: jnp.ndarray
    opt_state: object = None


@partial(jax.jit, static_argnames=("n_steps", "batch_size", "lr", "schedule",
                                   "total_steps"))
def train_fno(
    params: FNOParams,
    x: jnp.ndarray,     # (N, H, W, C_in)
    y: jnp.ndarray,     # (N, H, W, C_out)
    key,
    *,
    n_steps: int = 500,
    batch_size: int = 8,
    lr: float = 1e-3,
    schedule: str = "const",
    total_steps: int | None = None,
    opt_state=None,
) -> FNOTrainResult:
    """Relative-L2 training run as one compiled scan.

    ``schedule="cosine"`` anneals lr -> lr/300 over ``total_steps``
    (default: this call's ``n_steps``).  Passing the previous call's
    ``opt_state`` chains segments with ONE Adam state end-to-end — the
    schedule continues from the carried step count, so a long anneal can
    be split into short scans without restarting the optimiser (restarts
    plateau ~0.08 rel-L2 on the turbulence task).
    """
    if schedule == "cosine":
        opt = optax.adam(optax.cosine_decay_schedule(
            lr, total_steps or n_steps, alpha=1.0 / 300.0))
    else:
        opt = optax.adam(lr)
    if opt_state is None:
        opt_state = opt.init(params)
    n = x.shape[0]

    def loss_fn(p, xb, yb):
        pred = fno_apply_batched(p, xb)
        num = jnp.sqrt(jnp.sum((pred - yb) ** 2, axis=(1, 2, 3)))
        den = jnp.maximum(jnp.sqrt(jnp.sum(yb**2, axis=(1, 2, 3))), 1e-12)
        return jnp.mean(num / den)

    def step(carry, k):
        p, s = carry
        idx = jax.random.randint(jax.random.fold_in(key, k), (batch_size,), 0, n)
        loss, grads = jax.value_and_grad(loss_fn)(p, x[idx], y[idx])
        updates, s = opt.update(grads, s, p)
        p = optax.apply_updates(p, updates)
        return (p, s), loss

    (params_f, opt_state_f), losses = jax.lax.scan(
        step, (params, opt_state), jnp.arange(n_steps))
    return FNOTrainResult(params_f, losses, opt_state_f)
