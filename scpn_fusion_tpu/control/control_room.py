"""Fusion control room: VDE closed loop + rendering, scan-fused on device.

Compiled re-design of the reference's control-room simulation
(``control/fusion_control_room.py``): there, ``run_control_room`` (:356-535)
steps a Python loop per frame — reduced vertical-displacement dynamics
(:119-132), a noisy probe (:141-144), a NumPy Kalman observer (:146-184), a
filtered-derivative anti-windup PID with tanh push-pull coil split
(:186-234), and a Miller-parameterised density render per frame (:92-117).
Here the ENTIRE session — plant, sensor, estimator, controller, and every
density frame — is one ``lax.scan`` under jit; the (steps, size, size)
frame stack and all telemetry come back in a single device round trip.

Design delta (deliberate): the reference's observer predicts with a
dt-scaled drift model ``[[1, 0.1], [0, 0.9]]`` that is inconsistent with
its own plant map (:159 vs :119-132) and ignores the control input, and its
PID chases measurement noise through the derivative term — the loop is only
marginally stable (the reference's own loop diverges for some RNG seeds,
e.g. ``default_rng(2)``).  This implementation uses the EXACT discrete
linearisation of the plant (z' = 1.1 z + v + u, v' = 0.9 (v + 0.1 z + u))
with input-aware Kalman prediction, and estimated-state feedback
``u = tanh(-(5 z_hat + 5 v_hat))`` — bounded max |z| across every seed
tested while keeping the reference's probe noise, periodic dropout,
covariance inflation, tanh saturation, and push-pull coil split.

Rendering (status-report PNG + animation GIF, reference :237-354) is a
host-side post-process over the returned arrays, so simulation performance
is independent of matplotlib.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class ControlRoomTrace(NamedTuple):
    """Per-frame telemetry (leaves shaped (steps, ...))."""

    z_true: jnp.ndarray
    z_measured: jnp.ndarray
    z_filtered: jnp.ndarray
    top_action: jnp.ndarray
    bottom_action: jnp.ndarray
    dropout: jnp.ndarray
    density: jnp.ndarray      # (steps, size, size)


class _Carry(NamedTuple):
    z: jnp.ndarray
    v: jnp.ndarray
    kx: jnp.ndarray           # Kalman state (2,)
    kp_cov: jnp.ndarray       # Kalman covariance (2, 2)
    top: jnp.ndarray
    bot: jnp.ndarray


def _miller_density(rr, zz, z_pos, *, r0=3.0, a=1.0, kappa=1.7, delta=0.33,
                    noise=None):
    """Analytic Miller-parameterised normalised density field
    (reference ``solve_flux_surfaces`` :102-116)."""
    dr = rr - r0
    rho_sq = dr**2 + ((zz - z_pos) / kappa) ** 2 - 2.0 * delta * dr * dr**2
    psi = jnp.maximum(rho_sq / a**2, 0.0)
    dens = jnp.where(psi < 1.0, jnp.maximum(1.0 - psi, 0.0) ** 1.5, 0.0)
    if noise is not None:
        dens = jnp.maximum(dens + noise * dens, 0.0)
    return dens, psi


@partial(jax.jit, static_argnames=("steps", "size", "dropout_every"))
def run_control_room_session(
    *,
    steps: int = 200,
    size: int = 60,
    seed: int = 42,
    dropout_every: int = 20,
    psi_kernel: jnp.ndarray | None = None,
):
    """Run the control-room VDE loop; returns ``(trace, summary)``.

    ``psi_kernel``: optional externally solved flux map (the reference's
    kernel-backed Psi lane, :84-101) — normalised and used as the density
    base instead of the analytic Miller geometry.  Summary keys mirror the
    reference's return dict (:512-527).
    """
    if steps < 1:
        raise ValueError("steps must be >= 1.")
    if size < 16:
        raise ValueError("size must be >= 16.")
    key = jax.random.PRNGKey(seed)
    r = jnp.linspace(1.0, 5.0, size, dtype=jnp.float32)
    z_1d = jnp.linspace(-3.0, 3.0, size, dtype=jnp.float32)
    rr, zz = jnp.meshgrid(r, z_1d)

    if psi_kernel is not None:
        pk = jnp.asarray(psi_kernel, jnp.float32)
        pk = (pk - jnp.min(pk)) / jnp.maximum(jnp.ptp(pk), 1e-9)

    # Observer: exact discrete plant linearisation with control input
    # (see module docstring; replaces reference :152-166).
    a_mat = jnp.asarray([[1.1, 1.0], [0.09, 0.9]], jnp.float32)
    b_vec = jnp.asarray([1.0, 0.9], jnp.float32)
    h = jnp.asarray([[1.0, 0.0]], jnp.float32)
    q_cov = jnp.eye(2, dtype=jnp.float32) * 0.01
    r_cov = jnp.asarray([[0.05]], jnp.float32)
    # Estimated-state feedback gains (replaces reference PID :189-206).
    k_z, k_v = 5.0, 5.0

    def step(c: _Carry, inputs):
        k_frame, subkey = inputs
        kd_dist, kd_kick, kd_meas, kd_noise = jax.random.split(subkey, 4)

        # 1. Plant: reduced VDE dynamics (:119-132).
        control_force = (c.bot - c.top) * 0.2
        disturbance = 0.01 * jax.random.normal(kd_dist, (), jnp.float32)
        disturbance += jnp.where(
            jax.random.uniform(kd_kick, (), jnp.float32) < 0.05,
            jnp.float32(0.2), jnp.float32(0.0))
        accel = 0.1 * c.z + control_force + disturbance
        v = (c.v + accel)
        z = c.z + v
        v = v * 0.9

        # 2. Density field for this frame.
        noise = 0.05 * jax.random.normal(kd_noise, rr.shape, jnp.float32)
        if psi_kernel is not None:
            dens = jnp.where(pk < 1.0, jnp.maximum(1.0 - pk, 0.0) ** 1.5, 0.0)
            dens = jnp.maximum(dens + noise * dens, 0.0)
        else:
            dens, _ = _miller_density(rr, zz, z, noise=noise)

        # 3. Noisy probe + periodic dropout glitch (:141-144, :466-467).
        z_meas = z + 0.05 * jax.random.normal(kd_meas, (), jnp.float32)
        dropout = (k_frame % dropout_every) == 0

        # 4. Kalman predict/correct with covariance inflation on dropout
        #    (:168-184), input-aware prediction.
        u_prev = (c.bot - c.top) * jnp.float32(0.2)
        x_pred = a_mat @ c.kx + b_vec * u_prev
        p_pred = a_mat @ c.kp_cov @ a_mat.T + q_cov
        innov = z_meas - (h @ x_pred)[0]
        s = (h @ p_pred @ h.T + r_cov)[0, 0]
        k_gain = (p_pred @ h.T)[:, 0] / s
        x_corr = x_pred + k_gain * innov
        p_corr = (jnp.eye(2, dtype=jnp.float32)
                  - jnp.outer(k_gain, h[0])) @ p_pred
        kx = jnp.where(dropout, x_pred, x_corr)
        kp_cov = jnp.where(dropout, p_pred * 1.2, p_corr)
        z_filt = kx[0]

        # 5. Estimated-state feedback, tanh-saturated push-pull split
        #    (reference action split :230-234 retained).
        force = jnp.tanh(-(k_z * kx[0] + k_v * kx[1]))
        top = jnp.where(force > 0.0, 0.0, jnp.abs(force))
        bot = jnp.where(force > 0.0, jnp.abs(force), 0.0)

        out = ControlRoomTrace(z, z_meas, z_filt, top, bot, dropout, dens)
        return _Carry(z, v, kx, kp_cov, top, bot), out

    init = _Carry(
        z=jnp.float32(0.0), v=jnp.float32(0.0),
        kx=jnp.zeros((2,), jnp.float32),
        kp_cov=jnp.eye(2, dtype=jnp.float32) * 0.1,
        top=jnp.float32(0.0), bot=jnp.float32(0.0),
    )
    keys = jax.random.split(key, steps)
    _, trace = jax.lax.scan(step, init, (jnp.arange(steps), keys))

    summary = {
        "final_z": trace.z_true[-1],
        "mean_abs_z": jnp.mean(jnp.abs(trace.z_true)),
        "max_abs_z": jnp.max(jnp.abs(trace.z_true)),
        "mean_top_action": jnp.mean(trace.top_action),
        "mean_bottom_action": jnp.mean(trace.bottom_action),
        "estimator_rmse": jnp.sqrt(
            jnp.mean((trace.z_filtered - trace.z_true) ** 2)),
        "measurement_rmse": jnp.sqrt(
            jnp.mean((trace.z_measured - trace.z_true) ** 2)),
    }
    return trace, summary


def render_control_room_report(
    trace: ControlRoomTrace,
    path_png: str,
    *,
    path_gif: str | None = None,
    gif_stride: int = 4,
) -> dict:
    """Host-side rendering of the status report (and optionally the GIF
    animation), mirroring the reference's dark-theme layout (:237-354).
    Returns ``{"report_saved", "animation_saved", ...}``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dens = np.asarray(trace.density)
    z_hist = np.asarray(trace.z_true)
    top = np.asarray(trace.top_action)
    bot = np.asarray(trace.bottom_action)
    n = z_hist.shape[0]

    fig = plt.figure(figsize=(12, 8), facecolor="#1e1e1e")
    gs = fig.add_gridspec(2, 2)
    ax_plasma = fig.add_subplot(gs[:, 0])
    ax_plasma.set_facecolor("black")
    ax_plasma.set_title("Tokamak Cross-Section (final)", color="white")
    im = ax_plasma.imshow(dens[-1], extent=(1.0, 5.0, -3.0, 3.0),
                          origin="lower", cmap="plasma", vmin=0.0, vmax=1.0)
    ax_trace = fig.add_subplot(gs[0, 1])
    ax_trace.set_facecolor("#2e2e2e")
    ax_trace.set_title("Vertical Displacement (Z-Pos)", color="white")
    ax_trace.plot(z_hist, "c", lw=2)
    ax_trace.axhline(0.0, color="r", ls="--", alpha=0.5)
    ax_trace.grid(True, color="#444")
    ax_coils = fig.add_subplot(gs[1, 1])
    ax_coils.set_facecolor("#2e2e2e")
    ax_coils.set_title("PF Coil Commands", color="white")
    ax_coils.plot(top, "r", label="Top")
    ax_coils.plot(bot, "b", label="Bottom")
    ax_coils.legend()
    fig.tight_layout()
    result = {"report_saved": False, "animation_saved": False,
              "report_error": None, "animation_error": None}
    try:
        fig.savefig(path_png)
        result["report_saved"] = True
    except (OSError, RuntimeError, ValueError) as exc:
        result["report_error"] = str(exc)

    if path_gif is not None:
        try:
            from matplotlib.animation import FuncAnimation, PillowWriter
            frames = list(range(0, n, max(1, gif_stride)))

            def update(i):
                im.set_data(dens[frames[i]])
                return (im,)

            ani = FuncAnimation(fig, update, frames=len(frames),
                                interval=100, blit=True)
            ani.save(path_gif, writer=PillowWriter(fps=10))
            result["animation_saved"] = True
        except (OSError, RuntimeError, ValueError) as exc:
            result["animation_error"] = str(exc)
    plt.close(fig)
    return result
