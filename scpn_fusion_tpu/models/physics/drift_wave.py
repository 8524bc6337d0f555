"""2D Hasegawa-Wakatani drift-wave turbulence for edge-chaos forecasting.

JAX-native port of the reference's turbulence-oracle physics half
(``core/turbulence_oracle.py:29-143`` ``DriftWavePhysics``): the two-field
Hasegawa-Wakatani system for electrostatic potential ``phi`` and density
fluctuation ``n`` on a doubly periodic box,

    dw/dt = -[phi, w] + alpha (phi - n) - nu k^4 w        (w = -k^2 phi)
    dn/dt = -[phi, n] + alpha (phi - n) - kappa d_y phi - nu k^4 n,

with pseudo-spectral Poisson brackets (2/3-rule de-aliased), 4th-order
hyperviscosity, RK4 time stepping, and the reference's amplitude clamp
(rescale when max|phi_k| > 100).

Where the reference advances one step per host call over NumPy FFTs
(``DriftWavePhysics.step:82-143``), the whole trajectory here is ONE
``lax.scan`` over jnp FFTs: probe harvesting happens inside the scan so a
1000-step chaos run returns only the (steps, n_probes) probe matrix, never
materialising the full field history.  The amplitude clamp is branchless
(``jnp.where`` scale) so the program stays trace-static.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

GRID = 64
BOX_L = 10.0


@dataclasses.dataclass(frozen=True)
class DriftWaveConfig:
    """Hasegawa-Wakatani parameters (reference module constants :20-26)."""

    n: int = GRID
    box_l: float = BOX_L
    alpha: float = 0.1      # adiabaticity
    kappa: float = 0.5      # density-gradient drive
    nu: float = 0.01        # hyperviscosity coefficient
    dt: float = 0.01        # RK4 step (reference ``local_dt`` :90)
    clamp_amp: float = 100.0
    init_noise: float = 0.01


class DriftWaveState(NamedTuple):
    phi_k: jnp.ndarray   # complex spectrum (N, N)
    n_k: jnp.ndarray     # complex spectrum (N, N)


class _Operators(NamedTuple):
    kx: jnp.ndarray
    ky: jnp.ndarray
    k2: jnp.ndarray
    k2_safe: jnp.ndarray
    mask: jnp.ndarray
    dissip: jnp.ndarray


def _operators(cfg: DriftWaveConfig, dtype=jnp.float32) -> _Operators:
    """Spectral grids, 2/3 de-aliasing mask, and the nu*k^4 multiplier
    (reference ``__init__`` :36-49 + ``spectral_dissipation_multiplier``)."""
    k = jnp.fft.fftfreq(cfg.n, d=cfg.box_l / (2.0 * jnp.pi * cfg.n)).astype(dtype)
    kx, ky = jnp.meshgrid(k, k)
    k2 = kx ** 2 + ky ** 2
    k2_safe = k2.at[0, 0].set(1.0)
    k_max = jnp.max(jnp.abs(k))
    mask = jnp.where(k2 < (2.0 / 3.0 * k_max) ** 2, 1.0, 0.0).astype(dtype)
    dissip = cfg.nu * k2 ** 2   # 4th-order hyperviscosity (order // 2 = 2)
    return _Operators(kx, ky, k2, k2_safe, mask, dissip)


def initial_state(key, cfg: DriftWaveConfig = DriftWaveConfig(),
                  dtype=jnp.float32) -> DriftWaveState:
    """Random small-amplitude noise, masked (reference :50-58)."""
    ops = _operators(cfg, dtype)
    k_phi, k_n = jax.random.split(key)
    phi = cfg.init_noise * jax.random.normal(k_phi, (cfg.n, cfg.n), dtype)
    n = cfg.init_noise * jax.random.normal(k_n, (cfg.n, cfg.n), dtype)
    cplx = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    return DriftWaveState(
        phi_k=(jnp.fft.fft2(phi) * ops.mask).astype(cplx),
        n_k=(jnp.fft.fft2(n) * ops.mask).astype(cplx),
    )


def _bracket(a_k, b_k, ops: _Operators):
    """Poisson bracket [A, B] = dxA dyB - dyA dxB, de-aliased (reference
    ``bracket`` :60-74)."""
    dxa = jnp.fft.ifft2(1j * ops.kx * a_k).real
    dya = jnp.fft.ifft2(1j * ops.ky * a_k).real
    dxb = jnp.fft.ifft2(1j * ops.kx * b_k).real
    dyb = jnp.fft.ifft2(1j * ops.ky * b_k).real
    return jnp.fft.fft2(dxa * dyb - dya * dxb) * ops.mask


def _rhs(state: DriftWaveState, cfg: DriftWaveConfig, ops: _Operators):
    """Hasegawa-Wakatani RHS in spectral space (reference ``rhs`` :92-125)."""
    p = state.phi_k * ops.mask
    n = state.n_k * ops.mask
    w = -ops.k2 * p
    coupling = cfg.alpha * (p - n)
    dw_dt = -_bracket(p, w, ops) + coupling - ops.dissip * w
    dp_dt = -dw_dt / ops.k2_safe
    dp_dt = dp_dt.at[0, 0].set(0.0)     # zero-mean potential
    dn_dt = (-_bracket(p, n, ops) + coupling
             - cfg.kappa * (1j * ops.ky * p) - ops.dissip * n)
    return DriftWaveState(dp_dt, dn_dt)


def step(state: DriftWaveState, cfg: DriftWaveConfig,
         ops: _Operators | None = None) -> DriftWaveState:
    """One RK4 step + branchless amplitude clamp (reference :127-143)."""
    if ops is None:
        ops = _operators(cfg, jnp.float32)
    dt = cfg.dt

    def add(s, k, c):
        return DriftWaveState(s.phi_k + c * k.phi_k, s.n_k + c * k.n_k)

    k1 = _rhs(state, cfg, ops)
    k2 = _rhs(add(state, k1, 0.5 * dt), cfg, ops)
    k3 = _rhs(add(state, k2, 0.5 * dt), cfg, ops)
    k4 = _rhs(add(state, k3, dt), cfg, ops)
    phi_k = state.phi_k + (dt / 6.0) * (k1.phi_k + 2 * k2.phi_k
                                        + 2 * k3.phi_k + k4.phi_k)
    n_k = state.n_k + (dt / 6.0) * (k1.n_k + 2 * k2.n_k
                                    + 2 * k3.n_k + k4.n_k)
    # Stability clamp: rescale only when max|phi_k| exceeds the cap.
    max_amp = jnp.max(jnp.abs(phi_k))
    scale = jnp.where(max_amp > cfg.clamp_amp, cfg.clamp_amp
                      / jnp.maximum(max_amp, 1e-30), 1.0)
    return DriftWaveState(phi_k * scale, n_k * scale)


def real_fields(state: DriftWaveState):
    """(phi, n) in real space."""
    return jnp.fft.ifft2(state.phi_k).real, jnp.fft.ifft2(state.n_k).real


def default_probe_indices(n: int = GRID, n_probes: int = 16) -> jnp.ndarray:
    """Sparse-sensing probe locations (reference ``run_turbulence_oracle``
    :244 — 16 equispaced points of the flattened field)."""
    return jnp.linspace(0, n * n - 1, n_probes).astype(jnp.int32)


@partial(jax.jit, static_argnames=("cfg", "warmup", "steps"))
def simulate_probes(state: DriftWaveState, cfg: DriftWaveConfig,
                    probe_idx: jnp.ndarray, warmup: int,
                    steps: int) -> tuple[DriftWaveState, jnp.ndarray]:
    """Warm up ``warmup`` steps, then record ``steps`` probe rows.

    The whole run is two scans in one jitted program; only the
    (steps, n_probes) probe matrix leaves the device.
    """
    ops = _operators(cfg, jnp.float32)

    def warm_body(s, _):
        return step(s, cfg, ops), None

    state, _ = jax.lax.scan(warm_body, state, None, length=warmup)

    def rec_body(s, _):
        s2 = step(s, cfg, ops)
        phi = jnp.fft.ifft2(s2.phi_k).real
        return s2, phi.reshape(-1)[probe_idx]

    state, probes = jax.lax.scan(rec_body, state, None, length=steps)
    return state, probes
