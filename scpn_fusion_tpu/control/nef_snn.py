"""NEF-style spiking control channel (nengo-wrapper parity, nengo-free).

JAX-native port of the reference's ``control/nengo_snn_wrapper.py:40-411``.
The reference's own fallback path implements the Neural Engineering
Framework directly (LIF populations with NEF gain/bias, least-squares
decoders, low-pass synapses) and only optionally wraps nengo; this image
has no nengo, so the NEF path IS the lane — here as pure JAX:

* LIF membrane dynamics with exact per-step integration
  ``V(t+dt) = J + (V - J) exp(-dt/tau_rc)`` and refractory clamping
  (Eliasmith & Anderson 2003, Eq. 4.10-4.12);
* analytic steady-state rates + Tikhonov NEF decoders (LstsqL2 parity);
* a control channel (error population -> gain decoder -> control
  population -> identity decoder, low-pass synapses between stages)
  whose whole trajectory runs as ONE ``lax.scan``.

``nengo_available()`` reports the optional upstream package honestly.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def nengo_available() -> bool:
    try:
        import nengo  # noqa: F401
        return True
    except ImportError:
        return False


@dataclasses.dataclass(frozen=True)
class NefConfig:
    """Channel knobs (reference ``NengoSNNConfig`` :46-61)."""

    n_neurons: int = 64
    dt: float = 1e-3
    tau_mem: float = 0.02          # tau_rc
    tau_ref: float = 0.002
    tau_synapse: float = 0.01
    max_rate_hz: float = 200.0
    intercept_lo: float = -0.9
    intercept_hi: float = 0.9
    gain: float = 1.0
    seed: int = 0


class LIFParams(NamedTuple):
    alpha: jnp.ndarray       # (n,) NEF gain
    j_bias: jnp.ndarray      # (n,)
    encoders: jnp.ndarray    # (n,) +-1


class LIFState(NamedTuple):
    voltage: jnp.ndarray
    ref_time: jnp.ndarray


def make_lif_population(cfg: NefConfig, rng: np.random.Generator,
                        dtype=jnp.float32) -> LIFParams:
    """NEF gain/bias from per-neuron (max_rate, intercept)."""
    n = cfg.n_neurons
    max_rates = rng.uniform(cfg.max_rate_hz * 0.5, cfg.max_rate_hz, n)
    intercepts = rng.uniform(cfg.intercept_lo, cfg.intercept_hi, n)
    encoders = rng.choice([-1.0, 1.0], n)
    j_max = 1.0 / (1.0 - np.exp((cfg.tau_ref - 1.0 / max_rates)
                                / cfg.tau_mem))
    alpha = (j_max - 1.0) / (1.0 - intercepts)
    j_bias = 1.0 - alpha * intercepts
    return LIFParams(alpha=jnp.asarray(alpha, dtype),
                     j_bias=jnp.asarray(j_bias, dtype),
                     encoders=jnp.asarray(encoders, dtype))


def lif_init(cfg: NefConfig, dtype=jnp.float32) -> LIFState:
    z = jnp.zeros((cfg.n_neurons,), dtype)
    return LIFState(voltage=z, ref_time=z)


def lif_step(cfg: NefConfig, pop: LIFParams, state: LIFState, x):
    """One exact-integration LIF step; returns (state, spike rates)."""
    j = pop.alpha * pop.encoders * x + pop.j_bias
    delta = jnp.clip(cfg.dt - state.ref_time, 0.0, cfg.dt)
    v = j + (state.voltage - j) * jnp.exp(-delta / cfg.tau_mem)
    spiked = v >= 1.0
    v = jnp.where(spiked, 0.0, v)
    ref = jnp.where(spiked, cfg.tau_ref, state.ref_time)
    ref = jnp.maximum(ref - cfg.dt, 0.0)
    rates = spiked.astype(v.dtype) / cfg.dt
    return LIFState(voltage=v, ref_time=ref), rates


def steady_rates(cfg: NefConfig, pop: LIFParams,
                 x_eval: jnp.ndarray) -> jnp.ndarray:
    """Analytic steady-state firing rates, shape (n, len(x_eval))."""
    j = (pop.alpha[:, None] * pop.encoders[:, None] * x_eval[None, :]
         + pop.j_bias[:, None])
    ok = j > 1.0
    safe_j = jnp.where(ok, j, 2.0)
    rates = 1.0 / (cfg.tau_ref - cfg.tau_mem * jnp.log1p(-1.0 / safe_j))
    return jnp.where(ok, rates, 0.0)


def nef_decoder(cfg: NefConfig, pop: LIFParams, fn, *, n_eval: int = 200,
                reg: float = 0.1) -> jnp.ndarray:
    """Tikhonov least-squares decoder for fn(x) (LstsqL2 parity)."""
    x = jnp.linspace(-1.0, 1.0, n_eval)
    a = steady_rates(cfg, pop, x)
    y = fn(x)
    aat = a @ a.T
    gamma = n_eval * reg * jnp.maximum(jnp.max(a), 1e-10) ** 2
    return jnp.linalg.solve(
        aat + gamma * jnp.eye(pop.alpha.shape[0], dtype=a.dtype), a @ y)


class NefChannel(NamedTuple):
    """One control channel: error pop -> gain -> control pop -> output."""

    error_pop: LIFParams
    control_pop: LIFParams
    d_gain: jnp.ndarray
    d_id: jnp.ndarray


def make_channel(cfg: NefConfig, dtype=jnp.float32) -> NefChannel:
    rng = np.random.default_rng(cfg.seed)
    err_pop = make_lif_population(cfg, rng, dtype)
    ctl_pop = make_lif_population(cfg, rng, dtype)
    d_gain = nef_decoder(cfg, err_pop, lambda x: cfg.gain * x)
    d_id = nef_decoder(cfg, ctl_pop, lambda x: x)
    return NefChannel(error_pop=err_pop, control_pop=ctl_pop,
                      d_gain=d_gain, d_id=d_id)


class ChannelState(NamedTuple):
    err_lif: LIFState
    ctl_lif: LIFState
    syn_in: jnp.ndarray
    syn_mid: jnp.ndarray
    syn_out: jnp.ndarray


def channel_init(cfg: NefConfig, dtype=jnp.float32) -> ChannelState:
    z = jnp.asarray(0.0, dtype)
    return ChannelState(err_lif=lif_init(cfg, dtype),
                        ctl_lif=lif_init(cfg, dtype),
                        syn_in=z, syn_mid=z, syn_out=z)


def _lowpass(y, x, tau, dt):
    a = jnp.exp(-dt / tau)
    return a * y + (1.0 - a) * x


def channel_step(cfg: NefConfig, ch: NefChannel, state: ChannelState, x):
    """One channel tick: synapse -> spikes -> decode -> synapse -> ..."""
    syn_in = _lowpass(state.syn_in, x, cfg.tau_synapse, cfg.dt)
    err_lif, err_spikes = lif_step(cfg, ch.error_pop, state.err_lif, syn_in)
    decoded = ch.d_gain @ err_spikes
    syn_mid = _lowpass(state.syn_mid, decoded, cfg.tau_synapse, cfg.dt)
    ctl_lif, ctl_spikes = lif_step(cfg, ch.control_pop, state.ctl_lif,
                                   syn_mid)
    out_raw = ch.d_id @ ctl_spikes
    syn_out = _lowpass(state.syn_out, out_raw, cfg.tau_synapse, cfg.dt)
    new_state = ChannelState(err_lif=err_lif, ctl_lif=ctl_lif,
                             syn_in=syn_in, syn_mid=syn_mid,
                             syn_out=syn_out)
    return new_state, syn_out


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run_channel(cfg: NefConfig, ch: NefChannel, x_trace: jnp.ndarray,
                *, n_steps: int | None = None):
    """Whole channel trajectory as one scan; returns output trace."""
    def step(state, x):
        return channel_step(cfg, ch, state, x)

    state0 = channel_init(cfg, x_trace.dtype)
    _, out = jax.lax.scan(step, state0, x_trace)
    return out
