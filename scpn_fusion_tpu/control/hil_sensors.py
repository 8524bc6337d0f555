"""ADC/DAC sensor–actuator boundary for the HIL harness.

JAX-native counterpart of the reference's converter layer
(``control/hil_sensors.py:25-127``): ADC quantisation + Gaussian
measurement noise on the sensor side, range-clamped slew-rate-limited
DAC output with a fail-safe hold on non-finite commands on the actuator
side, plus the magnetic-probe (±1.5 V ↔ ±10 T) and coil-current
(±10 V ↔ ±50 kA) scale adapters.

Design deltas:

* The reference's ``SensorInterface`` mutates ``_last_dac_voltage`` and
  a ``np.random.default_rng`` — here the converter is a pure function
  over an explicit ``DacState`` pytree and a ``jax.random`` key, so a
  whole closed HIL loop (sensor → controller → actuator → plant) runs
  inside one ``lax.scan`` and channel banks vectorise with ``vmap``
  (the reference loops one converter per channel).
* The non-finite-command fault is branch-free: ``jnp.where`` holds the
  last valid output and increments a fault counter carried in state —
  identical fail-safe-hold semantics, jittable.
* Quantisation uses the same code mapping: clip → noise → round to the
  (2^bits − 1)-level code → reconstruct at LSB resolution.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class AdcConfig:
    """ADC configuration (reference defaults: 12-bit, ±1.5 V, 0.5 LSB rms)."""

    resolution_bits: int = 12
    v_min: float = -1.5
    v_max: float = 1.5
    noise_rms_lsb: float = 0.5

    @property
    def n_levels(self) -> int:
        return (1 << int(self.resolution_bits)) - 1

    @property
    def lsb_voltage(self) -> float:
        return (self.v_max - self.v_min) / self.n_levels


@dataclasses.dataclass(frozen=True)
class DacConfig:
    """DAC configuration (reference defaults: 16-bit, ±10 V, 50 V/µs)."""

    resolution_bits: int = 16
    v_min: float = -10.0
    v_max: float = 10.0
    slew_rate_v_per_us: float = 50.0


class DacState(NamedTuple):
    """Actuator carry: last applied voltage(s) + fault count."""

    last_voltage: jnp.ndarray   # scalar or (channels,)
    faults: jnp.ndarray         # int32, same shape


def dac_init(n_channels: int | None = None) -> DacState:
    shape = () if n_channels is None else (n_channels,)
    return DacState(last_voltage=jnp.zeros(shape),
                    faults=jnp.zeros(shape, jnp.int32))


def read_adc(true_voltage: jnp.ndarray, key: jax.Array,
             cfg: AdcConfig = AdcConfig()) -> jnp.ndarray:
    """Clip, add converter noise, and quantise (reference ``read_adc``)."""
    v = jnp.clip(true_voltage, cfg.v_min, cfg.v_max)
    v = v + cfg.noise_rms_lsb * cfg.lsb_voltage \
        * jax.random.normal(key, jnp.shape(v))
    code = jnp.round((v - cfg.v_min) / (cfg.v_max - cfg.v_min)
                     * cfg.n_levels)
    code = jnp.clip(code, 0, cfg.n_levels)
    return cfg.v_min + code * cfg.lsb_voltage


def write_dac(state: DacState, target_voltage: jnp.ndarray,
              *, dt_us: float = 1.0,
              cfg: DacConfig = DacConfig()) -> tuple[DacState, jnp.ndarray]:
    """Slew-limited, range-clamped output with fail-safe hold.

    Returns the voltage PHYSICALLY applied; callers must drive the plant
    with it, never the raw command (reference ``write_dac`` contract).
    """
    finite = jnp.isfinite(target_voltage)
    target = jnp.clip(jnp.where(finite, target_voltage, 0.0),
                      cfg.v_min, cfg.v_max)
    max_change = cfg.slew_rate_v_per_us * dt_us
    delta = jnp.clip(target - state.last_voltage, -max_change, max_change)
    proposed = state.last_voltage + delta
    output = jnp.where(finite, proposed, state.last_voltage)
    return (DacState(last_voltage=output,
                     faults=state.faults + (~finite).astype(jnp.int32)),
            output)


# Scale adapters — the reference's physical channel mappings.
B_FULL_SCALE_T = 10.0       # ±1.5 V ADC ↔ ±10 T probe
I_FULL_SCALE_KA = 50.0      # ±10 V DAC ↔ ±50 kA coil


def read_magnetic_probe(b_true_t: jnp.ndarray, key: jax.Array,
                        adc: AdcConfig = AdcConfig()) -> jnp.ndarray:
    v = b_true_t * (adc.v_max / B_FULL_SCALE_T)
    return read_adc(v, key, adc) * (B_FULL_SCALE_T / adc.v_max)


def write_coil_current(state: DacState, target_ka: jnp.ndarray,
                       *, dt_us: float = 1.0,
                       dac: DacConfig = DacConfig()
                       ) -> tuple[DacState, jnp.ndarray]:
    v = target_ka * (dac.v_max / I_FULL_SCALE_KA)
    state, out_v = write_dac(state, v, dt_us=dt_us, cfg=dac)
    return state, out_v * (I_FULL_SCALE_KA / dac.v_max)


def converter_loop(commands_v: jnp.ndarray, *, dt_us: float = 1.0,
                   dac: DacConfig = DacConfig()) -> tuple[DacState,
                                                          jnp.ndarray]:
    """Run a command sequence through the DAC as one scan (any channels)."""
    n_ch = commands_v.shape[1] if commands_v.ndim > 1 else None
    state0 = dac_init(n_ch)

    def step(state, cmd):
        state, out = write_dac(state, cmd, dt_us=dt_us, cfg=dac)
        return state, out

    return jax.lax.scan(step, state0, commands_v)
