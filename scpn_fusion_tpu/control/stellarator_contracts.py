"""Stellarator control contracts: typed actuator/diagnostic/objective specs.

JAX-native port of the reference's
``control/stellarator_control_contracts.py:32-290``: fail-closed frozen
dataclasses describing a stellarator control problem — magnetic
configuration identity, actuator channels with hard clamps and slew
limits, diagnostic channels/frames, control objectives, and replayable
scenarios.  These are HOST-side contracts (validation happens once at
construction); the numeric clamp/slew operations are jnp-compatible so a
compiled control loop can apply them to traced values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import jax.numpy as jnp


def _require_finite(name: str, value: float) -> float:
    value = float(value)
    if not math.isfinite(value):
        raise ValueError(f"{name} must be finite")
    return value


@dataclasses.dataclass(frozen=True)
class MagneticConfiguration:
    """Named magnetic configuration the controller is certified for."""

    name: str
    n_fp: int
    iota_edge: float
    mirror_ratio: float

    def __post_init__(self) -> None:
        if not self.name.strip():
            raise ValueError("name must be non-empty")
        if self.n_fp < 1:
            raise ValueError("n_fp must be >= 1")
        _require_finite("iota_edge", self.iota_edge)
        _require_finite("mirror_ratio", self.mirror_ratio)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ActuatorChannel:
    """One actuator with hard limits + slew constraint.

    ``clamp``/``apply_slew`` accept traced jnp values, so a jitted loop
    enforces the same contract the host validation promises.
    """

    name: str
    unit: str
    min_value: float
    max_value: float
    max_slew_per_s: float

    def __post_init__(self) -> None:
        if not self.name.strip():
            raise ValueError("actuator name must be non-empty")
        _require_finite("min_value", self.min_value)
        _require_finite("max_value", self.max_value)
        if self.max_value <= self.min_value:
            raise ValueError("max_value must exceed min_value")
        if not (self.max_slew_per_s > 0.0
                and math.isfinite(self.max_slew_per_s)):
            raise ValueError("max_slew_per_s must be positive and finite")

    def clamp(self, value):
        return jnp.clip(value, self.min_value, self.max_value)

    def apply_slew(self, previous, requested, dt_s: float):
        if dt_s <= 0.0:
            raise ValueError("dt_s must be > 0")
        max_delta = self.max_slew_per_s * dt_s
        limited = previous + jnp.clip(requested - previous,
                                      -max_delta, max_delta)
        return self.clamp(limited)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ActuatorSet:
    """Ordered actuator channels with unique names."""

    channels: tuple[ActuatorChannel, ...]

    def __post_init__(self) -> None:
        if not self.channels:
            raise ValueError("ActuatorSet needs at least one channel")
        names = [c.name for c in self.channels]
        if len(set(names)) != len(names):
            raise ValueError("actuator names must be unique")

    def by_name(self, name: str) -> ActuatorChannel:
        for c in self.channels:
            if c.name == name:
                return c
        raise KeyError(f"no actuator named {name!r}")

    def to_dict(self) -> dict:
        return {"channels": [c.to_dict() for c in self.channels]}


@dataclasses.dataclass(frozen=True)
class DiagnosticChannel:
    """One diagnostic signal with a validity band."""

    name: str
    unit: str
    valid_min: float
    valid_max: float

    def __post_init__(self) -> None:
        if not self.name.strip():
            raise ValueError("diagnostic name must be non-empty")
        _require_finite("valid_min", self.valid_min)
        _require_finite("valid_max", self.valid_max)
        if self.valid_max <= self.valid_min:
            raise ValueError("valid_max must exceed valid_min")

    def is_valid(self, value) -> bool:
        v = float(value)
        return math.isfinite(v) and self.valid_min <= v <= self.valid_max

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DiagnosticFrame:
    """One time-stamped diagnostic sample, validated against channels."""

    time_s: float
    values: tuple[tuple[str, float], ...]

    def __post_init__(self) -> None:
        _require_finite("time_s", self.time_s)
        names = [k for k, _ in self.values]
        if len(set(names)) != len(names):
            raise ValueError("duplicate diagnostic names in frame")
        for k, v in self.values:
            _require_finite(f"values[{k}]", v)

    def as_mapping(self) -> Mapping[str, float]:
        return dict(self.values)

    def validate_against(self, channels: tuple[DiagnosticChannel, ...]) -> list[str]:
        """Names of frame values violating their channel's validity band."""
        by_name = {c.name: c for c in channels}
        bad = []
        for k, v in self.values:
            ch = by_name.get(k)
            if ch is not None and not ch.is_valid(v):
                bad.append(k)
        return bad


@dataclasses.dataclass(frozen=True)
class ControlObjective:
    """A tracked objective with target band and weight."""

    name: str
    target: float
    band: float
    weight: float = 1.0

    def __post_init__(self) -> None:
        if not self.name.strip():
            raise ValueError("objective name must be non-empty")
        _require_finite("target", self.target)
        if not (self.band > 0.0 and math.isfinite(self.band)):
            raise ValueError("band must be positive and finite")
        if not (self.weight >= 0.0 and math.isfinite(self.weight)):
            raise ValueError("weight must be non-negative and finite")

    def normalised_error(self, value):
        """(value - target) / band; jnp-compatible."""
        return (value - self.target) / self.band

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ReplayScenario:
    """A replayable control scenario: configuration + actuators +
    diagnostics + objectives (the certification artifact the reference's
    replay pipeline consumes)."""

    name: str
    configuration: MagneticConfiguration
    actuators: ActuatorSet
    diagnostics: tuple[DiagnosticChannel, ...]
    objectives: tuple[ControlObjective, ...]

    def __post_init__(self) -> None:
        if not self.name.strip():
            raise ValueError("scenario name must be non-empty")
        if not self.diagnostics:
            raise ValueError("scenario needs at least one diagnostic")
        if not self.objectives:
            raise ValueError("scenario needs at least one objective")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "configuration": self.configuration.to_dict(),
            "actuators": self.actuators.to_dict(),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "objectives": [o.to_dict() for o in self.objectives],
        }
