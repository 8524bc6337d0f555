"""Typed, fail-closed reactor configuration.

JAX-native equivalent of the reference's pydantic schema
(``core/config_schema.py:31-102``) and JSON config loading
(``fusion_kernel.py:135-156``).  Instead of pydantic models we use frozen
dataclasses: they are hashable, so a full ``ReactorConfig`` can be passed as a
*static* argument to ``jax.jit`` — the geometry and solver controls shape the
compiled program, while runtime quantities (coil currents, targets) travel as
traced arrays.

Validation is fail-closed: every field is checked for finiteness and range at
construction, mirroring the reference's ``allow_inf_nan=False`` stance.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Mapping

MAX_CONFIG_BYTES = 10 * 1024 * 1024
MU0 = 4.0e-7 * math.pi


class ConfigError(ValueError):
    """Raised when a reactor configuration fails validation."""


def _require_finite(name: str, value: float) -> float:
    v = float(value)
    if not math.isfinite(v):
        raise ConfigError(f"{name} must be finite, got {value!r}")
    return v


@dataclasses.dataclass(frozen=True)
class Dimensions:
    """Rectangular (R, Z) domain bounds [m]."""

    R_min: float
    R_max: float
    Z_min: float
    Z_max: float

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            _require_finite(f.name, getattr(self, f.name))
        if self.R_min <= 0.0:
            raise ConfigError("R_min must be > 0")
        if self.R_max <= self.R_min:
            raise ConfigError("R_max must be greater than R_min")
        if self.Z_max <= self.Z_min:
            raise ConfigError("Z_max must be greater than Z_min")


@dataclasses.dataclass(frozen=True)
class Coil:
    """Axisymmetric poloidal-field coil: position, current, turns."""

    r: float
    z: float
    current: float = 0.0
    turns: int = 1
    name: str = "unnamed"

    def __post_init__(self) -> None:
        _require_finite("r", self.r)
        _require_finite("z", self.z)
        _require_finite("current", self.current)
        if self.r <= 0.0:
            raise ConfigError("coil r must be > 0")
        if self.turns < 1:
            raise ConfigError("coil turns must be >= 1")


@dataclasses.dataclass(frozen=True)
class ProfileParams:
    """mtanh pedestal profile shape (reference ``fusion_kernel.py:180-200``)."""

    ped_top: float = 0.92
    ped_width: float = 0.05
    ped_height: float = 1.0
    core_alpha: float = 0.3

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            _require_finite(f.name, getattr(self, f.name))
        if self.ped_width <= 0.0:
            raise ConfigError("ped_width must be > 0")
        if not 0.0 < self.ped_top <= 1.0:
            raise ConfigError("ped_top must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Physics controls for equilibrium solves.

    Mirrors reference ``config_schema.py:59-67`` defaults.
    """

    plasma_current_target: float = 5.0
    vacuum_permeability: float = MU0
    beta_scale: float = 1.0
    profile_mode: str = "l-mode"  # "l-mode" | "h-mode"
    p_prime: ProfileParams = ProfileParams()
    ff_prime: ProfileParams = ProfileParams()

    def __post_init__(self) -> None:
        _require_finite("plasma_current_target", self.plasma_current_target)
        _require_finite("vacuum_permeability", self.vacuum_permeability)
        if self.vacuum_permeability < 0.0:
            raise ConfigError("vacuum_permeability must be >= 0")
        if self.profile_mode not in ("l-mode", "h-mode"):
            raise ConfigError(f"profile_mode must be 'l-mode' or 'h-mode', got {self.profile_mode!r}")


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Nonlinear solver controls (reference ``config_schema.py:70-77``).

    ``solver_method`` selects the inner elliptic step per Picard iteration:
    ``"jacobi"`` | ``"sor"`` | ``"anderson"`` | ``"multigrid"`` | ``"newton"``.
    """

    max_iterations: int = 1000
    convergence_threshold: float = 1e-4
    relaxation_factor: float = 0.1
    solver_method: str = "multigrid"
    sor_omega: float = 1.6
    anderson_depth: int = 5
    inner_sweeps: int = 1
    gs_residual_threshold: float = 0.0  # 0 -> disabled (update-diff criterion only)
    mg_pre_smooth: int = 3
    mg_post_smooth: int = 3
    mg_min_grid: int = 5

    def __post_init__(self) -> None:
        if self.max_iterations <= 0:
            raise ConfigError("max_iterations must be > 0")
        if not self.convergence_threshold > 0:
            raise ConfigError("convergence_threshold must be > 0")
        if not 0.0 < self.relaxation_factor <= 1.0:
            raise ConfigError("relaxation_factor must be in (0, 1]")
        if not 1.0 <= self.sor_omega < 2.0:
            raise ConfigError("sor_omega must satisfy 1.0 <= omega < 2.0")
        if self.solver_method not in ("jacobi", "sor", "anderson",
                                      "multigrid", "anderson_mg", "newton"):
            raise ConfigError(f"unknown solver_method {self.solver_method!r}")
        if self.inner_sweeps < 1:
            raise ConfigError("inner_sweeps must be >= 1")


@dataclasses.dataclass(frozen=True)
class ReactorConfig:
    """Top-level validated reactor configuration (hashable, jit-static)."""

    dimensions: Dimensions
    reactor_name: str = "Unnamed-Reactor"
    grid_resolution: tuple[int, int] = (129, 129)  # (NR, NZ)
    coils: tuple[Coil, ...] = ()
    physics: PhysicsParams = PhysicsParams()
    solver: SolverParams = SolverParams()

    def __post_init__(self) -> None:
        nr, nz = self.grid_resolution
        if nr < 4 or nz < 4:
            raise ConfigError("grid resolution must be at least 4x4")

    @property
    def NR(self) -> int:
        return int(self.grid_resolution[0])

    @property
    def NZ(self) -> int:
        return int(self.grid_resolution[1])


def _parse_profiles(physics_raw: Mapping[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    profiles = physics_raw.get("profiles")
    if profiles:
        out["profile_mode"] = profiles.get("mode", "l-mode")
        for key in ("p_prime", "ff_prime"):
            if key in profiles:
                out[key] = ProfileParams(**{
                    k: v for k, v in profiles[key].items()
                    if k in {f.name for f in dataclasses.fields(ProfileParams)}
                })
    return out


def config_from_dict(raw: Mapping[str, Any]) -> ReactorConfig:
    """Build a validated ``ReactorConfig`` from a raw (JSON-shaped) mapping.

    Accepts the same JSON shape as the reference's config files
    (``core/default_config.json``, ``validation/*.json``): extension keys are
    ignored rather than rejected, matching the reference's ``extra='allow'``.

    Fail-closed: any malformed shape — wrong container type, missing key,
    non-numeric leaf — raises :class:`ConfigError`, never an uncontrolled
    ``TypeError``/``KeyError`` (hypothesis fuzz lane contract,
    ``tests/test_fuzz_parsers.py``).
    """
    try:
        return _config_from_dict_unchecked(raw)
    except ConfigError:
        raise
    except (TypeError, KeyError, AttributeError, IndexError,
            ValueError, OverflowError) as exc:
        raise ConfigError(f"malformed config: {exc}") from exc


def _config_from_dict_unchecked(raw: Mapping[str, Any]) -> ReactorConfig:
    dims_raw = raw.get("dimensions")
    if dims_raw is None:
        raise ConfigError("config is missing required 'dimensions'")
    dims = Dimensions(
        R_min=dims_raw["R_min"], R_max=dims_raw["R_max"],
        Z_min=dims_raw["Z_min"], Z_max=dims_raw["Z_max"],
    )

    coils = tuple(
        Coil(
            r=c["r"], z=c["z"], current=c.get("current", 0.0),
            turns=int(c.get("turns", 1)), name=c.get("name", "unnamed"),
        )
        for c in raw.get("coils", ())
    )

    phys_raw = dict(raw.get("physics", {}))
    phys_kwargs: dict[str, Any] = {}
    for key in ("plasma_current_target", "vacuum_permeability", "beta_scale"):
        if key in phys_raw:
            phys_kwargs[key] = phys_raw[key]
    phys_kwargs.update(_parse_profiles(phys_raw))
    physics = PhysicsParams(**phys_kwargs)

    solver_raw = dict(raw.get("solver", {}))
    solver_kwargs = {
        k: solver_raw[k]
        for k in {f.name for f in dataclasses.fields(SolverParams)}
        if k in solver_raw
    }
    solver = SolverParams(**solver_kwargs)

    res = raw.get("grid_resolution", (129, 129))
    return ReactorConfig(
        reactor_name=str(raw.get("reactor_name", "Unnamed-Reactor")),
        grid_resolution=(int(res[0]), int(res[1])),
        dimensions=dims,
        coils=coils,
        physics=physics,
        solver=solver,
    )


def load_config(path: str | Path, *, max_bytes: int = MAX_CONFIG_BYTES) -> ReactorConfig:
    """Load and validate a reactor configuration from a JSON file.

    Size-capped, fail-closed (reference ``io/safe_loaders.py`` +
    ``fusion_kernel.py:135-156`` semantics).
    """
    p = Path(path)
    size = p.stat().st_size
    if size > max_bytes:
        raise ConfigError(f"configuration file exceeds {max_bytes} byte limit: {p}")
    with open(p, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    if not isinstance(raw, dict):
        raise ConfigError("top-level config JSON must be an object")
    return config_from_dict(raw)
