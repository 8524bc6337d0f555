"""Universal gyrokinetic-solver contract (GK path A).

JAX-native analogue of the reference's adapter interface
(``core/gk_interface.py:36-169``): one local-parameter contract
(TGLF-10 parameterisation extended with Miller shaping and dimensional
quantities), one output contract, and one abstract solver base that
external-binary adapters and the native quasilinear model both satisfy.

Differences from the reference by design:

* ``GKLocalParams`` is a FROZEN dataclass — hashable, so a params instance
  can ride through ``jax.jit`` static args and ``lru_cache`` compile
  caches;
* ``GKOutput`` is a NamedTuple (a pytree), so batched adapter outputs
  stack naturally under ``jax.vmap``/``jax.tree``.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import numpy as np

SUPPORTED_PHYSICS_MODELS = frozenset({
    "linear_electrostatic",
    "linear_electromagnetic",
    "nonlinear_electrostatic",
    "nonlinear_electromagnetic",
})


@dataclass(frozen=True)
class GKLocalParams:
    """Local plasma parameters at one flux surface (reference
    ``gk_interface.py:37-120`` field-for-field, immutable here).

    The first 11 fields are the TGLF-10 set; the rest add Miller shaping,
    dimensional scales, and the external-solver fidelity contract.
    """

    # Normalised gradients (R / L_x)
    r_l_ti: float
    r_l_te: float
    r_l_ne: float

    # Magnetic geometry
    q: float
    s_hat: float
    alpha_mhd: float = 0.0

    # Dimensionless
    te_ti: float = 1.0
    z_eff: float = 1.5
    nu_star: float = 0.1
    beta_e: float = 0.01
    epsilon: float = 0.1          # r / R

    # Miller shaping
    kappa: float = 1.0
    delta: float = 0.0

    # Dimensional
    rho: float = 0.5              # normalised toroidal flux
    r0: float = 6.2               # major radius [m]
    a: float = 2.0                # minor radius [m]
    b0: float = 5.3               # toroidal field [T]
    n_e: float = 10.0             # electron density [1e19 m^-3]
    t_e_kev: float = 8.0
    t_i_kev: float = 8.0

    # External high-fidelity solver contract
    physics_model: str = "linear_electrostatic"
    n_radial_modes: int = 16
    n_binormal_modes: int = 1
    n_parallel_grid: int = 32
    n_vpar_grid: int = 32
    n_mu_grid: int = 8
    simulation_time: float = 100.0

    def __post_init__(self) -> None:
        if self.physics_model not in SUPPORTED_PHYSICS_MODELS:
            raise ValueError(
                f"physics_model must be one of "
                f"{sorted(SUPPORTED_PHYSICS_MODELS)}, got "
                f"{self.physics_model!r}")
        grids = {
            "n_radial_modes": self.n_radial_modes,
            "n_binormal_modes": self.n_binormal_modes,
            "n_parallel_grid": self.n_parallel_grid,
            "n_vpar_grid": self.n_vpar_grid,
            "n_mu_grid": self.n_mu_grid,
        }
        for name, value in grids.items():
            if value < 1:
                raise ValueError(f"{name} must be positive")
        if self.simulation_time <= 0.0:
            raise ValueError("simulation_time must be positive")
        if self.requires_nonlinear_solver and min(grids.values()) < 2:
            raise ValueError(
                "nonlinear GK requests need a resolved 5D phase-space grid")

    @property
    def requires_nonlinear_solver(self) -> bool:
        return self.physics_model.startswith("nonlinear_")

    @property
    def is_electromagnetic(self) -> bool:
        return self.physics_model.endswith("_electromagnetic")

    @property
    def phase_space_dimensions(self) -> int:
        return 5 if self.requires_nonlinear_solver else 3

    def as_dict(self) -> dict:
        """Plain-float dict for JSON decks (field order preserved)."""
        return {
            k: (v if isinstance(v, (str, int)) else float(v))
            for k, v in self.__dict__.items()
        }


class GKOutput(NamedTuple):
    """Per-flux-surface solver output (reference ``gk_interface.py:123-141``).

    Fluxes in physical [m^2/s]; spectra normalised to c_s/a.
    """

    chi_i: float
    chi_e: float
    d_e: float
    d_i: float = 0.0
    gamma: np.ndarray = field(default_factory=lambda: np.empty(0))  # type: ignore[assignment]
    omega_r: np.ndarray = None  # type: ignore[assignment]
    k_y: np.ndarray = None      # type: ignore[assignment]
    dominant_mode: str = "stable"
    converged: bool = True


def empty_gk_output(*, converged: bool = False,
                    dominant_mode: str = "stable") -> GKOutput:
    z = np.empty(0)
    return GKOutput(chi_i=0.0, chi_e=0.0, d_e=0.0, d_i=0.0,
                    gamma=z, omega_r=z, k_y=z,
                    dominant_mode=dominant_mode, converged=converged)


class GKSolverBase(abc.ABC):
    """Abstract GK solver: deck-file contract shared by external adapters
    and the native model (reference ``gk_interface.py:144-169``)."""

    @abc.abstractmethod
    def prepare_input(self, params: GKLocalParams) -> Path:
        """Write a solver-specific input deck; return its path."""

    @abc.abstractmethod
    def run(self, input_path: Path, *, timeout_s: float = 30.0) -> GKOutput:
        """Execute the solver on a prepared deck and parse the output."""

    @abc.abstractmethod
    def is_available(self) -> bool:
        """True when the backing binary/library/model is usable."""

    def run_from_params(self, params: GKLocalParams, *,
                        timeout_s: float = 30.0) -> GKOutput:
        """Prepare the deck and run, in one call."""
        return self.run(self.prepare_input(params), timeout_s=timeout_s)
