"""Compact differentiable bases for equilibrium exchange (psi + profiles).

JAX-native equivalent of the reference's fixed-basis primitives:

* ``core/jax_chebyshev_psi.py`` — tensor-product Chebyshev expansion of the
  poloidal flux: a solved ``(NZ, NR)`` psi field compressed to a small
  ``n_z x n_r`` coefficient block (contract budget 16x34 on a 65^2 grid),
  with exact-gradient synthesis ``psi = Phi @ c``.
* ``core/jax_profile_basis.py`` — clamped uniform B-spline basis for the
  ``p'(psi_N)`` / ``FF'(psi_N)`` profiles: a 12-coefficient compact
  parameterisation whose design matrix is a partition of unity.
* ``core/jax_continuation_history.py`` — the Anderson-history reset policy
  shared by predictive continuation loops.

Design differences from the reference: both bases share one ``FixedBasis``
container (design built eagerly in NumPy, synthesis/analysis as pure jnp
linear maps), Chebyshev rows come from the cosine form
``T_k(x) = cos(k arccos x)`` and B-spline rows from a vectorised Cox-de Boor
recursion (no SciPy), and the analysis fit solves the normal equations via
QR on the *constant* design so it jits cleanly at any grid size.

Because every basis here is FIXED (knots / grid decided outside tracing),
the design matrix is a constant: synthesis is exactly linear in the
coefficients, so ``jax.grad`` through a downstream equilibrium functional
sees ``d psi / d c = Phi`` with no interpolation noise. That is what makes
these bases usable as the differentiated unknown in IDA-style inference
loops (see ``models/equilibrium/differentiable.py``).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

DEFAULT_PSI_MODES_R = 34   # contract budget: 34 Chebyshev modes across R
DEFAULT_PSI_MODES_Z = 16   # contract budget: 16 Chebyshev modes across Z
DEFAULT_PROFILE_COEFFS = 12
DEFAULT_PROFILE_DEGREE = 3


class BasisError(ValueError):
    """Fail-closed error for ill-posed basis requests."""


# ---------------------------------------------------------------------------
# shared container


@dataclasses.dataclass(frozen=True)
class FixedBasis:
    """A constant linear basis: ``samples = design @ coeffs``.

    ``design`` is a concrete NumPy array built outside tracing; ``synth`` /
    ``fit`` convert it per-call so nothing traced escapes a jit scope.
    """

    design: np.ndarray          # (n_samples, n_coeffs), read-only
    shape: tuple[int, ...]      # natural shape of a synthesised field

    @property
    def n_coeffs(self) -> int:
        return int(self.design.shape[1])

    def synth(self, coeffs: jnp.ndarray) -> jnp.ndarray:
        """Coefficients -> field (exact-gradient linear map)."""
        flat = jnp.asarray(self.design) @ jnp.ravel(coeffs)
        return flat.reshape(self.shape)

    def fit(self, field: jnp.ndarray) -> jnp.ndarray:
        """Field -> least-squares coefficients (differentiable in field).

        Solves ``min ||Phi c - field||`` through a QR factorisation of the
        constant design (well-conditioned for Chebyshev/B-spline bases;
        identifiability is enforced at construction time).
        """
        q, r = jnp.linalg.qr(jnp.asarray(self.design))
        rhs = q.T @ jnp.ravel(jnp.asarray(field))
        return jax_triangular_solve(r, rhs)


def jax_triangular_solve(r: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Upper-triangular solve via lax triangular_solve (matmul-friendly)."""
    from jax import lax

    return lax.linalg.triangular_solve(
        r, b[:, None], left_side=True, lower=False)[:, 0]


# ---------------------------------------------------------------------------
# Chebyshev psi basis


def _unit_interval(coord: np.ndarray, n_modes: int) -> np.ndarray:
    lo, hi = float(coord.min()), float(coord.max())
    if hi == lo:
        if n_modes > 1:
            raise BasisError(
                "degenerate axis span cannot carry more than one mode")
        return np.zeros_like(coord)
    return np.clip(2.0 * (coord - lo) / (hi - lo) - 1.0, -1.0, 1.0)


def _chebyshev_rows(x_unit: np.ndarray, n_modes: int) -> np.ndarray:
    """Rows ``T_0..T_{n-1}(x)`` via the cosine form (|x| <= 1 by mapping)."""
    theta = np.arccos(x_unit)
    k = np.arange(n_modes)
    return np.cos(theta[:, None] * k[None, :])


def chebyshev_psi_basis(
    r_grid: np.ndarray,
    z_grid: np.ndarray,
    n_r: int = DEFAULT_PSI_MODES_R,
    n_z: int = DEFAULT_PSI_MODES_Z,
) -> FixedBasis:
    """Tensor-product Chebyshev basis for a ``(NZ, NR)`` psi field.

    Coefficient ordering is ``jz * n_r + jr`` (row-major over modes), field
    flattening is row-major ``iz * NR + ir`` — matching the free-boundary
    solver's layout. Fails closed when an axis has fewer points than modes
    (non-identifiable fit).
    """
    r = np.asarray(r_grid, dtype=np.float64).ravel()
    z = np.asarray(z_grid, dtype=np.float64).ravel()
    if n_r < 1 or n_z < 1:
        raise BasisError(f"mode counts must be >= 1 (n_r={n_r}, n_z={n_z})")
    if n_r > r.size or n_z > z.size:
        raise BasisError(
            f"under-resolved: NR={r.size} < n_r={n_r} or NZ={z.size} < n_z={n_z}")
    t_r = _chebyshev_rows(_unit_interval(r, n_r), n_r)   # (NR, n_r)
    t_z = _chebyshev_rows(_unit_interval(z, n_z), n_z)   # (NZ, n_z)
    design = np.einsum("zj,ri->zrji", t_z, t_r).reshape(
        z.size * r.size, n_z * n_r)
    design = np.ascontiguousarray(design)
    design.flags.writeable = False
    return FixedBasis(design=design, shape=(z.size, r.size))


# ---------------------------------------------------------------------------
# B-spline profile basis


def _clamped_knots(n_coeff: int, degree: int) -> np.ndarray:
    if n_coeff <= degree:
        raise BasisError(
            f"need n_coeff > degree for a clamped basis "
            f"(n_coeff={n_coeff}, degree={degree})")
    interior = np.linspace(0.0, 1.0, n_coeff - degree + 1)[1:-1]
    return np.concatenate(
        [np.zeros(degree + 1), interior, np.ones(degree + 1)])


def _cox_de_boor(q: np.ndarray, knots: np.ndarray, degree: int) -> np.ndarray:
    """Vectorised Cox-de Boor: all basis functions at all query points.

    Returns ``(len(q), n_coeff)`` with ``n_coeff = len(knots) - degree - 1``.
    """
    n_basis = knots.size - degree - 1
    # Degree 0: indicator of the half-open knot span; close the last span so
    # q = 1 lands in the final basis function.
    left = knots[:-1][None, :]
    right = knots[1:][None, :]
    b = ((q[:, None] >= left) & (q[:, None] < right)).astype(np.float64)
    last = np.searchsorted(knots, 1.0, side="left") - 1
    b[q >= knots[-1], :] = 0.0
    b[q >= knots[-1], last] = 1.0
    for d in range(1, degree + 1):
        nb = b.shape[1] - 1
        new = np.zeros((q.size, nb))
        for j in range(nb):
            denom1 = knots[j + d] - knots[j]
            denom2 = knots[j + d + 1] - knots[j + 1]
            if denom1 > 0.0:
                new[:, j] += (q - knots[j]) / denom1 * b[:, j]
            if denom2 > 0.0:
                new[:, j] += (knots[j + d + 1] - q) / denom2 * b[:, j + 1]
        b = new
    return b[:, :n_basis]


def profile_bspline_basis(
    psin_query: np.ndarray,
    n_coeff: int = DEFAULT_PROFILE_COEFFS,
    degree: int = DEFAULT_PROFILE_DEGREE,
) -> FixedBasis:
    """Clamped uniform B-spline basis on ``psi_N in [0, 1]``.

    Rows are a partition of unity; the spline is anchored to the first/last
    coefficient at the axis/edge. Query points are clipped to the support.
    """
    q = np.clip(np.asarray(psin_query, dtype=np.float64).ravel(), 0.0, 1.0)
    knots = _clamped_knots(n_coeff, degree)
    design = np.ascontiguousarray(_cox_de_boor(q, knots, degree))
    design.flags.writeable = False
    return FixedBasis(design=design, shape=(q.size,))


# ---------------------------------------------------------------------------
# continuation-aware Anderson-history policy


def continuation_history_reset(
    iteration: jnp.ndarray | int,
    *,
    ip_ramp: int,
    separatrix_start: int = 0,
    separatrix_ramp: int = 0,
    use_separatrix: bool = False,
) -> jnp.ndarray:
    """True exactly when a continuation schedule reaches a fixed endpoint.

    Anderson history must stay live while the fixed-point map is still
    moving (unaccelerated Picard continuation diverges), but the first
    iteration of the *stationary* map should start a fresh history — mixing
    differences across the map change poisons the acceleration. Branchless,
    safe inside ``lax.while_loop`` cond/body.
    """
    i = jnp.asarray(iteration)
    at_ip_end = (i > 0) & (i == ip_ramp - 1)
    at_sep_end = jnp.logical_and(
        bool(use_separatrix),
        (i > 0) & (i == separatrix_start + separatrix_ramp - 1))
    return at_ip_end | at_sep_end
