"""Free-boundary shape-control machinery: response matrices + targets.

JAX-native port of the reference's shape-control depth
(VERDICT.md r1 missing #3):

* magnetic-probe response matrix — flux-loop rows (direct Green's-function
  flux) + B_R/B_Z probe rows (central finite difference of the same flux
  kernel, so the inverse fit uses ONE consistent magnetic model), reference
  ``fusion_kernel_free_boundary.py:315-374``;
* coil-current reconstruction from magnetics — weighted, Tikhonov-
  regularised around the prior, box-bounded (:376-489) — here a projected
  FISTA (``ops/lstsq.py``) instead of scipy's trf so the whole inverse fit
  is jittable and differentiable;
* isoflux / X-point-null / strike-point target machinery (:491-559 +
  ``resolve_shape_target_flux`` :584-609), generalised: targets are rows of
  one linear system in the coil currents, so mixed target sets solve in a
  single bounded LSQ;
* von Hagenow wall response ``M[wall, interior]``
  (``jax_free_boundary_predictive.py:160-202``): the plasma's flux
  contribution on the computational wall as ONE matmul per Picard step.

Everything here is pure-JAX: response assembly is ``vmap`` over
coils/points (batched elliptic-integral evaluation feeding matmuls —
work, not host loops).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.core.special import green_coil_psi
from scpn_fusion_tpu.models.equilibrium.free_boundary import (
    CoilSet,
    interp_psi_at_points,
    mutual_inductance_matrix,
)
from scpn_fusion_tpu.ops.lstsq import bounded_lstsq

MU0_SI = 4.0e-7 * jnp.pi


# ── Probe response (flux loops + B probes) ───────────────────────────────


def _coil_flux_at(coil_r, coil_z, turns, r_obs, z_obs, mu0):
    return turns * green_coil_psi(coil_r, coil_z, r_obs, z_obs, mu0)


def probe_response_matrix(
    coils: CoilSet,
    *,
    flux_points: jnp.ndarray | None = None,     # (n_flux, 2)
    b_probe_points: jnp.ndarray | None = None,  # (n_b, 2)
    b_probe_dirs: jnp.ndarray | None = None,    # (n_b,) 0 = B_R, 1 = B_Z
    mu0: float = float(MU0_SI),
) -> jnp.ndarray:
    """Diagnostic response matrix ``(n_flux + n_b, n_coils)``.

    B rows use central differences of the flux kernel with the reference's
    step rule (``fusion_kernel_free_boundary.py:296-312``):
    ``B_R = -(1/R) dpsi/dZ``, ``B_Z = (1/R) dpsi/dR``.
    """
    if flux_points is None and b_probe_points is None:
        raise ValueError("need flux_points and/or b_probe_points")
    blocks = []
    if flux_points is not None:
        r_o, z_o = flux_points[:, 0], flux_points[:, 1]

        def flux_col(rc, zc, t):
            return _coil_flux_at(rc, zc, t, r_o, z_o, mu0)

        blocks.append(jax.vmap(flux_col, out_axes=1)(
            coils.r, coils.z, coils.turns))
    if b_probe_points is not None:
        if b_probe_dirs is None:
            raise ValueError("b_probe_dirs required with b_probe_points")
        r_o, z_o = b_probe_points[:, 0], b_probe_points[:, 1]
        eps_r = jnp.maximum(1e-5, 1e-5 * jnp.abs(r_o))
        eps_z = jnp.maximum(1e-5, 1e-5 * (1.0 + jnp.abs(z_o)))
        r_safe = jnp.maximum(r_o, eps_r)

        def b_col(rc, zc, t):
            b_r = -(_coil_flux_at(rc, zc, t, r_safe, z_o + eps_z, mu0)
                    - _coil_flux_at(rc, zc, t, r_safe, z_o - eps_z, mu0)) / (
                2.0 * eps_z * r_safe)
            b_z = (_coil_flux_at(rc, zc, t, r_safe + eps_r, z_o, mu0)
                   - _coil_flux_at(rc, zc, t, r_safe - eps_r, z_o, mu0)) / (
                2.0 * eps_r * r_safe)
            return jnp.where(b_probe_dirs == 0, b_r, b_z)

        blocks.append(jax.vmap(b_col, out_axes=1)(
            coils.r, coils.z, coils.turns))
    return jnp.concatenate(blocks, axis=0)


class ReconstructionResult(NamedTuple):
    coil_currents: jnp.ndarray
    residual: jnp.ndarray
    weighted_residual_rms: jnp.ndarray
    residual_rms: jnp.ndarray


def reconstruct_coil_currents(
    response: jnp.ndarray,        # (n_meas, n_coils)
    measurements: jnp.ndarray,    # (n_meas,)
    prior: jnp.ndarray,           # (n_coils,) prior currents
    *,
    sigma: jnp.ndarray | None = None,
    tikhonov_alpha: float | jnp.ndarray = 1e-6,
    current_limits: jnp.ndarray | None = None,
    n_iter: int = 300,
) -> ReconstructionResult:
    """Fit bounded coil currents from magnetics (reference :376-489).

    Weighted Tikhonov LSQ regularised AROUND THE PRIOR currents:
    ``min ||W (R I - m)||^2 + ||sqrt(alpha) (I - I_prior)||^2`` s.t. box
    bounds.  ``tikhonov_alpha`` may be a scalar or a per-column vector —
    the vector form anchors directly-instrumented channels (coil leads
    carry Rogowski measurements, so their commanded values are strong
    priors) harder than free channels (plasma-surrogate filaments).
    """
    dtype = response.dtype
    w = jnp.ones(response.shape[0], dtype) if sigma is None else 1.0 / sigma
    n_coils = response.shape[1]
    sq = jnp.sqrt(jnp.broadcast_to(
        jnp.asarray(tikhonov_alpha, dtype), (n_coils,)))
    a = jnp.concatenate([response * w[:, None], jnp.diag(sq)])
    b = jnp.concatenate([measurements * w, sq * prior])
    if current_limits is not None:
        lb, ub = -jnp.abs(current_limits), jnp.abs(current_limits)
    else:
        big = jnp.full((n_coils,), 1e30, dtype)
        lb, ub = -big, big
    # No x0: the prior is already anchored via the Tikhonov rows above; the
    # exact unconstrained-lstsq warm start is required for the near-exact
    # recovery gate when alpha is tiny (bounded_lstsq honors x0 verbatim
    # since the ADVICE r2 fix, so passing the prior would cold-start FISTA).
    currents = bounded_lstsq(a, b, lb, ub, n_iter=n_iter)
    residual = response @ currents - measurements
    return ReconstructionResult(
        coil_currents=currents,
        residual=residual,
        weighted_residual_rms=jnp.sqrt(jnp.mean((residual * w) ** 2)),
        residual_rms=jnp.sqrt(jnp.mean(residual**2)),
    )


def synthetic_magnetics(
    psi_total: jnp.ndarray,
    grid: Grid,
    *,
    flux_points: jnp.ndarray | None = None,
    b_probe_points: jnp.ndarray | None = None,
    b_probe_dirs: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Forward-model magnetics from a solved flux map (synthetic sensors).

    Flux loops read psi directly; B probes read
    ``B_R = -(1/R) dpsi/dZ``, ``B_Z = (1/R) dpsi/dR`` from central
    differences of the grid field, interpolated at probe points — the same
    convention as :func:`probe_response_matrix` so closed-loop
    reconstruction is self-consistent.
    """
    out = []
    if flux_points is not None:
        out.append(interp_psi_at_points(psi_total, grid, flux_points))
    if b_probe_points is not None:
        dpsi_dz = jnp.gradient(psi_total, grid.dZ, axis=0)
        dpsi_dr = jnp.gradient(psi_total, grid.dR, axis=1)
        rr = jnp.maximum(grid.RR, 1e-6)
        b_r_grid = -dpsi_dz / rr
        b_z_grid = dpsi_dr / rr
        b_r = interp_psi_at_points(b_r_grid, grid, b_probe_points)
        b_z = interp_psi_at_points(b_z_grid, grid, b_probe_points)
        out.append(jnp.where(b_probe_dirs == 0, b_r, b_z))
    return jnp.concatenate(out)


# ── Shape-target machinery (isoflux / X-point null / strike points) ─────


class ShapeTargets(NamedTuple):
    """Mixed shape-control target set, all optional (None = absent).

    isoflux_points : (n_iso, 2) points whose flux must equal the flux at
        ``isoflux_reference`` (a single (2,) point, e.g. on the desired LCFS).
    flux_points / flux_values : explicit psi targets (n_f, 2) / (n_f,).
    x_points : (n_x, 2) desired field nulls — adds B_R = 0 AND B_Z = 0 rows.
    strike_points : (n_s, 2) divertor-plate points pinned to the reference
        (separatrix) flux — isoflux rows against the same reference point.
    weights : per-family scalar weights (iso, flux, xnull, strike).
    """

    isoflux_points: jnp.ndarray | None = None
    isoflux_reference: jnp.ndarray | None = None
    flux_points: jnp.ndarray | None = None
    flux_values: jnp.ndarray | None = None
    x_points: jnp.ndarray | None = None
    strike_points: jnp.ndarray | None = None
    weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


def _plasma_b_at_points(psi_plasma, grid, points):
    dpsi_dz = jnp.gradient(psi_plasma, grid.dZ, axis=0)
    dpsi_dr = jnp.gradient(psi_plasma, grid.dR, axis=1)
    rr = jnp.maximum(grid.RR, 1e-6)
    b_r = interp_psi_at_points(-dpsi_dz / rr, grid, points)
    b_z = interp_psi_at_points(dpsi_dr / rr, grid, points)
    return b_r, b_z


def build_shape_system(
    coils: CoilSet,
    targets: ShapeTargets,
    psi_plasma: jnp.ndarray,
    grid: Grid,
    *,
    mu0: float = float(MU0_SI),
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Assemble (A, b) rows over coil currents for the mixed target set.

    Row semantics: ``A @ I = b`` where the coil contribution must supply
    whatever the (fixed) plasma contribution does not.  Isoflux rows are
    DIFFERENCES of response rows, so the absolute flux level drops out —
    the reference's iso-level resolution (``resolve_shape_target_flux``)
    realised without the mean-level heuristic.
    """
    w_iso, w_flux, w_xn, w_strike = targets.weights
    rows, rhs = [], []

    def iso_rows(points, ref_point, weight):
        m_pts = mutual_inductance_matrix(
            coils.r, coils.z, coils.turns, points, mu0).T        # (n, n_coils)
        m_ref = mutual_inductance_matrix(
            coils.r, coils.z, coils.turns, ref_point[None, :], mu0).T  # (1, nc)
        psi_p = interp_psi_at_points(psi_plasma, grid, points)
        psi_ref = interp_psi_at_points(psi_plasma, grid, ref_point[None, :])
        rows.append(weight * (m_pts - m_ref))
        rhs.append(weight * (psi_ref - psi_p))

    if targets.isoflux_points is not None:
        if targets.isoflux_reference is None:
            raise ValueError("isoflux_points needs isoflux_reference")
        iso_rows(targets.isoflux_points, targets.isoflux_reference, w_iso)
    if targets.strike_points is not None:
        if targets.isoflux_reference is None:
            raise ValueError("strike_points needs isoflux_reference")
        iso_rows(targets.strike_points, targets.isoflux_reference, w_strike)
    if targets.flux_points is not None:
        m_pts = mutual_inductance_matrix(
            coils.r, coils.z, coils.turns, targets.flux_points, mu0).T
        psi_p = interp_psi_at_points(psi_plasma, grid, targets.flux_points)
        rows.append(w_flux * m_pts)
        rhs.append(w_flux * (targets.flux_values - psi_p))
    if targets.x_points is not None:
        n_x = targets.x_points.shape[0]
        dirs_r = jnp.zeros((n_x,), jnp.int32)
        dirs_z = jnp.ones((n_x,), jnp.int32)
        resp_r = probe_response_matrix(
            coils, b_probe_points=targets.x_points, b_probe_dirs=dirs_r,
            mu0=mu0)
        resp_z = probe_response_matrix(
            coils, b_probe_points=targets.x_points, b_probe_dirs=dirs_z,
            mu0=mu0)
        b_r_p, b_z_p = _plasma_b_at_points(psi_plasma, grid, targets.x_points)
        rows.append(w_xn * resp_r)
        rhs.append(w_xn * (-b_r_p))
        rows.append(w_xn * resp_z)
        rhs.append(w_xn * (-b_z_p))
    if not rows:
        raise ValueError("ShapeTargets is empty")
    return jnp.concatenate(rows, axis=0), jnp.concatenate(rhs)


def optimize_shape_currents(
    coils: CoilSet,
    targets: ShapeTargets,
    psi_plasma: jnp.ndarray,
    grid: Grid,
    *,
    tikhonov_alpha: float = 1e-4,
    mu0: float = float(MU0_SI),
    n_iter: int = 300,
) -> jnp.ndarray:
    """Bounded Tikhonov solve of the mixed shape system for coil currents."""
    a, b = build_shape_system(coils, targets, psi_plasma, grid, mu0=mu0)
    dtype = a.dtype
    n_coils = a.shape[1]
    sq = jnp.sqrt(jnp.asarray(tikhonov_alpha, dtype))
    a_aug = jnp.concatenate([a, sq * jnp.eye(n_coils, dtype=dtype)])
    b_aug = jnp.concatenate([b, sq * coils.currents])
    if coils.current_limits is not None:
        lb, ub = -jnp.abs(coils.current_limits), jnp.abs(coils.current_limits)
    else:
        big = jnp.full((n_coils,), 1e30, dtype)
        lb, ub = -big, big
    return bounded_lstsq(a_aug, b_aug, lb, ub, x0=coils.currents,
                         n_iter=n_iter)


# ── Von Hagenow wall response ────────────────────────────────────────────


def wall_indices(nz: int, nr: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Flat indices of the computational-wall ring and interior cells
    (reference ``_wall_source_indices``).  Computed host-side with NumPy —
    the ring size is a static property of the grid, so the index arrays are
    compile-time constants inside jit."""
    import numpy as np

    mask = np.zeros((nz, nr), bool)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    flat = mask.reshape(-1)
    return jnp.asarray(np.where(flat)[0]), jnp.asarray(np.where(~flat)[0])


@partial(jax.jit, static_argnames=("grid",))
def wall_response_matrix(
    grid: Grid, mu0: float = float(MU0_SI)
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Von Hagenow response ``M[wall, interior]`` + (wall, interior) indices.

    ``M[b, s]`` = flux at wall point b per unit toroidal current at interior
    cell s.  Geometry-only: computed once per grid, reused every Picard step
    as ``psi_wall = M @ (J_phi_interior * dA)`` — one matmul
    (reference ``jax_free_boundary_predictive.py:177-202``).
    """
    b_idx, s_idx = wall_indices(grid.NZ, grid.NR)
    rr = grid.RR.reshape(-1)
    zz = grid.ZZ.reshape(-1)
    r_wall, z_wall = rr[b_idx], zz[b_idx]
    r_src, z_src = rr[s_idx], zz[s_idx]

    def column(rs, zs):
        return green_coil_psi(rs, zs, r_wall, z_wall, mu0)

    m = jax.vmap(column, in_axes=(0, 0), out_axes=1)(r_src, z_src)
    return m, b_idx, s_idx


def plasma_wall_flux(
    m: jnp.ndarray,
    b_idx: jnp.ndarray,
    s_idx: jnp.ndarray,
    j_phi: jnp.ndarray,
    d_area: float,
    shape: tuple[int, int],
) -> jnp.ndarray:
    """Scatter the plasma-induced wall flux into a full (NZ, NR) field
    (zero in the interior) — add to the coil vacuum flux for the
    free-boundary Dirichlet ring."""
    wall_vals = m @ (j_phi.reshape(-1)[s_idx] * d_area)
    out = jnp.zeros(shape[0] * shape[1], j_phi.dtype)
    return out.at[b_idx].set(wall_vals).reshape(shape)
