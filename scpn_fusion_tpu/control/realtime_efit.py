"""Realtime EFIT: equilibrium reconstruction from magnetics in one matmul.

Role-parity with the reference's rt-EFIT (``control/realtime_efit.py:112``
``RealtimeEFIT`` over ``MagneticDiagnostics``: flux loops, B probes,
Rogowski Ip, polynomial p'/FF' source basis, Tikhonov-regularised linear
reconstruction) and its kinetic-EFIT cousin (``core/kinetic_efit.py``).

accelerator-first architecture: ALL geometry-dependent work happens once at build
time —

* basis current distributions J_k(R, Z) (p' modes ~ R * psi_norm^k and
  FF' modes ~ psi_norm^k / R over a parameterised plasma mask),
* their Green's-function responses at every flux loop / B probe,
* the coil responses at the same sensors,
* the regularised normal-equation solve operator

— so one reconstruction at runtime is `coeffs = P @ residual_measurements`
(a single small matmul) followed by `psi = coeffs @ basis_maps` (one
contraction).  The whole `reconstruct` path jits, vmaps over measurement
batches, and is differentiable through to the sensor values.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.core.special import green_coil_psi

MU0 = 4.0e-7 * jnp.pi


@dataclasses.dataclass(frozen=True)
class MagneticsLayout:
    """Sensor geometry (reference ``MagneticDiagnostics`` contract)."""

    flux_loops: tuple            # ((r, z), ...)
    b_probes: tuple              # ((r, z, "R"|"Z"), ...)
    coil_r: tuple
    coil_z: tuple

    def __post_init__(self):
        if len(self.flux_loops) + len(self.b_probes) < 4:
            raise ValueError("need at least 4 magnetic sensors")
        for r, z, d in self.b_probes:
            if d not in ("R", "Z"):
                raise ValueError("B probe direction must be 'R' or 'Z'")


def _sensor_responses(src_r, src_z, layout: MagneticsLayout):
    """Unit-current responses of one source filament at every sensor."""
    def psi_at(rl, zl):
        return green_coil_psi(src_r, src_z, jnp.asarray(rl),
                              jnp.asarray(zl), MU0)

    flux = jnp.stack([psi_at(r, z) for r, z in layout.flux_loops]) \
        if layout.flux_loops else jnp.zeros((0,))

    probes = []
    for r, z, direction in layout.b_probes:
        if direction == "Z":
            # B_Z = (1/R) dpsi/dR
            g = jax.grad(lambda rr: green_coil_psi(
                src_r, src_z, rr, jnp.asarray(z), MU0))(jnp.asarray(r))
            probes.append(g / r)
        else:
            # B_R = -(1/R) dpsi/dZ
            g = jax.grad(lambda zz: green_coil_psi(
                src_r, src_z, jnp.asarray(r), zz, MU0))(jnp.asarray(z))
            probes.append(-g / r)
    b = jnp.stack(probes) if probes else jnp.zeros((0,))
    return jnp.concatenate([flux, b])


class EFITModel(NamedTuple):
    """Precomputed reconstruction operator (geometry-static)."""

    basis_maps: jnp.ndarray       # (n_k, NZ, NR) psi map per unit coeff
    basis_sensor: jnp.ndarray     # (n_sensors, n_k)
    basis_ip: jnp.ndarray         # (n_k,) plasma current per unit coeff
    coil_sensor: jnp.ndarray      # (n_sensors, n_coils)
    coil_maps: jnp.ndarray        # (n_coils, NZ, NR)
    solve_op: jnp.ndarray         # (n_k, n_sensors + 1) Tikhonov inverse
    ip_weight: jnp.ndarray        # weight of the Ip constraint row
    r_1d: jnp.ndarray
    z_1d: jnp.ndarray


class EFITResult(NamedTuple):
    psi: jnp.ndarray
    coeffs: jnp.ndarray
    ip_reconstructed: jnp.ndarray
    axis_r: jnp.ndarray
    axis_z: jnp.ndarray
    residual_norm: jnp.ndarray


def build_efit_model(grid: Grid, layout: MagneticsLayout, *,
                     r_axis: float, z_axis: float = 0.0,
                     a_minor: float = 1.0, kappa: float = 1.6,
                     n_p_modes: int = 3, n_ff_modes: int = 3,
                     tikhonov: float = 1e-3,
                     ip_weight: float = 10.0) -> EFITModel:
    """Build all response matrices once per machine geometry.

    The source basis lives on a parameterised elliptical plasma region
    around (r_axis, z_axis): s = normalised flux-surface label of the seed
    shape; p' modes carry J ~ R s^k, FF' modes J ~ s^k / R (the reference's
    EFIT-compatible polynomial basis, ``realtime_efit.py:119-131``).
    """
    rr, zz = grid.RR, grid.ZZ
    s2 = (((rr - r_axis) / a_minor) ** 2
          + ((zz - z_axis) / (kappa * a_minor)) ** 2)
    s = jnp.sqrt(jnp.clip(s2, 0.0, 1.0))
    inside = (s2 < 1.0).astype(rr.dtype)
    shape = (1.0 - s ** 2) * inside       # peaked flux-label weight

    bases = []
    for k in range(n_p_modes):
        bases.append(rr / r_axis * shape ** (k + 1))
    for k in range(n_ff_modes):
        bases.append(r_axis / rr * shape ** (k + 1))
    j_basis = jnp.stack(bases)            # (n_k, NZ, NR) current density

    d_area = grid.dR * grid.dZ
    basis_ip = jnp.sum(j_basis, axis=(1, 2)) * d_area

    # Discretised Green's responses: every grid cell is a filament.
    def map_and_sense(j_k):
        def cell(r_c, z_c, w):
            return w * _sensor_responses(r_c, z_c, layout)
        w = (j_k * d_area).ravel()
        sens = jax.vmap(cell)(rr.ravel(), zz.ravel(), w).sum(axis=0)
        # psi map of the basis on the grid itself (for reconstruction
        # output): Green over all cell pairs is O(N^2) — use the same
        # filament sum but at grid nodes, vectorised.
        return sens

    basis_sensor = jnp.stack([map_and_sense(j) for j in j_basis], axis=1)

    def psi_map(j_k):
        w = (j_k * d_area).ravel()
        src_r, src_z = rr.ravel(), zz.ravel()
        # Exclude the self-cell (log-singular Green's function) — its
        # principal-value contribution is O(dA log dA) and negligible.
        eps2 = 0.25 * (grid.dR ** 2 + grid.dZ ** 2)

        def at_point(robs, zobs):
            g = green_coil_psi(src_r, src_z, robs, zobs, MU0)
            d2 = (src_r - robs) ** 2 + (src_z - zobs) ** 2
            return jnp.sum(jnp.where(d2 > eps2, g * w, 0.0))

        return jax.vmap(jax.vmap(at_point))(rr, zz)

    basis_maps = jnp.stack([psi_map(j) for j in j_basis])

    coil_r = jnp.asarray(layout.coil_r)
    coil_z = jnp.asarray(layout.coil_z)
    coil_sensor = jnp.stack(
        [_sensor_responses(coil_r[i], coil_z[i], layout)
         for i in range(coil_r.shape[0])], axis=1)
    coil_maps = jax.vmap(
        lambda rc, zc: green_coil_psi(rc, zc, rr, zz, MU0))(coil_r, coil_z)

    # Tikhonov-regularised solve operator with the Ip constraint appended
    # as a weighted row: A = [basis_sensor; w * basis_ip].
    a = jnp.concatenate(
        [basis_sensor, ip_weight * basis_ip[None, :]], axis=0)
    gram = a.T @ a + tikhonov * jnp.eye(a.shape[1], dtype=a.dtype)
    solve_op = jnp.linalg.solve(gram, a.T)

    return EFITModel(basis_maps=basis_maps, basis_sensor=basis_sensor,
                     basis_ip=basis_ip, coil_sensor=coil_sensor,
                     coil_maps=coil_maps, solve_op=solve_op,
                     ip_weight=jnp.asarray(ip_weight, basis_ip.dtype),
                     r_1d=grid.R, z_1d=grid.Z)


@jax.jit
def reconstruct(model: EFITModel, measurements: jnp.ndarray,
                coil_currents: jnp.ndarray,
                ip_target: jnp.ndarray) -> EFITResult:
    """One rt reconstruction: subtract coil contributions, solve for the
    basis coefficients, assemble psi.  Pure matmuls — microseconds warm."""
    resid = measurements - model.coil_sensor @ coil_currents
    rhs = jnp.concatenate(
        [resid, model.ip_weight * jnp.atleast_1d(ip_target)])
    coeffs = model.solve_op @ rhs
    psi = (jnp.tensordot(coeffs, model.basis_maps, axes=(0, 0))
           + jnp.tensordot(coil_currents, model.coil_maps, axes=(0, 0)))
    ip_rec = model.basis_ip @ coeffs
    fit = model.basis_sensor @ coeffs
    residual_norm = jnp.linalg.norm(fit - resid)

    # Magnetic axis: argmax of psi inside the grid (soft-free; rt usage
    # tolerates grid resolution here, subgrid refinement lives in
    # control/flight_sim.subgrid_axis).
    idx = jnp.argmax(psi)
    nz, nr = psi.shape
    iz, ir = idx // nr, idx % nr
    return EFITResult(psi=psi, coeffs=coeffs, ip_reconstructed=ip_rec,
                      axis_r=model.r_1d[ir], axis_z=model.z_1d[iz],
                      residual_norm=residual_norm)


def synthetic_measurements(model: EFITModel, coeffs: jnp.ndarray,
                           coil_currents: jnp.ndarray) -> jnp.ndarray:
    """Forward model: sensor values for known basis coeffs (test fixture
    role of the reference's ``MagneticDiagnostics.measure``)."""
    return model.basis_sensor @ coeffs + model.coil_sensor @ coil_currents
