"""n=0 rigid-body stability: ring forces, stiffness matrix, field index.

Covers the reference's ``core/stability_analyzer.py`` ``StabilityAnalyzer``
(vacuum-field interpolation + decay index ``:37-77``, Shafranov hoop +
Lorentz ring forces ``calculate_forces:79-124``, stiffness-matrix
eigenvalue analysis ``analyze_stability:126-185``, and the force
landscape ``plot_stability_landscape:243``) with a JAX-native design:

* field interpolation is differentiable bilinear sampling
  (``map_coordinates`` order=1) of the grid-difference gradients, so the
  whole force model is a smooth jnp function of ``(R, Z)``;
* the stiffness matrix is the **exact Jacobian** ``K = -dF/d(R,Z)`` via
  ``jax.jacfwd`` — no 1 cm finite-difference probes, and the cross
  terms ``K_RZ``, ``K_ZR`` come out for free (the reference zeroes
  them, ``:158-159``);
* the 2x2 eigenvalues are closed-form (trace/determinant), which stays
  jittable on accelerators where general nonsymmetric ``eig`` is host-only;
* the stability landscape is one ``vmap`` over query points returning
  arrays (rendering belongs to the dashboard generator, not here).

The reference's ``analyze_mhd_stability:186`` dispatch (Mercier +
ballooning from profiles) already exists in this repo as
``models/physics/stability_mhd.run_full_stability_check``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates

from scpn_fusion_tpu.core.grid import Grid

MU0 = 4.0e-7 * jnp.pi


class RingForces(NamedTuple):
    f_r_n: jnp.ndarray       # total radial force [N]
    f_z_n: jnp.ndarray       # total vertical force [N]
    f_hoop_n: jnp.ndarray
    f_lorentz_r_n: jnp.ndarray
    f_lorentz_z_n: jnp.ndarray
    n_index: jnp.ndarray     # field decay index


class RigidBodyReport(NamedTuple):
    forces: RingForces
    stiffness_n_m: jnp.ndarray     # 2x2, K = -dF/d(R,Z)
    eigenvalues: jnp.ndarray       # complex64/128 pair (closed form)
    radial_stable: jnp.ndarray     # bool: Re(lambda_R) > 0
    vertical_stable: jnp.ndarray   # bool: Re(lambda_Z) > 0
    n_index_ok: jnp.ndarray        # bool: 0 < n < 1.5


def _sample(field: jnp.ndarray, grid: Grid, r, z) -> jnp.ndarray:
    """Differentiable bilinear sample of a (NZ, NR) field at (r, z)."""
    ir = (jnp.asarray(r) - grid.R_min) / grid.dR
    iz = (jnp.asarray(z) - grid.Z_min) / grid.dZ
    return map_coordinates(field, [jnp.atleast_1d(iz), jnp.atleast_1d(ir)],
                           order=1, mode="nearest")[0]


def vacuum_field_at(psi_vac: jnp.ndarray, grid: Grid, r, z):
    """``(Bz, Br, n_index)`` at (R, Z) from the vacuum flux map
    (reference ``get_vacuum_field_at:37-77``).

    ``Bz = (1/R) dPsi/dR``, ``Br = -(1/R) dPsi/dZ``,
    ``n = -(R/Bz) dBz/dR``.  The grid-difference gradient fields are
    sampled bilinearly, so the result is smooth in (R, Z) and the
    decay index uses a second sampled derivative instead of nested
    finite differences at one grid node.
    """
    dpsi_dr = jnp.gradient(psi_vac, grid.dR, axis=1)
    dpsi_dz = jnp.gradient(psi_vac, grid.dZ, axis=0)
    r = jnp.asarray(r)
    bz_field = dpsi_dr / jnp.maximum(grid.RR, 1e-9)
    bz = _sample(bz_field, grid, r, z)
    br = -_sample(dpsi_dz, grid, r, z) / r
    dbz_dr = _sample(jnp.gradient(bz_field, grid.dR, axis=1), grid, r, z)
    n_index = -r / jnp.where(jnp.abs(bz) > 1e-12, bz,
                             jnp.sign(bz) * 1e-12 + 1e-15) * dbz_dr
    return bz, br, n_index


def ring_forces(
    psi_vac: jnp.ndarray,
    grid: Grid,
    r,
    z,
    ip_ma,
    *,
    beta_p: float = 0.5,
    li: float = 0.8,
    minor_radius_fraction: float = 1.0 / 3.0,
) -> RingForces:
    """Forces on the rigid plasma ring (reference ``calculate_forces:79``).

    Hoop (Shafranov): ``F = (mu0 Ip^2 / 2)(ln(8R/a) + beta_p + li/2 - 3/2)/R``
    with ``a = R * minor_radius_fraction``; Lorentz: ``F_R = Ip Bz 2 pi R``,
    ``F_Z = -Ip Br 2 pi R``.
    """
    r = jnp.asarray(r)
    ip_a = jnp.asarray(ip_ma) * 1e6
    bz, br, n_index = vacuum_field_at(psi_vac, grid, r, z)
    a = r * minor_radius_fraction
    term = jnp.log(8.0 * r / a) + beta_p + li / 2.0 - 1.5
    f_hoop = (MU0 * ip_a**2 / 2.0) * term / r
    f_lor_r = ip_a * bz * 2.0 * jnp.pi * r
    f_lor_z = -ip_a * br * 2.0 * jnp.pi * r
    return RingForces(
        f_r_n=f_hoop + f_lor_r, f_z_n=f_lor_z, f_hoop_n=f_hoop,
        f_lorentz_r_n=f_lor_r, f_lorentz_z_n=f_lor_z, n_index=n_index)


def _eig2x2(k: jnp.ndarray) -> jnp.ndarray:
    """Closed-form eigenvalues of a real 2x2 (complex output, jittable)."""
    tr = k[0, 0] + k[1, 1]
    det = k[0, 0] * k[1, 1] - k[0, 1] * k[1, 0]
    disc = (tr / 2.0) ** 2 - det
    root = jnp.sqrt(jnp.asarray(disc, dtype=jnp.result_type(disc, 1j)))
    return jnp.stack([tr / 2.0 + root, tr / 2.0 - root])


def analyze_rigid_body(
    psi_vac: jnp.ndarray,
    grid: Grid,
    *,
    r_target,
    z_target,
    ip_ma,
    beta_p: float = 0.5,
    li: float = 0.8,
) -> RigidBodyReport:
    """Force-balance linearisation + eigenvalue stability summary
    (reference ``analyze_stability:126-185``), as one jittable program.

    ``K = -dF/d(R,Z)`` is the exact forward-mode Jacobian of the force
    model; positive eigenvalue == restoring force along that mode.
    """
    def force_vec(x):
        f = ring_forces(psi_vac, grid, x[0], x[1], ip_ma,
                        beta_p=beta_p, li=li)
        return jnp.stack([f.f_r_n, f.f_z_n])

    x0 = jnp.stack([jnp.asarray(r_target, psi_vac.dtype),
                    jnp.asarray(z_target, psi_vac.dtype)])
    forces = ring_forces(psi_vac, grid, x0[0], x0[1], ip_ma,
                         beta_p=beta_p, li=li)
    k = -jax.jacfwd(force_vec)(x0)
    eig = _eig2x2(k)
    # Mode identification: dominant displacement component per eigenvector.
    # For the (near-)diagonal K of an up-down-symmetric machine the first
    # eigenvalue tracks K_RR (radial), the second K_ZZ (vertical).
    radial_idx = jnp.argmin(jnp.abs(eig.real - k[0, 0]))
    lam_r = eig.real[radial_idx]
    lam_z = eig.real[1 - radial_idx]
    n0 = forces.n_index
    return RigidBodyReport(
        forces=forces, stiffness_n_m=k, eigenvalues=eig,
        radial_stable=lam_r > 0.0, vertical_stable=lam_z > 0.0,
        n_index_ok=(n0 > 0.0) & (n0 < 1.5))


def stability_landscape(
    psi_vac: jnp.ndarray,
    grid: Grid,
    *,
    r_points: jnp.ndarray,
    z_points: jnp.ndarray,
    ip_ma,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(F_R, F_Z) maps over a query mesh — vmapped replacement of the
    reference's matplotlib contour landscape (``:243``); rendering is
    the dashboard generator's job."""
    rr, zz = jnp.meshgrid(r_points, z_points, indexing="xy")

    def one(r, z):
        f = ring_forces(psi_vac, grid, r, z, ip_ma)
        return f.f_r_n, f.f_z_n

    f_r, f_z = jax.vmap(jax.vmap(one))(rr, zz)
    return f_r, f_z
