"""3D field-line tracing: Poincaré sections, q from line-following,
connection length.

Role-parity with the reference's field-line lane (``core/fieldline_3d.py``
RK4 line following with Poincaré sections and island detection,
``core/geometry_3d.py``; Rust twin in ``fusion-core``).

JAX-native design: the tracer integrates ALL seed lines at once — the
state is a (n_lines, 3) array advanced by one ``lax.scan`` over toroidal
steps, so a 10^3-seed Poincaré scan is one compiled program.  The field
can be an axisymmetric equilibrium (psi interpolated bilinearly) plus an
optional helical perturbation field (resonant island studies).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class FieldModel:
    """Axisymmetric field from psi + F=R B_phi, plus helical perturbation.

    B_R = -(1/R) dpsi/dZ, B_Z = (1/R) dpsi/dR, B_phi = f_tor / R;
    perturbation: B_r_pert = eps * B0 * cos(m theta - n phi) mapped onto
    (R, Z) around the axis (the standard island-seeding form).
    """

    r_1d: tuple
    z_1d: tuple
    psi: tuple              # flattened row-major (NZ*NR,)
    f_tor: float = 12.0     # R0 * B0
    axis_r: float = 6.2
    axis_z: float = 0.0
    pert_eps: float = 0.0
    pert_m: int = 2
    pert_n: int = 1

    def arrays(self):
        r = jnp.asarray(self.r_1d)
        z = jnp.asarray(self.z_1d)
        psi = jnp.asarray(self.psi).reshape(z.shape[0], r.shape[0])
        return r, z, psi


def _bilinear(psi, r_1d, z_1d, r, z):
    d_r = r_1d[1] - r_1d[0]
    d_z = z_1d[1] - z_1d[0]
    tr = jnp.clip((r - r_1d[0]) / d_r, 0.0, r_1d.shape[0] - 1.001)
    tz = jnp.clip((z - z_1d[0]) / d_z, 0.0, z_1d.shape[0] - 1.001)
    i0 = jnp.floor(tr).astype(jnp.int32)
    j0 = jnp.floor(tz).astype(jnp.int32)
    wr = tr - i0
    wz = tz - j0
    return ((1 - wz) * ((1 - wr) * psi[j0, i0] + wr * psi[j0, i0 + 1])
            + wz * ((1 - wr) * psi[j0 + 1, i0] + wr * psi[j0 + 1, i0 + 1]))


def b_field_at(model: FieldModel, r, z, phi):
    """(B_R, B_phi, B_Z) at cylindrical points (traceable, batched)."""
    r_1d, z_1d, psi = model.arrays()
    eps_fd = 1e-4

    def psi_at(rr, zz):
        return _bilinear(psi, r_1d, z_1d, rr, zz)

    dpsi_dr = (psi_at(r + eps_fd, z) - psi_at(r - eps_fd, z)) / (2 * eps_fd)
    dpsi_dz = (psi_at(r, z + eps_fd) - psi_at(r, z - eps_fd)) / (2 * eps_fd)
    b_r = -dpsi_dz / r
    b_z = dpsi_dr / r
    b_phi = model.f_tor / r

    if model.pert_eps != 0.0:
        theta = jnp.arctan2(z - model.axis_z, r - model.axis_r)
        b0 = model.f_tor / model.axis_r
        amp = model.pert_eps * b0 * jnp.cos(model.pert_m * theta
                                            - model.pert_n * phi)
        b_r = b_r + amp * jnp.cos(theta)
        b_z = b_z + amp * jnp.sin(theta)
    return b_r, b_phi, b_z


class TraceResult(NamedTuple):
    r: jnp.ndarray           # (n_steps+1, n_lines)
    z: jnp.ndarray
    phi: jnp.ndarray         # (n_steps+1,)


def trace_field_lines(model: FieldModel, r0: jnp.ndarray, z0: jnp.ndarray,
                      *, n_turns: float = 50.0,
                      steps_per_turn: int = 128) -> TraceResult:
    """RK4 integration of dR/dphi = R B_R/B_phi, dZ/dphi = R B_Z/B_phi
    for all seed lines simultaneously."""
    n_steps = int(n_turns * steps_per_turn)
    d_phi = 2.0 * jnp.pi / steps_per_turn

    def rhs(state, phi):
        r, z = state
        b_r, b_phi, b_z = b_field_at(model, r, z, phi)
        safe = jnp.where(jnp.abs(b_phi) > 1e-12, b_phi, 1e-12)
        return r * b_r / safe, r * b_z / safe

    def step(carry, k):
        r, z = carry
        phi = k * d_phi
        k1r, k1z = rhs((r, z), phi)
        k2r, k2z = rhs((r + 0.5 * d_phi * k1r, z + 0.5 * d_phi * k1z),
                       phi + 0.5 * d_phi)
        k3r, k3z = rhs((r + 0.5 * d_phi * k2r, z + 0.5 * d_phi * k2z),
                       phi + 0.5 * d_phi)
        k4r, k4z = rhs((r + d_phi * k3r, z + d_phi * k3z), phi + d_phi)
        r1 = r + d_phi / 6.0 * (k1r + 2 * k2r + 2 * k3r + k4r)
        z1 = z + d_phi / 6.0 * (k1z + 2 * k2z + 2 * k3z + k4z)
        return (r1, z1), (r1, z1)

    init = (jnp.atleast_1d(r0), jnp.atleast_1d(z0))
    (_, _), (r_tr, z_tr) = jax.lax.scan(step, init, jnp.arange(n_steps))
    r_full = jnp.concatenate([init[0][None], r_tr], axis=0)
    z_full = jnp.concatenate([init[1][None], z_tr], axis=0)
    phis = jnp.arange(n_steps + 1) * d_phi
    return TraceResult(r=r_full, z=z_full, phi=phis)


def poincare_section(trace: TraceResult, steps_per_turn: int):
    """(R, Z) puncture points at phi = 0 mod 2pi for every line."""
    return (trace.r[::steps_per_turn], trace.z[::steps_per_turn])


def safety_factor_from_trace(trace: TraceResult, axis_r: float,
                             axis_z: float, steps_per_turn: int):
    """q per line = toroidal turns / poloidal turns of the traced line."""
    theta = jnp.unwrap(jnp.arctan2(trace.z - axis_z, trace.r - axis_r),
                       axis=0)
    n_tor_turns = trace.phi[-1] / (2.0 * jnp.pi)
    n_pol_turns = (theta[-1] - theta[0]) / (2.0 * jnp.pi)
    return n_tor_turns / jnp.where(jnp.abs(n_pol_turns) > 1e-9,
                                   n_pol_turns, jnp.inf)


def connection_length(model: FieldModel, r0, z0, *, wall_psi: float,
                      n_turns: float = 200.0, steps_per_turn: int = 64):
    """Parallel length until the line crosses the wall flux surface
    (open-line SOL metric; inf-like cap if confined)."""
    r_1d, z_1d, psi = model.arrays()
    tr = trace_field_lines(model, jnp.atleast_1d(r0), jnp.atleast_1d(z0),
                           n_turns=n_turns, steps_per_turn=steps_per_turn)
    psi_line = jax.vmap(
        lambda rr, zz: _bilinear(psi, r_1d, z_1d, rr, zz))(
        tr.r.ravel(), tr.z.ravel()).reshape(tr.r.shape)
    outside = psi_line < wall_psi
    d_phi = 2.0 * jnp.pi / steps_per_turn
    # arc length element ~ sqrt((R dphi)^2 + dR^2 + dZ^2) accumulated
    dl = jnp.sqrt((tr.r[:-1] * d_phi) ** 2
                  + jnp.diff(tr.r, axis=0) ** 2
                  + jnp.diff(tr.z, axis=0) ** 2)
    cum = jnp.cumsum(dl, axis=0)
    hit = outside[1:]
    first = jnp.argmax(hit, axis=0)
    hit_any = jnp.any(hit, axis=0)
    l_conn = jnp.take_along_axis(cum, first[None], axis=0)[0]
    return jnp.where(hit_any, l_conn, cum[-1])
