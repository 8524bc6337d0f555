"""AMR patch: local refinement of psi around the X-point.

Role-parity with the reference's ``core/amr_patch.py:27`` (``AMRPatch``
extracting a refined sub-grid around the X-point, re-solving GS locally
with coarse-interpolated Dirichlet boundaries, and returning a sharpened
X-point position; Rust twin ``fusion-math/src/amr.rs``).

accelerator-first design: the patch is a STATIC-shape window (refine factor x
window cells), extracted with ``lax.dynamic_slice`` around the X-point
index, bilinearly prolonged, relaxed with the same vectorised red-black
SOR kernel as the global solve, and the refined saddle is localised by a
quadratic fit — every step jittable, so the patch can live inside the
outer Picard loop without host round-trips.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.ops.stencil import sor_step
from scpn_fusion_tpu.models.equilibrium.topology import find_x_point


class AMRPatchResult(NamedTuple):
    psi_fine: jnp.ndarray      # (n_fine, n_fine) refined local solution
    r_fine: jnp.ndarray        # (n_fine,) patch R coordinates
    z_fine: jnp.ndarray        # (n_fine,)
    x_point_r: jnp.ndarray     # refined X-point position
    x_point_z: jnp.ndarray
    x_point_psi: jnp.ndarray
    grad_psi_at_x: jnp.ndarray  # |grad psi| at the refined saddle


def _bilinear_upsample(tile: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Bilinear prolongation of a (m, m) tile to ((m-1)f+1, (m-1)f+1)."""
    m = tile.shape[0]
    n = (m - 1) * factor + 1
    # sample positions in coarse index space
    xi = jnp.linspace(0.0, m - 1.0, n)
    i0 = jnp.clip(jnp.floor(xi).astype(jnp.int32), 0, m - 2)
    w = xi - i0
    rows = (tile[i0, :] * (1.0 - w)[:, None] + tile[i0 + 1, :] * w[:, None])
    cols = (rows[:, i0] * (1.0 - w)[None, :] + rows[:, i0 + 1] * w[None, :])
    return cols


def _quadratic_saddle_refine(psi: jnp.ndarray, iz, ir, d_r, d_z):
    """Sub-cell saddle localisation from the local quadratic patch."""
    f_r = (psi[iz, ir + 1] - psi[iz, ir - 1]) / (2.0 * d_r)
    f_z = (psi[iz + 1, ir] - psi[iz - 1, ir]) / (2.0 * d_z)
    f_rr = (psi[iz, ir + 1] - 2.0 * psi[iz, ir] + psi[iz, ir - 1]) / d_r**2
    f_zz = (psi[iz + 1, ir] - 2.0 * psi[iz, ir] + psi[iz - 1, ir]) / d_z**2
    f_rz = (psi[iz + 1, ir + 1] - psi[iz + 1, ir - 1]
            - psi[iz - 1, ir + 1] + psi[iz - 1, ir - 1]) / (4.0 * d_r * d_z)
    det = f_rr * f_zz - f_rz ** 2
    safe = jnp.abs(det) > 1e-30
    dr = jnp.where(safe, (-f_r * f_zz + f_z * f_rz) / det, 0.0)
    dz = jnp.where(safe, (-f_z * f_rr + f_r * f_rz) / det, 0.0)
    # clamp the Newton update to one cell
    dr = jnp.clip(dr, -d_r, d_r)
    dz = jnp.clip(dz, -d_z, d_z)
    return dr, dz, jnp.sqrt(f_r ** 2 + f_z ** 2)


@partial(jax.jit, static_argnames=("window", "factor", "n_sweeps"))
def refine_x_point(psi: jnp.ndarray, source: jnp.ndarray,
                   r_1d: jnp.ndarray, z_1d: jnp.ndarray, *,
                   window: int = 9, factor: int = 4,
                   n_sweeps: int = 200, omega: float = 1.7
                   ) -> AMRPatchResult:
    """Extract, refine, re-solve, and re-localise around the X-point.

    psi/source: (NZ, NR) global fields; window: half-size in coarse cells;
    factor: refinement ratio; the patch solve keeps the prolonged boundary
    fixed (Dirichlet from the coarse solution).
    """
    d_r = r_1d[1] - r_1d[0]
    d_z = z_1d[1] - z_1d[0]
    nz, nr = psi.shape
    zz = jnp.broadcast_to(z_1d[:, None], psi.shape)

    # Coarse X-point index (lower-divertor mask, topology module).
    iz, ir, _ = find_x_point(psi, zz, d_r, d_z, z_1d[0])
    ir = jnp.clip(ir, window, nr - window - 1)
    iz = jnp.clip(iz, window, nz - window - 1)

    m = 2 * window + 1
    start = (iz - window, ir - window)
    tile_psi = jax.lax.dynamic_slice(psi, start, (m, m))
    tile_src = jax.lax.dynamic_slice(source, start, (m, m))
    r_tile = jax.lax.dynamic_slice(r_1d, (ir - window,), (m,))
    z_tile = jax.lax.dynamic_slice(z_1d, (iz - window,), (m,))

    # Prolong to the fine patch.
    psi_f = _bilinear_upsample(tile_psi, factor)
    src_f = _bilinear_upsample(tile_src, factor)
    n_f = psi_f.shape[0]
    r_f = jnp.linspace(r_tile[0], r_tile[-1], n_f)
    z_f = jnp.linspace(z_tile[0], z_tile[-1], n_f)
    d_rf = d_r / factor
    d_zf = d_z / factor

    # Local re-solve with frozen Dirichlet boundary.
    # (sor_step directly: the patch spacings are traced values here, while
    # the global sor_sweeps wrapper declares them jit-static.)
    psi_f = jax.lax.fori_loop(
        0, n_sweeps,
        lambda _, p: sor_step(p, src_f, r_f, d_rf, d_zf, omega), psi_f)

    # Refined saddle: strongest saddle = min |grad psi| on the fine patch
    # interior, then one quadratic Newton correction.
    gz, gr = jnp.gradient(psi_f, d_zf, d_rf)
    gmag = jnp.sqrt(gr ** 2 + gz ** 2)
    interior = jnp.full_like(gmag, jnp.inf)
    interior = interior.at[2:-2, 2:-2].set(gmag[2:-2, 2:-2])
    idx = jnp.argmin(interior)
    fz, fr = idx // n_f, idx % n_f
    dr, dz, grad_at = _quadratic_saddle_refine(psi_f, fz, fr, d_rf, d_zf)
    x_r = r_f[fr] + dr
    x_z = z_f[fz] + dz
    # psi at the refined point (bilinear)
    tr = (x_r - r_f[0]) / d_rf
    tz = (x_z - z_f[0]) / d_zf
    i0 = jnp.clip(jnp.floor(tr).astype(jnp.int32), 0, n_f - 2)
    j0 = jnp.clip(jnp.floor(tz).astype(jnp.int32), 0, n_f - 2)
    wr = tr - i0
    wz = tz - j0
    psi_x = ((1 - wz) * ((1 - wr) * psi_f[j0, i0] + wr * psi_f[j0, i0 + 1])
             + wz * ((1 - wr) * psi_f[j0 + 1, i0]
                     + wr * psi_f[j0 + 1, i0 + 1]))

    return AMRPatchResult(psi_fine=psi_f, r_fine=r_f, z_fine=z_f,
                          x_point_r=x_r, x_point_z=x_z, x_point_psi=psi_x,
                          grad_psi_at_x=grad_at)
