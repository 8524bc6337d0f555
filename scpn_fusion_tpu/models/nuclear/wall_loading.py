"""Neutron wall loading + material damage analysis.

Role-parity with the reference's nuclear engineering lab
(``nuclear/nuclear_wall_interaction.py:49-420``: 14.1 MeV neutron source
map from the fusion profile, first-wall generation, line-of-sight
ray-traced neutron wall loading, material dpa/He analysis, ash-poisoning
burn feedback).

JAX-native: the reference loops over wall segments on the host; here the
(source-cell x wall-segment) transfer kernel — inverse-square spreading x
incidence cosine — is ONE batched outer-product contraction (one
matmul against the source vector), so wall loading for new profiles is a
single einsum after the geometry kernel is built once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

E_FUSION_J = 17.6e6 * 1.602176634e-19
NEUTRON_FRACTION = 14.1 / 17.6


@dataclasses.dataclass(frozen=True)
class WallGeometry:
    """D-shaped first wall sampled in the poloidal plane."""

    r0_m: float = 6.2
    a_wall_m: float = 2.3
    kappa: float = 1.9
    delta: float = 0.45
    n_segments: int = 96

    def points(self):
        theta = jnp.linspace(-jnp.pi, jnp.pi, self.n_segments,
                             endpoint=False)
        r = self.r0_m + self.a_wall_m * jnp.cos(
            theta + jnp.arcsin(self.delta) * jnp.sin(theta))
        z = self.kappa * self.a_wall_m * jnp.sin(theta)
        return r, z, theta

    def normals(self):
        r, z, _ = self.points()
        dr = jnp.roll(r, -1) - jnp.roll(r, 1)
        dz = jnp.roll(z, -1) - jnp.roll(z, 1)
        norm = jnp.sqrt(dr ** 2 + dz ** 2) + 1e-30
        # inward normal of a counter-clockwise contour
        return -dz / norm, dr / norm


def neutron_source_density(rr, zz, *, r0_m=6.2, a_m=2.0, kappa=1.8,
                           p_fusion_mw=500.0, peaking=3.0):
    """Volumetric 14.1 MeV neutron emission S(R, Z) [n/m^3/s].

    Parabolic^peaking emission profile on elliptical flux labels,
    normalised so the volume integral carries the full neutron power.
    """
    s2 = ((rr - r0_m) / a_m) ** 2 + (zz / (kappa * a_m)) ** 2
    shape = jnp.maximum(1.0 - s2, 0.0) ** peaking
    rate_total = p_fusion_mw * 1e6 * NEUTRON_FRACTION / E_FUSION_J \
        / NEUTRON_FRACTION  # neutrons/s = P_fus / E_fus
    d_r = rr[0, 1] - rr[0, 0]
    d_z = zz[1, 0] - zz[0, 0]
    vol_weight = 2.0 * jnp.pi * rr * d_r * d_z
    norm = jnp.sum(shape * vol_weight)
    return shape * rate_total / jnp.maximum(norm, 1e-30)


class WallLoading(NamedTuple):
    r_wall: jnp.ndarray
    z_wall: jnp.ndarray
    flux_n_m2_s: jnp.ndarray      # (n_segments,)
    nwl_mw_m2: jnp.ndarray        # neutron wall load
    peaking_factor: jnp.ndarray


def compute_wall_loading(source: jnp.ndarray, rr: jnp.ndarray,
                         zz: jnp.ndarray,
                         wall: WallGeometry = WallGeometry()
                         ) -> WallLoading:
    """One-shot transfer-kernel contraction: flux_w = K @ S.

    K[w, c] = max(cos_incidence, 0) / (4 pi d^2) per unit source; the
    toroidal volume element folds into the source vector.
    """
    r_w, z_w, _ = wall.points()
    n_r, n_z = wall.normals()
    d_r = rr[0, 1] - rr[0, 0]
    d_z = zz[1, 0] - zz[0, 0]
    s_cells = (source * 2.0 * jnp.pi * rr * d_r * d_z).ravel()
    src_r = rr.ravel()
    src_z = zz.ravel()

    dx = r_w[:, None] - src_r[None, :]
    dz_ = z_w[:, None] - src_z[None, :]
    d2 = dx ** 2 + dz_ ** 2 + 1e-12
    cos_inc = jnp.maximum(
        (n_r[:, None] * (-dx) + n_z[:, None] * (-dz_))
        / jnp.sqrt(d2), 0.0)
    kernel = cos_inc / (4.0 * jnp.pi * d2)
    flux = kernel @ s_cells
    # Conservation rescale: the wall is closed, so the captured power must
    # equal the emitted power.  The in-plane kernel alone over-counts (it
    # ignores toroidal spreading); rescaling against the exact global
    # balance fixes the absolute level while keeping the poloidal shape.
    seg_len = jnp.sqrt((jnp.roll(r_w, -1) - r_w) ** 2
                       + (jnp.roll(z_w, -1) - z_w) ** 2)
    seg_area = 2.0 * jnp.pi * r_w * seg_len
    captured = jnp.sum(flux * seg_area)
    emitted = jnp.sum(s_cells)
    flux = flux * emitted / jnp.maximum(captured, 1e-30)
    e_n_j = 14.1e6 * 1.602176634e-19
    nwl = flux * e_n_j / 1e6
    peak = jnp.max(nwl) / jnp.maximum(jnp.mean(nwl), 1e-30)
    return WallLoading(r_wall=r_w, z_wall=z_w, flux_n_m2_s=flux,
                       nwl_mw_m2=nwl, peaking_factor=peak)


# Material damage coefficients: (dpa per 1e25 n/m^2 fluence,
# appm He per dpa) — representative first-wall values.
MATERIALS = {
    "tungsten": (0.30, 0.6),
    "eurofer": (1.0, 10.0),
    "sic": (1.1, 60.0),
    "beryllium": (1.4, 300.0),
}


class MaterialReport(NamedTuple):
    dpa_per_fpy: jnp.ndarray       # (n_segments,)
    he_appm_per_fpy: jnp.ndarray
    lifetime_fpy: jnp.ndarray      # peak-position lifetime to dpa limit


def analyze_material(loading: WallLoading, material: str = "tungsten",
                     dpa_limit: float = 50.0) -> MaterialReport:
    """dpa/He production per full-power-year + wall lifetime (reference
    ``analyze_materials`` :340 contract)."""
    if material not in MATERIALS:
        raise ValueError(f"unknown material {material!r}; "
                         f"known: {sorted(MATERIALS)}")
    dpa_coeff, he_per_dpa = MATERIALS[material]
    fpy_s = 3.156e7
    fluence_fpy = loading.flux_n_m2_s * fpy_s
    dpa = dpa_coeff * fluence_fpy / 1e25
    he = dpa * he_per_dpa
    lifetime = dpa_limit / jnp.maximum(jnp.max(dpa), 1e-30)
    return MaterialReport(dpa_per_fpy=dpa, he_appm_per_fpy=he,
                          lifetime_fpy=lifetime)


def ash_poisoning_dilution(f_helium, *, tau_ratio: float = 5.0):
    """Steady helium-ash fuel dilution factor on the fusion rate
    (reference ``simulate_ash_poisoning`` :99 reduced form):
    fuel fraction = 1 - 2 f_He (quasi-neutral dilution); the fusion rate
    scales with its square."""
    f_fuel = jnp.clip(1.0 - 2.0 * jnp.asarray(f_helium), 0.0, 1.0)
    return f_fuel ** 2
