"""The XLA multigrid and Picard-source path: properties pinned on every
platform, against the NumPy twins in ``utils/npref.py`` where one exists."""

import jax.numpy as jnp
import numpy as np
import pytest

from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium.profiles import (
    ProfileCoeffs,
    plasma_current_density,
)
from scpn_fusion_tpu.models.equilibrium.topology import analyze_topology
from scpn_fusion_tpu.ops.multigrid import (
    prolongate_bilinear,
    restrict_full_weight,
    vcycle,
)
from scpn_fusion_tpu.ops.stencil import gs_operator, gs_residual_rms
from scpn_fusion_tpu.utils import npref


def _problem(nz, nr, seed=0):
    """A smooth exact field, its GS* source, and a noisy start that shares
    the exact field's Dirichlet ring."""
    grid = Grid.from_bounds(nr, nz, 2.0, 10.0, -4.0, 4.0, dtype=np.float64)
    rr, zz = np.asarray(grid.RR), np.asarray(grid.ZZ)
    exact = np.exp(-((rr - 6.0) ** 2 + zz ** 2) / 3.0) + 0.1 * rr
    src = np.asarray(gs_operator(jnp.asarray(exact), grid.R, grid.dR,
                                 grid.dZ))
    rng = np.random.default_rng(seed)
    psi0 = exact + 0.1 * rng.standard_normal(exact.shape)
    psi0[0, :], psi0[-1, :] = exact[0, :], exact[-1, :]
    psi0[:, 0], psi0[:, -1] = exact[:, 0], exact[:, -1]
    return grid, jnp.asarray(psi0), jnp.asarray(src)


def _ring(a):
    a = np.asarray(a)
    return np.concatenate([a[0], a[-1], a[:, 0], a[:, -1]])


@pytest.mark.parametrize("n", [17, 65, 129, 513])
def test_vcycle_preserves_dirichlet_ring(n):
    grid, psi0, src = _problem(n, n)
    out = vcycle(psi0, src, grid.R, grid.dR, grid.dZ)
    np.testing.assert_array_equal(_ring(out), _ring(psi0))


@pytest.mark.parametrize("n", [17, 65, 129])
def test_vcycle_matches_numpy_twin(n):
    grid, psi0, src = _problem(n, n, seed=n)
    out = vcycle(psi0, src, grid.R, grid.dR, grid.dZ)
    ref = npref.vcycle_np(np.asarray(psi0), np.asarray(src),
                          np.asarray(grid.R), grid.dR, grid.dZ)
    span = ref.max() - ref.min()
    assert np.max(np.abs(np.asarray(out) - ref)) / span < 1e-12


@pytest.mark.parametrize("pre,post", [(1, 2), (3, 3)])
@pytest.mark.parametrize("n", [33, 129])
def test_vcycle_smoothing_counts_reduce_residual(n, pre, post):
    grid, psi0, src = _problem(n, n, seed=3)
    r0 = float(gs_residual_rms(psi0, src, grid.R, grid.dR, grid.dZ))
    out = vcycle(psi0, src, grid.R, grid.dR, grid.dZ,
                 pre_smooth=pre, post_smooth=post)
    r1 = float(gs_residual_rms(out, src, grid.R, grid.dR, grid.dZ))
    assert r1 < 0.2 * r0, (r0, r1)


@pytest.mark.parametrize("nz,nr", [(20, 20), (31, 47), (50, 33), (64, 64)])
def test_vcycle_on_grids_that_are_not_2k_plus_1(nz, nr):
    grid, psi0, src = _problem(nz, nr, seed=nz + nr)
    r0 = float(gs_residual_rms(psi0, src, grid.R, grid.dR, grid.dZ))
    out = vcycle(psi0, src, grid.R, grid.dR, grid.dZ)
    r1 = float(gs_residual_rms(out, src, grid.R, grid.dR, grid.dZ))
    assert out.shape == (nz, nr)
    assert np.all(np.isfinite(np.asarray(out)))
    np.testing.assert_array_equal(_ring(out), _ring(psi0))
    assert r1 < 0.5 * r0, (r0, r1)


def _field(kind, n):
    """A constant or a linear field on an n x n grid of unit spacing."""
    iz, ir = np.meshgrid(np.arange(n, dtype=np.float64),
                         np.arange(n, dtype=np.float64), indexing="ij")
    return (np.full((n, n), 2.5) if kind == "constant"
            else 0.3 * iz - 1.7 * ir + 4.0)


@pytest.mark.parametrize("kind", ["constant", "linear"])
@pytest.mark.parametrize("n", [9, 17, 33])
def test_restriction_is_exact_on_2k_plus_1_grids(n, kind):
    """Full weighting of a linear field samples it at the coarse points."""
    fine = _field(kind, n)
    coarse = np.asarray(restrict_full_weight(jnp.asarray(fine)))
    np.testing.assert_allclose(coarse, fine[::2, ::2], rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["constant", "linear"])
@pytest.mark.parametrize("n", [9, 17, 33])
def test_prolongation_is_exact_on_2k_plus_1_grids(n, kind):
    """Bilinear interpolation reproduces a linear field everywhere."""
    fine = _field(kind, n)
    out = np.asarray(prolongate_bilinear(jnp.asarray(fine[::2, ::2]), n, n))
    np.testing.assert_allclose(out, fine, rtol=0, atol=1e-12)


# ── Picard source step: topology + Ip-renormalised current ──────────────

MU0 = 1.0


def _grid_arrays(n):
    r = np.linspace(2.0, 10.0, n)
    z = np.linspace(-4.0, 4.0, n)
    rr, zz = np.meshgrid(r, z)
    return r, z, rr, zz, r[1] - r[0], z[1] - z[0]


def _source_xla(psi, rr, zz, dr, dz, z_min, i_t):
    topo = analyze_topology(jnp.asarray(psi), jnp.asarray(zz), dr, dz, z_min)
    coeffs = ProfileCoeffs(*[jnp.asarray(v) for v in (0.9, 0.05, 1.0, 0.3)])
    j = plasma_current_density(
        jnp.asarray(psi), topo.psi_axis, topo.psi_boundary, jnp.asarray(rr),
        h_mode=False, p_coeffs=coeffs, ff_coeffs=coeffs, mu0=MU0,
        i_target=jnp.asarray(i_t), d_r=dr, d_z=dz)
    return topo, np.asarray(-MU0 * jnp.asarray(rr) * j)


def _source_np(psi, rr, zz, dr, dz, z_min, i_t):
    """Independent NumPy statement of the L-mode source step."""
    psi_axis = psi.max()
    if abs(psi_axis) < 1e-6:
        psi_axis = 1e-6
    gz, gr = np.gradient(psi, dz, axis=0), np.gradient(psi, dr, axis=1)
    b = np.sqrt(gr * gr + gz * gz)
    mask = zz < z_min * 0.5
    psi_b = (psi.reshape(-1)[np.argmin(np.where(mask, b, np.inf))]
             if mask.any() else psi.min())
    if abs(psi_axis - psi_b) < 0.1:
        psi_b = 0.1 * psi_axis
    denom = psi_b - psi_axis
    if abs(denom) < 1e-9:
        denom = 1e-9
    x = (psi - psi_axis) / denom
    prof = np.where((x >= 0) & (x < 1), 1.0 - x, 0.0)
    j = 0.5 * rr * prof + 0.5 * prof / (MU0 * rr)
    i_cur = j.sum() * dr * dz
    j = j * (i_t / i_cur if abs(i_cur) > 1e-9 else 0.0)
    return psi_b, -MU0 * rr * j


@pytest.mark.parametrize("seed", [0, 1])
def test_source_step_matches_numpy(seed):
    r, z, rr, zz, dr, dz = _grid_arrays(65)
    rng = np.random.default_rng(seed)
    psi = (3.0 * np.exp(-(((rr - 6.0) / 2.0) ** 2 + (zz / 2.0) ** 2))
           + 0.01 * rng.standard_normal(rr.shape))
    topo, src = _source_xla(psi, rr, zz, dr, dz, z[0], 12.5)
    psi_b, ref = _source_np(psi, rr, zz, dr, dz, z[0], 12.5)
    assert float(topo.psi_boundary) == pytest.approx(psi_b, abs=1e-12)
    np.testing.assert_allclose(src, ref, rtol=1e-10, atol=1e-12)


def test_source_step_degenerate_field_guard():
    """A flat field trips the |axis - boundary| < 0.1 snap: the boundary
    flux becomes 0.1 * axis flux and the source stays finite."""
    r, z, rr, zz, dr, dz = _grid_arrays(33)
    psi = np.full(rr.shape, 0.05)
    topo, src = _source_xla(psi, rr, zz, dr, dz, z[0], 5.0)
    assert float(topo.psi_boundary) == pytest.approx(0.005, rel=1e-12)
    _, ref = _source_np(psi, rr, zz, dr, dz, z[0], 5.0)
    assert np.all(np.isfinite(src))
    np.testing.assert_allclose(src, ref, rtol=1e-10, atol=1e-12)


def test_source_step_tie_picks_first_argmin_site():
    """Exactly tied |grad psi| minima at sites of very different flux: the
    X-point is the first row-major site, as argmin gives it."""
    r, z, rr, zz, dr, dz = _grid_arrays(65)
    psi = (3.0 * np.exp(-(((rr - 6.0) / 2.0) ** 2 + (zz / 2.0) ** 2))
           + np.linspace(1.0, 2.0, 65)[None, :])
    psi[5:8, 10:13] = 2.5      # first flat patch, |grad| == 0 at (6, 11)
    psi[9:12, 40:43] = 0.3     # second flat patch, |grad| == 0 at (10, 41)
    topo, src = _source_xla(psi, rr, zz, dr, dz, z[0], 10.0)
    assert (int(topo.x_iz), int(topo.x_ir)) == (6, 11)
    assert float(topo.psi_boundary) == pytest.approx(2.5)
    _, ref = _source_np(psi, rr, zz, dr, dz, z[0], 10.0)
    np.testing.assert_allclose(src, ref, rtol=1e-10, atol=1e-12)


def test_source_step_empty_divertor_falls_back_to_global_min():
    r, z, rr, zz, dr, dz = _grid_arrays(65)
    psi = 3.0 * np.exp(-(((rr - 6.0) / 2.0) ** 2 + (zz / 2.0) ** 2)) + 0.2 * rr
    shifted = zz + 100.0          # no point lies below Z_min / 2
    topo, src = _source_xla(psi, rr, shifted, dr, dz, z[0], 8.0)
    assert float(topo.psi_boundary) == pytest.approx(psi.min())
    _, ref = _source_np(psi, rr, shifted, dr, dz, z[0], 8.0)
    np.testing.assert_allclose(src, ref, rtol=1e-10, atol=1e-12)
