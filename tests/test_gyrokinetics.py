"""Linear gyrokinetics: geometry, species, eigenvalue, quasilinear fluxes."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special

from scpn_fusion_tpu.models.gyrokinetics import (
    GKSpecies,
    LinearGKResult,
    VelocityGrid,
    bessel_j0,
    circular_geometry,
    collision_frequencies,
    deuterium_ion,
    electron,
    mixing_length_saturation,
    quasilinear_fluxes_from_spectrum,
    solve_eigenvalue_single_ky,
    solve_linear_gk,
)
from scpn_fusion_tpu.models.gyrokinetics.linear import (
    assemble_dispersion_matrix,
    most_unstable_mode_initial_value,
)


class TestSupport:
    def test_bessel_j0_vs_scipy(self):
        x = np.linspace(0, 20, 400)
        ours = np.asarray(bessel_j0(jnp.asarray(x)))
        ref = scipy.special.j0(x)
        np.testing.assert_allclose(ours, ref, atol=2e-7)

    def test_velocity_grid_quadrature_normalised(self):
        """Maxwellian moment: (2/sqrt(pi)) int sqrt(E) e^-E dE ~ 1 on [0,6T]."""
        vg = VelocityGrid(n_energy=24, n_lambda=8)
        e, w, lam, wl = vg.nodes()
        integral = float(jnp.sum((2 / jnp.sqrt(jnp.pi)) * jnp.sqrt(e)
                                 * jnp.exp(-e) * w))
        assert abs(integral - 1.0) < 0.01
        assert abs(float(jnp.sum(wl)) - 1.0) < 1e-12

    def test_collision_frequencies_positive_and_ordered(self):
        ion = deuterium_ion()
        nu_d, nu_e = collision_frequencies(ion, 10.0, 8.0)
        assert nu_d > 0 and nu_e > 0
        # Energy diffusion against electrons is mass-suppressed for ions.
        assert nu_e < nu_d

    def test_geometry_circular_b_field(self):
        g = circular_geometry(r0=2.78, a=1.0, rho=0.5, q=1.4, b0=2.0)
        b = np.asarray(g.b_mag)
        # 1/R variation: B larger on inboard side.
        assert b.max() > b.min()
        r = np.asarray(g.r_s)
        np.testing.assert_allclose(b.max() / b.min(), r.max() / r.min(),
                                   rtol=0.05)


class TestLinearGK:
    def test_response_matrix_solver_runs(self):
        ion = deuterium_ion(r_l_t=6.9, r_l_n=2.2)
        geom = circular_geometry(n_theta=32)
        vg = VelocityGrid(n_energy=6, n_lambda=8)
        mode = solve_eigenvalue_single_ky(0.5, [ion], geom, vg, method="eig")
        assert np.isfinite(mode.gamma) and mode.gamma >= 0.0

    def test_reference_parity_matrix_is_hermitian(self):
        """Parity pin: the reference's effective dispersion matrix (drive +
        streaming + adiabatic, resonant terms dropped) is Hermitian, so its
        growth rates are ~0 — measured 1e-16 in both codes.  The physical
        growth rates live in the local_dispersion lane."""
        ion = deuterium_ion()
        geom = circular_geometry(n_theta=24)
        vg = VelocityGrid(n_energy=6, n_lambda=8)
        m = np.asarray(assemble_dispersion_matrix(0.5, ion, geom, vg))
        herm_dev = np.max(np.abs(m - m.conj().T)) / np.max(np.abs(m))
        assert herm_dev < 0.2  # near-Hermitian (row scaling breaks it mildly)
        gamma_eig = float(np.linalg.eigvals(m).imag.max())
        assert abs(gamma_eig) < 1e-6

    def test_initial_value_matches_eig_gamma(self):
        """The device-safe initial-value extraction agrees with dense eig on the
        (near-zero) dominant growth rate of the parity matrix."""
        ion = deuterium_ion()
        geom = circular_geometry(n_theta=24)
        vg = VelocityGrid(n_energy=6, n_lambda=8)
        m = assemble_dispersion_matrix(0.5, ion, geom, vg)
        gamma_eig = float(np.linalg.eigvals(np.asarray(m)).imag.max())
        out = most_unstable_mode_initial_value(m, dt=0.01, n_steps=8000)
        assert abs(float(out.gamma) - gamma_eig) < 1e-3

    def test_spectrum_scan(self):
        result = solve_linear_gk(
            k_y_values=np.linspace(0.2, 0.8, 4),
            vgrid=VelocityGrid(n_energy=6, n_lambda=8),
            geom=circular_geometry(n_theta=24),
            method="eig")
        assert len(result.k_y) == 4
        assert result.gamma_max >= 0
        assert np.all(np.isfinite(result.gamma))


class TestQuasilinear:
    def test_mixing_length_formula(self):
        phi = mixing_length_saturation(np.asarray([0.2]), np.asarray([-0.5]),
                                       np.asarray([0.4]))
        np.testing.assert_allclose(phi[0], 0.2 / (0.16 * 0.5), rtol=1e-12)

    def test_fluxes_positive_for_itg_spectrum(self):
        res = LinearGKResult(
            k_y=np.asarray([0.3, 0.5, 0.7]),
            gamma=np.asarray([0.1, 0.25, 0.15]),
            omega_r=np.asarray([-0.4, -0.6, -0.7]),
            mode_type=["ITG", "ITG", "ITG"])
        out = quasilinear_fluxes_from_spectrum(res, deuterium_ion())
        assert out.chi_i > 0
        assert out.dominant_mode == "ITG"

    def test_stable_spectrum_zero_flux(self):
        res = LinearGKResult(
            k_y=np.asarray([0.3]), gamma=np.asarray([0.0]),
            omega_r=np.asarray([0.0]), mode_type=["stable"])
        out = quasilinear_fluxes_from_spectrum(res, deuterium_ion())
        assert out.chi_i == 0.0 and out.chi_e == 0.0


class TestLocalDispersion:
    """The resonant local kinetic lane (the physical growth rates)."""

    def test_itg_threshold_behaviour(self):
        from scpn_fusion_tpu.models.gyrokinetics.local_dispersion import (
            solve_local_kinetic_dispersion)
        stable = solve_local_kinetic_dispersion(0.5, r_l_t=1.0, r_l_n=2.2)
        assert bool(stable.converged)
        assert float(stable.gamma) < 0.01
        cbc = solve_local_kinetic_dispersion(0.5, r_l_t=6.9, r_l_n=2.2)
        assert bool(cbc.converged)
        assert float(cbc.gamma) > 0.0, "CBC parameters must be ITG-unstable"
        assert float(cbc.omega_r) < 0.0, "ITG rotates in the ion direction"

    def test_growth_increases_with_gradient(self):
        from scpn_fusion_tpu.models.gyrokinetics.local_dispersion import (
            solve_local_kinetic_dispersion)
        g1 = float(solve_local_kinetic_dispersion(0.5, r_l_t=6.9, r_l_n=2.2).gamma)
        g2 = float(solve_local_kinetic_dispersion(0.5, r_l_t=12.0, r_l_n=2.2).gamma)
        assert g2 > g1 > 0.0

    def test_spectrum_scan_vmapped(self):
        import jax.numpy as jnp
        from scpn_fusion_tpu.models.gyrokinetics.local_dispersion import (
            growth_rate_spectrum)
        ky = jnp.linspace(0.3, 0.9, 4)
        wr, g = growth_rate_spectrum(ky, r_l_t=9.0, r_l_n=2.2)
        assert np.all(np.isfinite(np.asarray(g)))
        assert float(np.max(np.asarray(g))) > 0.0
