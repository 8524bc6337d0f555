"""Realtime EFIT reconstruction tests (closed-loop forward/inverse)."""

import jax.numpy as jnp
import numpy as np
import pytest

from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.control.realtime_efit import (
    MagneticsLayout,
    build_efit_model,
    reconstruct,
    synthetic_measurements,
)


def _layout():
    loops = tuple((r, z) for r in (4.0, 9.0) for z in (-3.5, 0.0, 3.5))
    probes = tuple((r, z, d)
                   for (r, z) in ((3.8, -2.0), (3.8, 2.0), (9.2, 0.0),
                                  (6.5, 4.0), (6.5, -4.0))
                   for d in ("R", "Z"))
    coil_r = (3.5, 9.5, 9.5, 3.5)
    coil_z = (4.5, 2.5, -2.5, -4.5)
    return MagneticsLayout(flux_loops=loops, b_probes=probes,
                           coil_r=coil_r, coil_z=coil_z)


@pytest.fixture(scope="module")
def model():
    grid = Grid(NR=33, NZ=33, R_min=4.5, R_max=8.5, Z_min=-2.5,
                Z_max=2.5, dtype=__import__('numpy').dtype('float64'))
    return build_efit_model(grid, _layout(), r_axis=6.5, a_minor=1.6,
                            kappa=1.5)


class TestBuild:
    def test_shapes(self, model):
        n_sensors = 6 + 10
        n_k = 6
        assert model.basis_sensor.shape == (n_sensors, n_k)
        assert model.coil_sensor.shape == (n_sensors, 4)
        assert model.basis_maps.shape == (n_k, 33, 33)
        assert model.solve_op.shape == (n_k, n_sensors + 1)
        assert bool(jnp.all(jnp.isfinite(model.basis_maps)))
        assert bool(jnp.all(jnp.isfinite(model.basis_sensor)))

    def test_layout_validation(self):
        with pytest.raises(ValueError, match="at least 4"):
            MagneticsLayout(flux_loops=((1.0, 0.0),), b_probes=(),
                            coil_r=(), coil_z=())
        with pytest.raises(ValueError, match="direction"):
            MagneticsLayout(flux_loops=((1, 0), (2, 0), (3, 0), (4, 0)),
                            b_probes=((1.0, 0.0, "phi"),),
                            coil_r=(), coil_z=())


class TestReconstruction:
    def test_forward_inverse_roundtrip(self, model):
        true_coeffs = jnp.asarray([1.2e6, -0.3e6, 0.1e6, 0.5e6, 0.0, 0.0])
        coil_i = jnp.asarray([1e5, -2e5, -2e5, 1e5])
        meas = synthetic_measurements(model, true_coeffs, coil_i)
        ip_true = model.basis_ip @ true_coeffs
        res = reconstruct(model, meas, coil_i, ip_true)
        # reconstructed Ip close to the truth
        assert float(res.ip_reconstructed) == pytest.approx(
            float(ip_true), rel=0.05)
        # sensor-space residual is small (Tikhonov damping on the
        # near-degenerate polynomial basis leaves ~1%)
        assert float(res.residual_norm) < 0.03 * float(
            jnp.linalg.norm(meas))

    def test_psi_peak_near_axis(self, model):
        true_coeffs = jnp.asarray([2e6, 0.0, 0.0, 1e6, 0.0, 0.0])
        coil_i = jnp.zeros(4)
        meas = synthetic_measurements(model, true_coeffs, coil_i)
        res = reconstruct(model, meas, coil_i, model.basis_ip @ true_coeffs)
        assert abs(float(res.axis_r) - 6.5) < 0.8
        assert abs(float(res.axis_z)) < 0.8

    def test_noise_robustness(self, model):
        rng = np.random.default_rng(0)
        true_coeffs = jnp.asarray([1.5e6, 0.2e6, 0.0, 0.8e6, 0.0, 0.0])
        coil_i = jnp.asarray([5e4, -1e5, -1e5, 5e4])
        meas = synthetic_measurements(model, true_coeffs, coil_i)
        noisy = meas * (1.0 + 0.01 * rng.standard_normal(meas.shape))
        ip = model.basis_ip @ true_coeffs
        res = reconstruct(model, jnp.asarray(noisy), coil_i, ip)
        assert float(res.ip_reconstructed) == pytest.approx(
            float(ip), rel=0.1)

    def test_reconstruction_is_fast_warm(self, model):
        import time
        coil_i = jnp.zeros(4)
        meas = jnp.ones(16)
        reconstruct(model, meas, coil_i, jnp.asarray(1e6))  # warm
        t0 = time.perf_counter()
        for _ in range(50):
            reconstruct(model, meas, coil_i,
                        jnp.asarray(1e6)).psi.block_until_ready()
        dt_ms = (time.perf_counter() - t0) / 50 * 1e3
        assert dt_ms < 50.0  # generous CPU bound
