"""Spatial (ky) sharding of the 5D GK operator (VERDICT r3 next #4).

The reference certifies its radial/toroidal rank tiling by the invariant
"tile reductions == monolithic reductions at 1e-12"
(``core/gk_domain_decomposition.py:594``, ``test_gk_domain_decomposition``).
Here the same program runs SPMD over a (sy, v) = (ky, mu) mesh, so the
invariant generalises: the ENTIRE sharded evolution must match the
monolithic one — fields, moments, diagnostics, and the final 5D state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scpn_fusion_tpu.models.gyrokinetics.nonlinear import (
    NonlinearGKConfig,
    build_grids,
    field_solve,
    init_state,
    run_nonlinear_gk,
    velocity_moment,
)
from scpn_fusion_tpu.parallel.gk_shard import (
    run_nonlinear_gk_spatial_sharded,
    shard_state_spatial,
    spatial_velocity_mesh,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _cfg(**kw):
    base = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=6, n_mu=8,
                n_steps=6, save_interval=3, nonlinear=True,
                collisions=True, dtype="complex128")
    base.update(kw)
    return NonlinearGKConfig(**base)


class TestTileInvariant:
    def test_moment_reductions_match_monolithic(self):
        """The reference's literal invariant: tile-decomposed velocity
        moments equal the monolithic ones at 1e-12."""
        cfg = _cfg()
        g = build_grids(cfg)
        state = init_state(cfg, g, seed=3)
        mono = velocity_moment(state.f[0], 1.0, g)
        phi_mono = field_solve(cfg, g, state.f)

        mesh = spatial_velocity_mesh(2, 4)
        sh = shard_state_spatial(state, mesh)
        tiled = velocity_moment(sh.f[0], 1.0, g)
        phi_tiled = field_solve(cfg, g, sh.f)
        assert float(jnp.max(jnp.abs(tiled - mono))) < 1e-12
        assert float(jnp.max(jnp.abs(phi_tiled - phi_mono))) < 1e-12


class TestSpatialShardedEvolution:
    # (8, 1) — ky over all 8 devices with a trivial 'v' axis — aborts
    # inside XLA's CPU compiler (SIGABRT in backend_compile_and_load) on
    # this jaxlib; (2,4)/(4,2) exercise the same ky transpose contract
    # with a non-trivial velocity axis and compile fine on CPU and GPU.
    @pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
    def test_state_parity_across_meshes(self, shape):
        cfg = _cfg()
        final_1, trace_1 = run_nonlinear_gk(cfg, seed=5)
        mesh = spatial_velocity_mesh(*shape)
        final_s, trace_s = run_nonlinear_gk_spatial_sharded(
            cfg, mesh, seed=5)
        scale = float(jnp.max(jnp.abs(final_1.f)))
        dev = float(jnp.max(jnp.abs(final_s.f - final_1.f))) / scale
        # x64 suite: reduction-order noise only
        assert dev < 1e-10, f"mesh {shape}: f dev {dev:.2e}"
        for a, b in zip(trace_1[1:], trace_s[1:]):  # skip times
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-9, atol=1e-13)

    def test_electromagnetic_two_species(self):
        """EM + kinetic electrons: Ampere/B_par solves and the electron
        species must survive the ky transpose contract too."""
        cfg = _cfg(n_species=2, kinetic_electrons=True,
                   electromagnetic=True, beta_e=0.01, n_steps=4,
                   save_interval=2)
        final_1, _ = run_nonlinear_gk(cfg, seed=7)
        mesh = spatial_velocity_mesh(4, 2)
        final_s, _ = run_nonlinear_gk_spatial_sharded(cfg, mesh, seed=7)
        scale = float(jnp.max(jnp.abs(final_1.f)))
        dev = float(jnp.max(jnp.abs(final_s.f - final_1.f))) / scale
        assert dev < 1e-10

    def test_divisibility_guards(self):
        cfg = _cfg(n_ky=6)
        mesh = spatial_velocity_mesh(4, 2)
        with pytest.raises(ValueError, match="not divisible"):
            run_nonlinear_gk_spatial_sharded(cfg, mesh)

    def test_memory_scales_with_sy(self):
        """The point of the decomposition: per-device bytes of f shrink by
        the spatial shard count (addressable-shard check)."""
        cfg = _cfg()
        g = build_grids(cfg)
        state = init_state(cfg, g, seed=1)
        mesh = spatial_velocity_mesh(2, 4)
        sh = shard_state_spatial(state, mesh)
        total = sh.f.size * sh.f.dtype.itemsize
        per_dev = max(s.data.size * s.data.dtype.itemsize
                      for s in sh.f.addressable_shards)
        assert per_dev * 8 == total


class TestKxKySharded3D:
    """(sx, sy, v) = (kx, ky, mu) mesh (VERDICT r4 next #5): the kx axis
    joins the decomposition, adding the radial-spectral all-to-all of the
    pseudo-spectral bracket and the collective-permute of the ballooning
    kx-twist to the collective contract."""

    @pytest.mark.parametrize("shape", [(2, 2, 2), (4, 2, 1), (2, 4, 1)])
    def test_state_parity_across_3d_meshes(self, shape):
        from scpn_fusion_tpu.parallel.gk_shard import (
            run_nonlinear_gk_spatial_sharded_3d, spatial_mesh_3d,
        )
        cfg = _cfg()
        final_1, trace_1 = run_nonlinear_gk(cfg, seed=5)
        mesh = spatial_mesh_3d(*shape)
        final_s, trace_s = run_nonlinear_gk_spatial_sharded_3d(
            cfg, mesh, seed=5)
        scale = float(jnp.max(jnp.abs(final_1.f)))
        dev = float(jnp.max(jnp.abs(final_s.f - final_1.f))) / scale
        assert dev < 1e-10, f"mesh {shape}: f dev {dev:.2e}"
        for a, b in zip(trace_1[1:], trace_s[1:]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-9, atol=1e-13)

    def test_em_two_species_3d(self):
        from scpn_fusion_tpu.parallel.gk_shard import (
            run_nonlinear_gk_spatial_sharded_3d, spatial_mesh_3d,
        )
        cfg = _cfg(n_species=2, kinetic_electrons=True,
                   electromagnetic=True, beta_e=0.01, n_steps=4,
                   save_interval=2)
        final_1, _ = run_nonlinear_gk(cfg, seed=7)
        mesh = spatial_mesh_3d(2, 2, 2)
        final_s, _ = run_nonlinear_gk_spatial_sharded_3d(cfg, mesh, seed=7)
        scale = float(jnp.max(jnp.abs(final_1.f)))
        dev = float(jnp.max(jnp.abs(final_s.f - final_1.f))) / scale
        assert dev < 1e-10

    def test_divisibility_guards_3d(self):
        from scpn_fusion_tpu.parallel.gk_shard import (
            run_nonlinear_gk_spatial_sharded_3d, spatial_mesh_3d,
        )
        mesh = spatial_mesh_3d(4, 2, 1)
        with pytest.raises(ValueError, match="n_kx.*not divisible"):
            run_nonlinear_gk_spatial_sharded_3d(_cfg(n_kx=6), mesh)

    def test_memory_scales_with_full_mesh(self):
        """Per-device bytes shrink by the FULL mesh size — the
        multi-chip-mandatory claim in measurable form."""
        from scpn_fusion_tpu.parallel.gk_shard import (
            per_device_state_bytes, shard_state_spatial_3d, spatial_mesh_3d,
        )
        cfg = _cfg()
        g = build_grids(cfg)
        state = init_state(cfg, g, seed=1)
        mesh = spatial_mesh_3d(2, 2, 2)
        sh = shard_state_spatial_3d(state, mesh)
        ev = per_device_state_bytes(sh)
        assert ev["n_shards"] == 8
        assert ev["reduction_factor"] == 8.0
        assert ev["bytes_per_device"] * 8 == ev["monolithic_bytes"]
