"""Committed surrogate artifacts: FNO turbulence + neural equilibrium.

Parity anchors: reference weights/fno_turbulence_jax.npz (val rel-L2
0.055) and the neural-equilibrium surrogate (129^2, 1.05 ms inference,
BASELINE.md).  Loading is fail-closed: checksum mismatch refuses.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from scpn_fusion_tpu.models.surrogates.pretrained import (
    WEIGHTS_DIR,
    _gene_like_field,
    _periodic_streamfunction,
    load_equilibrium_artifact,
    load_fno_turbulence,
)


class TestFNOArtifact:
    def test_loads_and_metrics_gate(self):
        predict, metrics = load_fno_turbulence()
        assert metrics["test_rel_l2"] < 0.25   # the reference QLKNN-class gate
        assert metrics["sha256"]

    def test_predicts_streamfunction(self):
        predict, metrics = load_fno_turbulence()
        rng = np.random.default_rng(99)
        grid = int(metrics["grid"])
        x = np.stack([_gene_like_field(grid, r, rng)
                      for r in ("ITG", "TEM", "ETG")])
        y = np.stack([_periodic_streamfunction(f) for f in x])
        scale = metrics["y_scale"]   # the artifact's output normalisation
        pred = np.asarray(predict(jnp.asarray(x[..., None], jnp.float32)))
        rel = np.linalg.norm(pred[..., 0] - y / scale) / \
            np.linalg.norm(y / scale)
        # Fresh fields, fresh seed: the operator generalises.
        assert rel < 2.0 * metrics["test_rel_l2"] + 0.05

    def test_tampered_npz_refuses(self, tmp_path):
        import shutil
        for ext in (".npz", ".metrics.json"):
            shutil.copy(WEIGHTS_DIR / f"fno_turbulence{ext}",
                        tmp_path / f"fno_turbulence{ext}")
        blob = bytearray((tmp_path / "fno_turbulence.npz").read_bytes())
        blob[len(blob) // 2] ^= 0xFF   # guaranteed content change
        (tmp_path / "fno_turbulence.npz").write_bytes(bytes(blob))
        with pytest.raises(RuntimeError, match="checksum"):
            load_fno_turbulence(weights_dir=tmp_path)


class TestEquilibriumArtifact:
    def test_loads_and_metrics_gate(self):
        sur, metrics = load_equilibrium_artifact()
        assert metrics["test_rel_l2"] < 0.02
        assert sur.shape == (int(metrics["grid"]),) * 2

    def test_predicts_solver_output(self):
        """Surrogate psi vs a fresh full free-boundary solve."""
        from scpn_fusion_tpu.models.surrogates import pretrained as pt

        sur, metrics = load_equilibrium_artifact()
        # Reconstruct the training configuration and solve one fresh case.
        import dataclasses as dc

        import jax

        from scpn_fusion_tpu.core.config import (
            Coil,
            Dimensions,
            PhysicsParams,
            ReactorConfig,
            SolverParams,
        )
        from scpn_fusion_tpu.core.grid import Grid
        from scpn_fusion_tpu.models.equilibrium.free_boundary import (
            coilset_from_config,
            solve_free_boundary,
        )

        n = int(metrics["grid"])
        base_coils = ((3.5, 4.8, -1.0), (8.0, 4.8, 4.0), (10.8, 0.0, 6.0),
                      (8.0, -4.8, 4.0), (3.5, -4.8, -1.0), (10.8, 2.5, 3.0))
        cfg = ReactorConfig(
            reactor_name="surrogate-train",
            grid_resolution=(n, n),
            dimensions=Dimensions(R_min=2.0, R_max=10.0,
                                  Z_min=-4.0, Z_max=4.0),
            coils=tuple(Coil(r=r, z=z, current=c)
                        for r, z, c in base_coils),
            physics=PhysicsParams(plasma_current_target=150.0,
                                  vacuum_permeability=1.0),
            solver=SolverParams(max_iterations=80,
                                convergence_threshold=1e-4,
                                relaxation_factor=0.1,
                                solver_method="multigrid"))
        grid = Grid.from_config(cfg, dtype=np.float32)
        coils = coilset_from_config(cfg, jnp.float32)
        rng = np.random.default_rng(555)
        currents = np.asarray(coils.currents) * rng.uniform(0.8, 1.2, 6)
        truth = solve_free_boundary(
            cfg, coils._replace(currents=jnp.asarray(currents,
                                                     jnp.float32)),
            grid=grid, mu0_green=1.0, dtype=jnp.float32).psi
        pred = sur.predict(jnp.asarray(currents, jnp.float32))
        rel = float(jnp.linalg.norm(pred - truth)
                    / jnp.maximum(jnp.linalg.norm(truth), 1e-30))
        assert rel < 0.05    # fresh sample within 5% relative L2

    def test_inference_is_two_matmuls_fast(self):
        """O(ms)-class inference (reference: 1.05 ms on CPU at 129^2)."""
        import time

        import jax

        sur, _ = load_equilibrium_artifact()
        x = jnp.asarray(np.ones(6), jnp.float32)
        predict = jax.jit(sur.predict)
        jax.block_until_ready(predict(x))
        t0 = time.perf_counter()
        for _ in range(50):
            jax.block_until_ready(predict(x))
        per_call_ms = (time.perf_counter() - t0) / 50 * 1e3
        assert per_call_ms < 50.0   # dispatch-dominated


def test_metrics_files_are_committed_and_consistent():
    for name in ("neural_transport", "fno_turbulence", "neural_equilibrium"):
        metrics = json.loads(
            (WEIGHTS_DIR / f"{name}.metrics.json").read_text())
        assert metrics["artifact"] == name
        assert (WEIGHTS_DIR / f"{name}.npz").exists()
        assert 0.0 < metrics["test_rel_l2"] < 1.0
