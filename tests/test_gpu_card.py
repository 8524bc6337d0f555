"""Card-only tests: the equilibrium path compiled for the GPU against the
same program on the CPU.  Run on an NVIDIA GPU with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_card.py

Elsewhere the ``gpu`` fixture skips them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scpn_fusion_tpu.core import backend
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium.fixed_boundary import _anderson_mix
from scpn_fusion_tpu.ops.multigrid import vcycle
from scpn_fusion_tpu.ops.stencil import gs_operator

pytestmark = pytest.mark.gpu


def _cpu(fn):
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        return np.asarray(fn())


def _problem(n, dtype):
    grid = Grid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0,
                            dtype=np.dtype(jnp.dtype(dtype).name))
    rr, zz = np.asarray(grid.RR), np.asarray(grid.ZZ)
    exact = np.exp(-((rr - 6.0) ** 2 + zz ** 2) / 3.0)
    rng = np.random.default_rng(n)
    psi0 = exact + 0.1 * rng.standard_normal(exact.shape)
    psi0[0], psi0[-1], psi0[:, 0], psi0[:, -1] = (
        exact[0], exact[-1], exact[:, 0], exact[:, -1])
    src = np.asarray(gs_operator(jnp.asarray(exact, dtype), grid.R, grid.dR,
                                 grid.dZ))
    return grid, psi0.astype(dtype), src.astype(dtype)


def test_backend_reports_the_gpu(gpu):
    info = backend.require_gpu()
    assert info.platform == "gpu"
    assert info.count == len(gpu)


def test_vcycle_f64_gpu_matches_cpu(gpu):
    grid, psi0, src = _problem(129, np.float64)

    def run():
        return vcycle(jnp.asarray(psi0), jnp.asarray(src), grid.R,
                      grid.dR, grid.dZ)

    out, ref = np.asarray(run()), _cpu(run)
    assert np.max(np.abs(out - ref)) / (ref.max() - ref.min()) < 1e-12


def test_anderson_mix_f32_tracks_f64(gpu):
    """The mixing contractions keep full float32 precision with TF32 forced
    as the default.  On an H100 the float32 mix lands 1.5e-7 from float64
    (relative to max |psi|); through TF32 operands it landed 1.7e-6."""
    rng = np.random.default_rng(0)
    m, n = 4, 257
    psi = 40.0 + rng.standard_normal((m, n, n))
    f = 1e-2 * rng.standard_normal((m, n, n))
    with jax.default_matmul_precision("tensorfloat32"):
        mixed32 = _anderson_mix(jnp.asarray(psi, jnp.float32),
                                jnp.asarray(f, jnp.float32), jnp.int32(m))
    ref = _cpu(lambda: _anderson_mix(jnp.asarray(psi), jnp.asarray(f),
                                     jnp.int32(m)))
    dev = np.max(np.abs(np.asarray(mixed32, np.float64) - ref))
    assert dev / np.max(np.abs(ref)) < 5e-7
