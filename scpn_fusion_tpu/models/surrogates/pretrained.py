"""Pretrained surrogate artifacts: NPZ weights + checksummed metrics.

Role-parity with the reference's committed surrogate artifacts
(``weights/*.npz`` + ``weights/neural_transport_qlknn.metrics.json``,
loaded by ``core/pretrained_surrogates.py`` / ``neural_transport*.py``):
trained parameter sets ship in-repo as NPZ with a sidecar metrics JSON
(sha256 of the weights, training config, held-out error), and loading is
fail-closed — a checksum mismatch or missing metrics refuses to load.

``train_transport_surrogate`` (re)builds the neural-transport artifact: an
MLP mapping local dimensionless inputs [R/L_Ti, R/L_Te, R/L_ne, q, s_hat,
Te/Ti, nu_star] -> [chi_i, chi_e, D_e] in gyro-Bohm units, trained on the
framework's own physics closures (gyro-Bohm + Chang-Hinton + a critical-
gradient ITG lane) — the same teacher-distillation role QLKNN plays in the
reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.models.surrogates.mlp import (
    MLPParams,
    init_mlp,
    mlp_apply,
    train_mlp,
)

WEIGHTS_DIR = Path(__file__).resolve().parents[3] / "weights"
N_IN, N_OUT = 7, 3


def _teacher_fluxes(x: np.ndarray) -> np.ndarray:
    """Reduced physics teacher (gyro-Bohm units).

    chi_i: critical-gradient ITG stiffness + neoclassical floor;
    chi_e: TEM-like fraction of chi_i driven by R/L_Te and collisionality;
    D_e: particle channel tied to R/L_ne with a pinch offset.
    """
    rlti, rlte, rlne, q, s_hat, te_ti, nu_star = x.T
    rlti_crit = 4.0 * (1.0 + 0.5 * np.maximum(s_hat, 0.0)) / np.maximum(
        te_ti, 0.3)
    itg = np.maximum(rlti - rlti_crit, 0.0)
    chi_i = 0.05 + 1.2 * q ** 1.5 * itg / (1.0 + 0.3 * nu_star)
    tem = np.maximum(rlte - 3.5, 0.0)
    chi_e = 0.03 + 0.6 * q * tem / (1.0 + 0.5 * nu_star) + 0.2 * chi_i
    d_e = 0.02 + 0.3 * np.maximum(rlne - 1.0, 0.0) + 0.1 * chi_e
    return np.stack([chi_i, chi_e, d_e], axis=1)


def _sample_inputs(n: int, rng: np.random.Generator) -> np.ndarray:
    """Training envelope — covers the clipped bands the transport loop
    feeds the closure (``solver._local_surrogate_inputs``), so in-loop
    inputs are in-distribution by construction and the OOD gate fires on
    genuine envelope exits (e.g. non-physical q excursions), not on
    routine edge gradients."""
    return np.stack([
        rng.uniform(0.0, 20.0, n),    # R/L_Ti
        rng.uniform(0.0, 20.0, n),    # R/L_Te
        rng.uniform(0.0, 20.0, n),    # R/L_ne
        rng.uniform(0.8, 6.0, n),     # q
        rng.uniform(-1.0, 4.0, n),    # s_hat
        rng.uniform(0.05, 3.0, n),    # Te/Ti
        10.0 ** rng.uniform(-3.0, 2.0, n),   # nu_star (log-uniform)
    ], axis=1)


def train_transport_surrogate(*, name: str = "neural_transport",
                              n_train: int = 20_000, n_test: int = 2000,
                              hidden=(64, 64), n_steps: int = 4000,
                              seed: int = 0,
                              out_dir: Path | None = None) -> dict:
    """Train, evaluate, and write the NPZ + metrics artifact pair."""
    rng = np.random.default_rng(seed)
    x_tr = _sample_inputs(n_train, rng)
    x_te = _sample_inputs(n_test, rng)
    y_tr = _teacher_fluxes(x_tr)
    y_te = _teacher_fluxes(x_te)

    x_mean, x_std = x_tr.mean(0), x_tr.std(0) + 1e-9
    y_mean, y_std = y_tr.mean(0), y_tr.std(0) + 1e-9
    xn = jnp.asarray((x_tr - x_mean) / x_std, jnp.float32)
    yn = jnp.asarray((y_tr - y_mean) / y_std, jnp.float32)

    key = jax.random.PRNGKey(seed)
    params = init_mlp(key, (N_IN, *hidden, N_OUT))
    res = train_mlp(params, xn, yn, jax.random.fold_in(key, 1),
                    n_steps=n_steps, batch_size=512, lr=1e-3)

    pred = np.asarray(mlp_apply(
        res.params, jnp.asarray((x_te - x_mean) / x_std, jnp.float32)))
    pred = pred * y_std + y_mean
    rel_l2 = float(np.linalg.norm(pred - y_te)
                   / max(np.linalg.norm(y_te), 1e-30))

    out = out_dir or WEIGHTS_DIR
    out.mkdir(parents=True, exist_ok=True)
    npz_path = out / f"{name}.npz"
    arrays = {}
    for i, (w, b) in enumerate(zip(res.params.weights, res.params.biases)):
        arrays[f"w{i}"] = np.asarray(w)
        arrays[f"b{i}"] = np.asarray(b)
    arrays["x_mean"], arrays["x_std"] = x_mean, x_std
    arrays["y_mean"], arrays["y_std"] = y_mean, y_std
    np.savez(npz_path, **arrays)

    metrics = {
        "artifact": name,
        "sha256": hashlib.sha256(npz_path.read_bytes()).hexdigest(),
        "test_rel_l2": rel_l2,
        "inputs": ["R_L_Ti", "R_L_Te", "R_L_ne", "q", "s_hat", "Te_Ti",
                   "nu_star"],
        "outputs": ["chi_i_gb", "chi_e_gb", "d_e_gb"],
        "hidden": list(hidden),
        "n_train": n_train,
        "seed": seed,
    }
    (out / f"{name}.metrics.json").write_text(json.dumps(metrics, indent=2))
    return metrics


def _save_artifact(name: str, arrays: dict, metrics: dict,
                   out_dir: Path | None = None) -> dict:
    """Write the NPZ + checksummed metrics pair for any named artifact."""
    out = out_dir or WEIGHTS_DIR
    out.mkdir(parents=True, exist_ok=True)
    npz_path = out / f"{name}.npz"
    np.savez(npz_path, **{k: np.asarray(v) for k, v in arrays.items()})
    metrics = dict(metrics)
    metrics["artifact"] = name
    metrics["sha256"] = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    (out / f"{name}.metrics.json").write_text(json.dumps(metrics, indent=2))
    return metrics


def _load_artifact(name: str, weights_dir: Path | None = None):
    """Fail-closed NPZ + metrics load (checksum must match)."""
    out = weights_dir or WEIGHTS_DIR
    npz_path = out / f"{name}.npz"
    metrics_path = out / f"{name}.metrics.json"
    if not npz_path.exists() or not metrics_path.exists():
        raise FileNotFoundError(f"missing artifact pair for {name!r} "
                                f"under {out}")
    metrics = json.loads(metrics_path.read_text())
    actual = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    if metrics.get("sha256") != actual:
        raise RuntimeError(
            f"surrogate artifact checksum mismatch for {name!r}: "
            "refusing to load")
    return np.load(npz_path), metrics


# ── FNO turbulence artifact (reference weights/fno_turbulence_jax.npz) ───


def _gene_like_field(grid: int, regime: str,
                     rng: np.random.Generator) -> np.ndarray:
    """Physics-informed GENE-like turbulence snapshot: anisotropic
    power-law spectrum per regime (reference
    ``fno_jax_training.py:176-210`` spectral character)."""
    k = np.fft.fftfreq(grid)
    kx, ky = np.meshgrid(k, k)
    alpha, aniso = {"ITG": (3.5, 1.0), "ETG": (2.2, 4.0),
                    "TEM": (2.8, 1.5)}[regime]
    k_eff = np.maximum(np.sqrt(kx**2 + (ky / aniso) ** 2), 1e-4)
    spectrum = k_eff**-alpha * np.exp(-(kx**2 + ky**2) / 0.5)
    noise = rng.standard_normal((grid, grid)) \
        + 1j * rng.standard_normal((grid, grid))
    field = np.real(np.fft.ifft2(noise * spectrum))
    return field / (np.abs(field).max() + 1e-9)


def _periodic_streamfunction(vort: np.ndarray) -> np.ndarray:
    """phi = -inv_Laplacian(vorticity) on the periodic box (the
    polarisation closure the FNO learns; classic operator-learning task)."""
    grid = vort.shape[0]
    k = 2.0 * np.pi * np.fft.fftfreq(grid)
    kx, ky = np.meshgrid(k, k)
    k2 = kx**2 + ky**2
    k2[0, 0] = 1.0
    phi_ft = np.fft.fft2(vort) / k2
    phi_ft[0, 0] = 0.0
    return np.real(np.fft.ifft2(phi_ft))


def train_fno_turbulence(*, name: str = "fno_turbulence",
                         n_train: int = 384, n_test: int = 48,
                         grid: int = 64, width: int = 24, modes: int = 12,
                         n_layers: int = 3, n_steps: int = 2500,
                         seed: int = 0,
                         out_dir: Path | None = None) -> dict:
    """Train + commit the FNO turbulence artifact: GENE-like vorticity
    snapshots (ITG/TEM/ETG spectral regimes) -> periodic streamfunction.
    Reference gate: val rel-L2 0.055 (``weights/fno_turbulence_jax``)."""
    from scpn_fusion_tpu.models.surrogates.fno import (
        fno_apply_batched,
        init_fno,
        train_fno,
    )

    rng = np.random.default_rng(seed)
    regimes = ["ITG", "TEM", "ETG"]

    def make(n, scale=None):
        x = np.stack([_gene_like_field(grid, regimes[i % 3], rng)
                      for i in range(n)])
        y = np.stack([_periodic_streamfunction(f) for f in x])
        scale = y.std() if scale is None else scale
        return (x[..., None].astype(np.float32),
                (y / scale)[..., None].astype(np.float32), scale)

    x_tr, y_tr, scale = make(n_train)
    x_te, y_te, _ = make(n_test, scale)

    key = jax.random.PRNGKey(seed)
    params = init_fno(key, width=width, modes=modes, n_layers=n_layers)
    # One cosine-annealed Adam run (3e-3 -> 1e-5) split into <=1500-step
    # scan segments that thread params + opt_state (the schedule count
    # rides in the Adam state, so the anneal is continuous).  The target
    # operator is spectrally linear (truncation floor < 2e-4 at modes>=12),
    # so artifact quality is optimisation-limited: constant 3e-3 plateaus
    # near rel-L2 0.13 and staged restarts that re-init Adam near 0.084,
    # while the continuous anneal reaches the reference's 0.055 gate.
    # The committed artifacts were trained in these segments; the seeded
    # key schedule (fold_in per segment start) depends on them, so the
    # segment length stays to reproduce the artifacts.
    seg = 1500
    x_tr_j, y_tr_j = jnp.asarray(x_tr), jnp.asarray(y_tr)
    res = None
    done = 0
    while done < n_steps:
        k_steps = min(seg, n_steps - done)
        res = train_fno(params, x_tr_j, y_tr_j,
                        jax.random.fold_in(key, 1 + done),
                        n_steps=k_steps, batch_size=16, lr=3e-3,
                        schedule="cosine", total_steps=n_steps,
                        opt_state=None if res is None else res.opt_state)
        params = res.params
        done += k_steps

    pred = np.concatenate([
        np.asarray(fno_apply_batched(res.params, jnp.asarray(x_te[i:i + 8])))
        for i in range(0, len(x_te), 8)])
    rel_l2 = float(np.linalg.norm(pred - y_te)
                   / max(np.linalg.norm(y_te), 1e-30))

    arrays = {}
    leaves, treedef = jax.tree.flatten(res.params)
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"] = np.asarray(leaf)
    metrics = _save_artifact(name, arrays, {
        "test_rel_l2": rel_l2,
        "task": "GENE-like vorticity -> periodic streamfunction",
        "grid": grid, "width": width, "modes": modes,
        "n_layers": n_layers, "n_train": n_train, "seed": seed,
        # Output normalisation: predictions are streamfunction / y_scale;
        # users denormalise with this, NOT their own batch std.
        "y_scale": float(scale),
    }, out_dir)
    return metrics


def load_fno_turbulence(name: str = "fno_turbulence",
                        weights_dir: Path | None = None):
    """Fail-closed load; returns (predict_fn, metrics) where predict_fn
    maps (n, H, W, 1) vorticity to normalised streamfunction."""
    from scpn_fusion_tpu.models.surrogates.fno import (
        FNOParams,
        fno_apply_batched,
        init_fno,
    )

    data, metrics = _load_artifact(name, weights_dir)
    template = init_fno(jax.random.PRNGKey(0),
                        width=int(metrics["width"]),
                        modes=int(metrics["modes"]),
                        n_layers=int(metrics["n_layers"]))
    leaves, treedef = jax.tree.flatten(template)
    loaded = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
    params: FNOParams = jax.tree.unflatten(treedef, loaded)

    @jax.jit
    def predict(x):
        return fno_apply_batched(params, x)

    return predict, metrics


# ── Neural-equilibrium artifact (reference weights + 1.05 ms inference) ──


def train_equilibrium_artifact(*, name: str = "neural_equilibrium",
                               n_train: int = 160, n_test: int = 20,
                               grid_n: int = 65, n_modes: int = 12,
                               n_steps: int = 2500, seed: int = 0,
                               out_dir: Path | None = None) -> dict:
    """Train + commit the PCA+MLP equilibrium surrogate on REAL solver
    outputs: random (coil currents, Ip) around the standard 6-coil
    configuration -> converged free-boundary psi maps (reference
    ``neural_equilibrium.py:135-258`` role; O(ms) inference)."""
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
    from scpn_fusion_tpu.models.surrogates.equilibrium_surrogate import (
        train_equilibrium_surrogate,
    )

    base_coils = ((3.5, 4.8, -1.0), (8.0, 4.8, 4.0), (10.8, 0.0, 6.0),
                  (8.0, -4.8, 4.0), (3.5, -4.8, -1.0), (10.8, 2.5, 3.0))
    cfg = ReactorConfig(
        reactor_name="surrogate-train",
        grid_resolution=(grid_n, grid_n),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=tuple(Coil(r=r, z=z, current=c) for r, z, c in base_coils),
        physics=PhysicsParams(plasma_current_target=150.0,
                              vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=80, convergence_threshold=1e-4,
                            relaxation_factor=0.1,
                            solver_method="multigrid"))
    grid = Grid.from_config(cfg, dtype=np.float32)
    coils0 = coilset_from_config(cfg, jnp.float32)

    rng = np.random.default_rng(seed)
    n_total = n_train + n_test
    base_i = np.asarray(coils0.currents)
    # Inputs = the 6 coil currents only: Ip lives in the STATIC config, so
    # varying it would force one XLA recompile per training sample.
    inputs = (base_i[None, :]
              * rng.uniform(0.7, 1.3, (n_total, base_i.size))
              ).astype(np.float32)

    def solve_one(currents):
        c = coils0._replace(currents=jnp.asarray(currents))
        res = solve_free_boundary(cfg, c, grid=grid, mu0_green=1.0,
                                  dtype=jnp.float32)
        return np.asarray(res.psi)

    psi_maps = np.stack([solve_one(row) for row in inputs])

    key = jax.random.PRNGKey(seed)
    sur = train_equilibrium_surrogate(
        jnp.asarray(inputs[:n_train]), jnp.asarray(psi_maps[:n_train]),
        key, n_modes=n_modes, n_steps=n_steps)

    pred = np.stack([np.asarray(sur.predict(jnp.asarray(x)))
                     for x in inputs[n_train:]])
    truth = psi_maps[n_train:]
    rel_l2 = float(np.linalg.norm(pred - truth)
                   / max(np.linalg.norm(truth), 1e-30))

    arrays = {"components": sur.components, "psi_mean": sur.psi_mean,
              "x_mean": sur.x_mean, "x_std": sur.x_std,
              "coeff_scale": sur.coeff_scale}
    for i, (w, b) in enumerate(zip(sur.mlp.weights, sur.mlp.biases)):
        arrays[f"w{i}"] = np.asarray(w)
        arrays[f"b{i}"] = np.asarray(b)
    metrics = _save_artifact(name, arrays, {
        "test_rel_l2": rel_l2,
        "task": "6 coil currents -> free-boundary psi map (Ip fixed 150)",
        "grid": grid_n, "n_modes": n_modes,
        "n_train": n_train, "seed": seed,
    }, out_dir)
    return metrics


def load_equilibrium_artifact(name: str = "neural_equilibrium",
                              weights_dir: Path | None = None):
    """Fail-closed load; returns (surrogate, metrics)."""
    from scpn_fusion_tpu.models.surrogates.equilibrium_surrogate import (
        EquilibriumSurrogate,
    )

    data, metrics = _load_artifact(name, weights_dir)
    n_layers = sum(1 for k in data.files if k.startswith("w"))
    mlp = MLPParams(
        weights=tuple(jnp.asarray(data[f"w{i}"]) for i in range(n_layers)),
        biases=tuple(jnp.asarray(data[f"b{i}"]) for i in range(n_layers)))
    n = int(metrics["grid"])
    sur = EquilibriumSurrogate(
        mlp=mlp,
        components=jnp.asarray(data["components"]),
        psi_mean=jnp.asarray(data["psi_mean"]),
        x_mean=jnp.asarray(data["x_mean"]),
        x_std=jnp.asarray(data["x_std"]),
        coeff_scale=jnp.asarray(data["coeff_scale"]),
        shape=(n, n))
    return sur, metrics


class TransportSurrogate(NamedTuple):
    """Neural-transport closure as a PYTREE (flows through jit as a traced
    argument — the transport loop swaps closures without recompiling)."""

    params: MLPParams
    x_mean: jnp.ndarray
    x_std: jnp.ndarray
    y_mean: jnp.ndarray
    y_std: jnp.ndarray

    def fluxes_gb(self, x: jnp.ndarray) -> jnp.ndarray:
        """(n, 7) local inputs -> (n, 3) gyro-Bohm fluxes, non-negative."""
        xn = (x - self.x_mean) / self.x_std
        y = mlp_apply(self.params, xn.astype(self.x_mean.dtype)) \
            * self.y_std + self.y_mean
        return jnp.maximum(y, 0.0)

    def max_abs_z(self, x: jnp.ndarray) -> jnp.ndarray:
        """Per-row max |z-score| vs the TRAINING envelope — the OOD index
        (reference ``_select_neural_ood_indices`` severity metric,
        ``integrated_transport_solver_model.py:83-113``)."""
        return jnp.max(jnp.abs((x - self.x_mean) / self.x_std), axis=-1)


def load_transport_surrogate_pytree(
    name: str = "neural_transport",
    weights_dir: Path | None = None,
) -> tuple[TransportSurrogate, dict]:
    """Fail-closed load of the artifact as a :class:`TransportSurrogate`."""
    out = weights_dir or WEIGHTS_DIR
    npz_path = out / f"{name}.npz"
    metrics_path = out / f"{name}.metrics.json"
    if not npz_path.exists() or not metrics_path.exists():
        raise FileNotFoundError(f"missing artifact pair for {name!r} "
                                f"under {out}")
    metrics = json.loads(metrics_path.read_text())
    actual = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    if metrics.get("sha256") != actual:
        raise RuntimeError(
            f"surrogate artifact checksum mismatch for {name!r}: "
            "refusing to load (retrain with train_transport_surrogate)")
    data = np.load(npz_path)
    n_layers = sum(1 for k in data.files if k.startswith("w"))
    params = MLPParams(
        weights=tuple(jnp.asarray(data[f"w{i}"]) for i in range(n_layers)),
        biases=tuple(jnp.asarray(data[f"b{i}"]) for i in range(n_layers)))
    surrogate = TransportSurrogate(
        params=params,
        x_mean=jnp.asarray(data["x_mean"], jnp.float32),
        x_std=jnp.asarray(data["x_std"], jnp.float32),
        y_mean=jnp.asarray(data["y_mean"], jnp.float32),
        y_std=jnp.asarray(data["y_std"], jnp.float32))
    return surrogate, metrics


def load_transport_surrogate(name: str = "neural_transport",
                             weights_dir: Path | None = None):
    """Fail-closed load: checksum of the NPZ must match the metrics file.

    Returns (predict_fn, metrics) where predict_fn maps (n, 7) inputs to
    (n, 3) gyro-Bohm fluxes.
    """
    out = weights_dir or WEIGHTS_DIR
    npz_path = out / f"{name}.npz"
    metrics_path = out / f"{name}.metrics.json"
    if not npz_path.exists() or not metrics_path.exists():
        raise FileNotFoundError(f"missing artifact pair for {name!r} "
                                f"under {out}")
    metrics = json.loads(metrics_path.read_text())
    actual = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    if metrics.get("sha256") != actual:
        raise RuntimeError(
            f"surrogate artifact checksum mismatch for {name!r}: "
            "refusing to load (retrain with train_transport_surrogate)")
    data = np.load(npz_path)
    n_layers = sum(1 for k in data.files if k.startswith("w"))
    params = MLPParams(
        weights=tuple(jnp.asarray(data[f"w{i}"]) for i in range(n_layers)),
        biases=tuple(jnp.asarray(data[f"b{i}"]) for i in range(n_layers)))
    x_mean = jnp.asarray(data["x_mean"])
    x_std = jnp.asarray(data["x_std"])
    y_mean = jnp.asarray(data["y_mean"])
    y_std = jnp.asarray(data["y_std"])

    @jax.jit
    def predict(x):
        xn = (jnp.atleast_2d(x) - x_mean) / x_std
        y = mlp_apply(params, xn.astype(jnp.float32)) * y_std + y_mean
        # Diffusivities are non-negative by physical contract; the raw
        # regressor can undershoot near the stiff critical gradient.
        return jnp.maximum(y, 0.0)

    return predict, metrics
