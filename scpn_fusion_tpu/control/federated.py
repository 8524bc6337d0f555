"""Federated disruption-predictor training (FedAvg / FedProx + DP-SGD).

JAX-native equivalent of the reference's cross-machine federation
(``control/federated_disruption.py:236-461`` ``MachineClient`` /
``FederatedServer`` with FedAvg aggregation and differential-privacy
clipping :166): same contract — one disruption-risk MLP trained across
tokamaks whose shot data never leave the "machine" — with a different
architecture: clients are not objects exchanging Python dicts; the whole
federation round is ONE jitted program.  Client weights are a stacked
pytree (leading axis = machine), local epochs run under ``vmap``, the
FedAvg reduction is a data-weighted tree-mean, and DP clip+noise uses
``jax.random.fold_in`` per (round, client).  On hardware the client axis
shards over the device mesh, so K machines train in parallel on K chips —
the federation topology IS the mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.models.surrogates.mlp import MLPParams, init_mlp, mlp_apply

# Feature layout: [locked_mode_amp, dbp_dt, q95, n_over_ngw, li, beta_n]
N_FEATURES = 6

MACHINE_SIGNATURES = {
    # machine: (locked_base, dbp_base, q95_base, ngw_base, li, beta_n)
    "diiid": (0.10, 0.12, 4.2, 0.55, 0.9, 1.9),
    "jet": (0.14, 0.15, 3.6, 0.62, 1.0, 1.7),
    "cmod": (0.08, 0.20, 4.6, 0.70, 1.1, 1.2),
    "aug": (0.11, 0.14, 4.0, 0.58, 0.95, 1.8),
}


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    machines: tuple[str, ...] = ("diiid", "jet", "cmod", "aug")
    n_samples: int = 256
    disruption_fraction: float = 0.3
    hidden: tuple[int, ...] = (32, 16)
    local_epochs: int = 5
    batch_size: int = 64
    learning_rate: float = 1e-2
    n_rounds: int = 10
    aggregation: str = "fedavg"        # "fedavg" | "fedprox"
    fedprox_mu: float = 0.1
    dp_enabled: bool = True
    dp_max_norm: float = 5.0
    dp_noise_sigma: float = 1e-3

    def __post_init__(self):
        if not self.machines:
            raise ValueError("at least one machine required")
        if not 0.0 < self.disruption_fraction < 1.0:
            raise ValueError("disruption_fraction must be in (0, 1)")
        if self.aggregation not in ("fedavg", "fedprox"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")


def generate_disruption_data(machine: str, n_samples: int,
                             disruption_fraction: float, seed: int):
    """Synthetic labelled shots for one machine (reference
    ``_generate_disruption_data`` :189 contract: disruptive shots have
    elevated locked-mode amplitude and dB_p/dt, depressed q95, higher
    Greenwald fraction)."""
    if machine not in MACHINE_SIGNATURES:
        raise ValueError(f"unknown machine {machine!r}")
    lm, db, q95, ngw, li, bn = MACHINE_SIGNATURES[machine]
    rng = np.random.default_rng(seed)
    n_dis = int(n_samples * disruption_fraction)
    n_safe = n_samples - n_dis
    safe = np.stack([
        rng.normal(lm, 0.03, n_safe),
        rng.normal(db, 0.04, n_safe),
        rng.normal(q95, 0.4, n_safe),
        rng.normal(ngw, 0.08, n_safe),
        rng.normal(li, 0.08, n_safe),
        rng.normal(bn, 0.2, n_safe),
    ], axis=1)
    dis = np.stack([
        rng.normal(lm * 4.0, 0.08, n_dis),
        rng.normal(db * 3.0, 0.08, n_dis),
        rng.normal(q95 - 1.2, 0.4, n_dis),
        rng.normal(min(ngw + 0.35, 0.98), 0.06, n_dis),
        rng.normal(li + 0.25, 0.1, n_dis),
        rng.normal(bn + 0.6, 0.25, n_dis),
    ], axis=1)
    x = np.concatenate([safe, dis], axis=0).astype(np.float32)
    y = np.concatenate([np.zeros(n_safe), np.ones(n_dis)]).astype(np.float32)
    perm = rng.permutation(n_samples)
    return jnp.asarray(x[perm]), jnp.asarray(y[perm])


# Fixed per-feature standardisation (order-of-magnitude centring so the
# MLP sees O(1) inputs on every machine; constants are part of the model
# contract, not fit to data).
_FEAT_MEAN = jnp.asarray([0.2, 0.2, 3.8, 0.65, 1.0, 1.9], jnp.float32)
_FEAT_SCALE = jnp.asarray([0.15, 0.15, 0.8, 0.15, 0.15, 0.4], jnp.float32)


def _featurize(x):
    return (x - _FEAT_MEAN.astype(x.dtype)) / _FEAT_SCALE.astype(x.dtype)


def _bce_loss(params: MLPParams, x, y):
    logits = mlp_apply(params, _featurize(x))[:, 0]
    z = jnp.clip(logits, -30.0, 30.0)
    # numerically-stable BCE-with-logits
    return jnp.mean(jnp.maximum(z, 0.0) - z * y + jnp.log1p(jnp.exp(-jnp.abs(z))))


def dp_clip_and_noise(update, max_norm: float, sigma: float, key):
    """Global-norm clip + Gaussian noise on a model update (DP-SGD shape,
    Abadi et al. 2016; reference ``differential_privacy_clip`` :166)."""
    leaves = jax.tree.leaves(update)
    total = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2) for g in leaves))
    factor = jnp.minimum(1.0, max_norm / jnp.maximum(total, 1e-12))
    keys = jax.random.split(key, len(leaves))
    flat, treedef = jax.tree.flatten(update)
    noised = [g * factor + sigma * jax.random.normal(k, g.shape, g.dtype)
              for g, k in zip(flat, keys)]
    return jax.tree.unflatten(treedef, noised)


class FederatedState(NamedTuple):
    global_params: MLPParams
    round_idx: jnp.ndarray


class FederatedTrace(NamedTuple):
    loss: jnp.ndarray          # (n_rounds, n_machines) local post-train loss
    global_loss: jnp.ndarray   # (n_rounds,) mean eval loss of global model
    accuracy: jnp.ndarray      # (n_rounds,) global-model accuracy


def _local_train(cfg: FederatedConfig, params: MLPParams, x, y, key,
                 global_params: MLPParams) -> tuple[MLPParams, jnp.ndarray]:
    """local_epochs of minibatch SGD (optionally FedProx-proximal)."""
    n = x.shape[0]
    n_batches = max(n // cfg.batch_size, 1)

    def loss_fn(p, xb, yb):
        loss = _bce_loss(p, xb, yb)
        if cfg.aggregation == "fedprox":
            prox = sum(jnp.sum((a - b) ** 2) for a, b in zip(
                jax.tree.leaves(p), jax.tree.leaves(global_params)))
            loss = loss + 0.5 * cfg.fedprox_mu * prox
        return loss

    def epoch(p, k):
        perm = jax.random.permutation(k, n)

        def batch_step(p, i):
            idx = jax.lax.dynamic_slice_in_dim(perm, i * cfg.batch_size,
                                               cfg.batch_size)
            g = jax.grad(loss_fn)(p, x[idx], y[idx])
            p = jax.tree.map(lambda w, gw: w - cfg.learning_rate * gw, p, g)
            return p, None

        p, _ = jax.lax.scan(batch_step, p, jnp.arange(n_batches))
        return p, None

    params, _ = jax.lax.scan(epoch, params,
                             jax.random.split(key, cfg.local_epochs))
    return params, _bce_loss(params, x, y)


@partial(jax.jit, static_argnums=(0,))
def _run_federation(cfg: FederatedConfig, global_params: MLPParams,
                    xs, ys, weights, key):
    """All federation rounds compiled into one program.

    xs, ys: (n_machines, n_samples, ...) stacked client datasets.
    weights: (n_machines,) data-size FedAvg weights.
    """
    def one_round(carry, k):
        gp = carry
        keys = jax.random.split(k, xs.shape[0] + 1)
        client_keys, dp_key = keys[:-1], keys[-1]

        locals_, losses = jax.vmap(
            lambda x, y, ck: _local_train(cfg, gp, x, y, ck, gp)
        )(xs, ys, client_keys)

        # Client update = local - global; DP applies to the update.
        updates = jax.tree.map(lambda l, g: l - g[None], locals_, gp)
        if cfg.dp_enabled:
            dp_keys = jax.random.split(dp_key, xs.shape[0])
            updates = jax.vmap(lambda u, dk: dp_clip_and_noise(
                u, cfg.dp_max_norm, cfg.dp_noise_sigma, dk))(updates, dp_keys)

        w = weights / jnp.sum(weights)
        gp = jax.tree.map(
            lambda g, u: (g + jnp.tensordot(w.astype(u.dtype), u,
                                            axes=(0, 0))).astype(g.dtype),
            gp, updates)

        # Global-model eval across all pooled client data.
        logits = jax.vmap(lambda x: mlp_apply(gp, _featurize(x))[:, 0])(xs)
        z = jnp.clip(logits, -30.0, 30.0)
        gl = jnp.mean(jnp.maximum(z, 0.0) - z * ys
                      + jnp.log1p(jnp.exp(-jnp.abs(z))))
        acc = jnp.mean(((jax.nn.sigmoid(z) > 0.5) == (ys > 0.5)))
        return gp, (losses, gl, acc)

    gp, (losses, gl, acc) = jax.lax.scan(
        one_round, global_params, jax.random.split(key, cfg.n_rounds))
    return gp, FederatedTrace(loss=losses, global_loss=gl, accuracy=acc)


def train_federated(cfg: FederatedConfig, seed: int = 0):
    """Build per-machine datasets, run all rounds, return (params, trace)."""
    xs, ys = [], []
    for i, m in enumerate(cfg.machines):
        x, y = generate_disruption_data(
            m, cfg.n_samples, cfg.disruption_fraction, seed=seed + 17 * i)
        xs.append(x)
        ys.append(y)
    xs = jnp.stack(xs)
    ys = jnp.stack(ys)
    weights = jnp.full((len(cfg.machines),), float(cfg.n_samples))
    key = jax.random.PRNGKey(seed)
    params = init_mlp(key, (N_FEATURES, *cfg.hidden, 1))
    return _run_federation(cfg, params, xs, ys, weights,
                           jax.random.fold_in(key, 1))


def predict_disruption_risk(params: MLPParams, features) -> jnp.ndarray:
    """Sigmoid risk in [0, 1] for raw feature rows."""
    return jax.nn.sigmoid(
        mlp_apply(params, _featurize(jnp.atleast_2d(features)))[:, 0])
