"""Self-organised-criticality sandpile transport model.

Role-parity with the reference's SOC lane (Rust
``fusion-physics/src/sandpile.rs`` running the classic
Hwa-Kardar/Bak-style 1D sandpile as a turbulence-transport cartoon, and
``control/advanced_soc_fusion_learning.py`` which learns on avalanche
statistics).  JAX-native: the pile is a 1D array, one drive-relax cycle is
a fixed number of synchronous toppling sweeps (branch-free ``jnp.where``),
and the whole drive sequence runs in one ``lax.scan`` — avalanche sizes
and the criticality statistics come out as traced arrays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SandpileConfig:
    n_cells: int = 128
    critical_slope: float = 4.0
    topple_amount: float = 2.0     # transferred downhill per topple
    drive_amount: float = 1.0      # grains added per drive step
    relax_sweeps: int = 64         # synchronous sweeps per drive
    n_steps: int = 2000
    drive_location: str = "random"  # "random" | "core"

    def __post_init__(self):
        if self.topple_amount >= self.critical_slope:
            raise ValueError("topple_amount must be < critical_slope")


class SandpileTrace(NamedTuple):
    heights_final: jnp.ndarray   # (n_cells,)
    avalanche_sizes: jnp.ndarray  # (n_steps,) topples per drive
    flux_out: jnp.ndarray        # (n_steps,) grains leaving the edge
    mean_slope: jnp.ndarray      # (n_steps,)


def _relax(cfg: SandpileConfig, h: jnp.ndarray):
    """relax_sweeps synchronous toppling sweeps; returns (h, topples,
    edge_flux)."""
    def sweep(carry, _):
        h, n_top, out = carry
        slope = h - jnp.concatenate([h[1:], jnp.zeros(1, h.dtype)])
        unstable = slope > cfg.critical_slope
        move = jnp.where(unstable, cfg.topple_amount, 0.0)
        h1 = h - move
        h1 = h1 + jnp.concatenate([jnp.zeros(1, h.dtype), move[:-1]])
        out = out + move[-1]            # last cell spills off the edge
        n_top = n_top + jnp.sum(unstable)
        return (h1, n_top, out), None

    (h, n_top, out), _ = jax.lax.scan(
        sweep, (h, jnp.asarray(0.0, h.dtype), jnp.asarray(0.0, h.dtype)),
        None, length=cfg.relax_sweeps)
    return h, n_top, out


def run_sandpile(cfg: SandpileConfig, seed: int = 0) -> SandpileTrace:
    """Drive-relax SOC evolution in one compiled scan."""
    key = jax.random.PRNGKey(seed)

    def step(carry, k):
        h, key = carry
        key, sub = jax.random.split(key)
        if cfg.drive_location == "core":
            idx = 0
        else:
            idx = jax.random.randint(sub, (), 0, cfg.n_cells // 2)
        h = h.at[idx].add(cfg.drive_amount)
        h, n_top, out = _relax(cfg, h)
        slope = jnp.mean(h[:-1] - h[1:])
        return (h, key), (n_top, out, slope)

    h0 = jnp.zeros(cfg.n_cells)
    (h, _), (sizes, flux, slopes) = jax.lax.scan(
        step, (h0, key), jnp.arange(cfg.n_steps))
    return SandpileTrace(heights_final=h, avalanche_sizes=sizes,
                         flux_out=flux, mean_slope=slopes)


def avalanche_statistics(trace: SandpileTrace) -> dict:
    """SOC fingerprints: broad avalanche distribution + marginal slope."""
    sizes = jnp.asarray(trace.avalanche_sizes)
    active = sizes[sizes > 0]
    mean = jnp.mean(active) if active.size else jnp.asarray(0.0)
    return {
        "mean_avalanche": float(mean),
        "max_avalanche": float(jnp.max(sizes)),
        "fraction_quiet": float(jnp.mean(sizes == 0)),
        "final_mean_slope": float(trace.mean_slope[-1]),
        "total_flux_out": float(jnp.sum(trace.flux_out)),
    }
