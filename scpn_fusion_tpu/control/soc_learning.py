"""SOC predator-prey sandpile + tabular soft-Q learning, one fused program.

Compiled re-design of the reference's advanced SOC learning runtime
(``control/advanced_soc_fusion_learning.py``): ``CoupledSandpileReactor``
(:46-125) relaxes avalanches with a nested Python loop over active sites
and couples toppling to a zonal-flow predator-prey variable whose shear
raises the critical slope; ``FusionAIAgent`` (:128-218) is a tabular
soft-Q (entropy-regularised) learner stepped host-side for 10k steps
(:285-409).  Here the avalanche relaxation is ``max_sub_steps``
synchronous branch-free sweeps, the Q-table lives in the scan carry, and
the ENTIRE learning simulation — drive, relax, flow update, epsilon-greedy
action, soft-Q update — is one ``lax.scan`` under jit.

Disclosed delta: the reference topples active sites sequentially within a
sweep (so one site's grains can re-activate a neighbour inside the same
sweep); the synchronous update here is the standard parallel sandpile
variant — same SOC statistics, branch-free on the VPU.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class CoupledSandpileConfig:
    """Reactor constants (reference :22-28, :46-90)."""

    size: int = 60
    z_crit_base: float = 6.0
    flow_generation: float = 0.2
    flow_damping: float = 0.05
    shear_efficiency: float = 3.0
    max_sub_steps: int = 50
    flow_lo: float = 0.0
    flow_hi: float = 5.0
    energy_per_topple_mj: float = 0.05

    def __post_init__(self) -> None:
        if self.size < 8:
            raise ValueError("size must be >= 8.")
        if not 0.0 <= self.flow_damping < 1.0:
            raise ValueError("flow_damping must be in [0, 1).")
        if self.flow_lo >= self.flow_hi:
            raise ValueError("flow bounds must satisfy lo < hi.")


def coupled_sandpile_step(cfg: CoupledSandpileConfig, z: jnp.ndarray,
                          flow, external_shear):
    """One avalanche-relaxation step with shear-raised critical slope
    (reference ``step_physics`` :95-117).  Returns
    ``(z, flow, topples, eff_shear)``."""
    eff_shear = flow + external_shear
    z_crit = cfg.z_crit_base + cfg.shear_efficiency * eff_shear

    def sweep(carry, _):
        z, n_top = carry
        active = (z >= z_crit).astype(z.dtype)
        z1 = z - 2.0 * active
        z1 = z1 + jnp.concatenate([jnp.zeros(1, z.dtype), active[:-1]])
        z1 = z1 + jnp.concatenate([active[1:], jnp.zeros(1, z.dtype)])
        return (z1, n_top + jnp.sum(active)), None

    (z, topples), _ = jax.lax.scan(
        sweep, (z, jnp.asarray(0.0, z.dtype)), None,
        length=cfg.max_sub_steps)
    flow = flow + topples * cfg.flow_generation / cfg.size
    flow = jnp.clip(flow * (1.0 - cfg.flow_damping), cfg.flow_lo,
                    cfg.flow_hi)
    return z, flow, topples, eff_shear


@dataclasses.dataclass(frozen=True)
class SoftQConfig:
    """Tabular soft-Q learner constants (reference :30-36, :128-218)."""

    alpha: float = 0.1
    gamma: float = 0.95
    epsilon: float = 0.1
    n_states_turb: int = 5
    n_states_flow: int = 5
    n_actions: int = 3
    entropy_beta: float = 0.05

    def __post_init__(self) -> None:
        for name in ("alpha", "gamma", "epsilon"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1].")


def discretize_state(qcfg: SoftQConfig, turb, flow):
    """Map continuous (turbulence, flow) to Q-table indices
    (reference ``discretize_state`` :174-178)."""
    s_t = jnp.minimum(jnp.floor(jnp.log1p(jnp.maximum(turb, 0.0))),
                      qcfg.n_states_turb - 1).astype(jnp.int32)
    s_f = jnp.minimum(jnp.floor(jnp.maximum(flow, 0.0)),
                      qcfg.n_states_flow - 1).astype(jnp.int32)
    return s_t, s_f


def soft_q_update(qcfg: SoftQConfig, q_table, state, action, new_state,
                  reward):
    """Entropy-regularised Q update (reference ``learn`` :192-218):
    target = R + gamma (max Q(s') + beta H(softmax Q(s')))."""
    future = q_table[new_state]
    max_q = jnp.max(future)
    probs = jax.nn.softmax(future)
    entropy = -jnp.sum(probs * jnp.log(probs + 1e-9))
    target = reward + qcfg.gamma * (max_q + qcfg.entropy_beta * entropy)
    old = q_table[state + (action,)]
    return q_table.at[state + (action,)].set(
        old + qcfg.alpha * (target - old))


class SOCLearningTrace(NamedTuple):
    turbulence: jnp.ndarray     # (n,) avalanche sizes
    flow: jnp.ndarray
    core_temp: jnp.ndarray
    shear_ctrl: jnp.ndarray
    reward: jnp.ndarray


@partial(jax.jit, static_argnames=("cfg", "qcfg", "n_steps"))
def run_soc_learning(
    key: jnp.ndarray,
    *,
    cfg: CoupledSandpileConfig = CoupledSandpileConfig(),
    qcfg: SoftQConfig = SoftQConfig(),
    n_steps: int = 2000,
    noise_probability: float = 0.01,
    shear_step: float = 0.05,
    shear_lo: float = 0.0,
    shear_hi: float = 1.0,
):
    """Whole SOC + Q-learning control simulation as one scan (reference
    ``run_advanced_learning_sim`` :285-409: epsilon-greedy shear action,
    edge drive with noise, avalanche step, reward
    ``0.1 T_core - 0.5 avalanche - 2 shear``, soft-Q update).

    Returns ``(trace, summary, q_table)`` with the reference's summary
    keys.
    """
    def step(carry, inputs):
        z, flow, ext_shear, q_table, turb_prev, flow_prev = carry
        k_eps, k_act, k_noise = jax.random.split(inputs, 3)

        state = discretize_state(qcfg, turb_prev, flow_prev)
        greedy = jnp.argmax(q_table[state])
        random_a = jax.random.randint(k_act, (), 0, qcfg.n_actions)
        explore = jax.random.uniform(k_eps, ()) < qcfg.epsilon
        action = jnp.where(explore, random_a, greedy)

        ext_shear = jnp.clip(
            ext_shear + jnp.where(action == 2, shear_step, 0.0)
            - jnp.where(action == 0, shear_step, 0.0),
            shear_lo, shear_hi)

        drive = 1.0 + jnp.where(
            jax.random.uniform(k_noise, ()) < noise_probability, 1.0, 0.0)
        z = z.at[0].add(drive)
        z, flow, topples, _ = coupled_sandpile_step(cfg, z, flow, ext_shear)
        core_temp = jnp.sum(z)     # profile-energy proxy (:119-122)

        reward = 0.1 * core_temp - 0.5 * topples - 2.0 * ext_shear
        new_state = discretize_state(qcfg, topples, flow)
        q_table = soft_q_update(qcfg, q_table, state, action, new_state,
                                reward)
        out = SOCLearningTrace(topples, flow, core_temp, ext_shear, reward)
        return (z, flow, ext_shear, q_table, topples, flow), out

    q0 = jnp.zeros((qcfg.n_states_turb, qcfg.n_states_flow,
                    qcfg.n_actions))
    init = (jnp.zeros(cfg.size), jnp.asarray(0.0), jnp.asarray(0.0), q0,
            jnp.asarray(0.0), jnp.asarray(0.0))
    keys = jax.random.split(key, n_steps)
    (z, flow, ext, q_table, *_), trace = jax.lax.scan(step, init, keys)

    summary = {
        "final_core_temp": trace.core_temp[-1],
        "final_flow": trace.flow[-1],
        "final_external_shear": trace.shear_ctrl[-1],
        "mean_turbulence": jnp.mean(trace.turbulence),
        "mean_flow": jnp.mean(trace.flow),
        "mean_core_temp": jnp.mean(trace.core_temp),
        "max_external_shear": jnp.max(trace.shear_ctrl),
        "total_reward": jnp.sum(trace.reward),
        "q_table_mean": jnp.mean(q_table),
        "q_table_max_abs": jnp.max(jnp.abs(q_table)),
    }
    return trace, summary, q_table
