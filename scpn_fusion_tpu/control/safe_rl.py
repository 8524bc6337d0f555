"""Safe RL: shielded tokamak environment + Lagrangian PPO.

JAX-native equivalent of the reference RL stack
(``control/shielded_tokamak_env.py:52-270``,
``control/safe_rl_controller.py:33-330``):

* A reduced 0-D tokamak plant (I_p, beta_N, q95, Z) as a pure function —
  the gym-style mutable env becomes ``env_reset``/``env_step`` over an
  explicit state, so whole episodes run inside ``lax.scan`` and a batch
  of episodes is one ``vmap``.
* Action shielding: interlock channels (heating / current / vertical)
  gate action components with freeze / non-negative / non-positive
  clamps; the channel logic mirrors ``SafetyInterlockRuntime`` (the full
  Petri-net interlock lives in ``scpn/safety_interlocks.py``) in a
  branch-free jittable form, and a Lyapunov position guard
  V = 2(1 - exp(-(dR^2+dZ^2)/2)) halts the episode after sustained growth
  (reference ``position_error_lyapunov_v`` + ``LyapunovGuard``).
* ``LagrangianPPO``: clipped-surrogate PPO on a linear-Gaussian policy
  with Monte-Carlo return-to-go advantages (primal) and dual ascent
  lambda_i <- max(0, lambda_i + lr (C_i - d_i)) on constraint costs
  (q95 lower bound, beta_N upper bound, I_p positivity).  The reference
  collects episodes one Python step at a time; here a full train
  iteration (collect 16 episodes x 100 steps, 4 PPO epochs, dual update)
  is a single jitted call.

Observation layout (this framework): [I_p, beta_N, q95, Z, dR_err, dZ_err]
— the reference uses two inconsistent layouts between its shield and its
cost functions; we use one and keep the same constraint semantics.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

OBS_DIM = 6
ACT_DIM = 3     # [dIp command, heating command, vertical coil command]

FREEZE, NONNEGATIVE, NONPOSITIVE = 0, 1, 2


# ---------------------------------------------------------------------------
# Reduced tokamak plant
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokamakEnvParams:
    dt: float = 0.05
    ip_target: float = 15.0        # MA
    beta_target: float = 2.5
    q95_coeff: float = 45.0        # q95 ~ coeff / Ip
    z_gamma: float = 2.0           # vertical growth rate [1/s]
    act_limit: float = 1.0
    # Interlock thresholds (reference SafetyLimits semantics)
    beta_n_limit: float = 3.5
    ip_limit: float = 17.0
    dz_dt_limit: float = 1.5
    halt_penalty: float = -5.0
    noise: float = 0.02


class EnvState(NamedTuple):
    ip: jnp.ndarray
    beta_n: jnp.ndarray
    q95: jnp.ndarray
    z: jnp.ndarray
    z_prev: jnp.ndarray
    key: jnp.ndarray


def _obs(s: EnvState, p: TokamakEnvParams) -> jnp.ndarray:
    dr_err = (s.ip - p.ip_target) / p.ip_target
    dz_err = s.z
    return jnp.stack([s.ip, s.beta_n, s.q95, s.z, dr_err, dz_err])


def env_reset(p: TokamakEnvParams, key) -> tuple[EnvState, jnp.ndarray]:
    k1, k2 = jax.random.split(key)
    ip = 10.0 + jax.random.uniform(k1, ()) * 4.0
    z = 0.02 * jax.random.normal(k2, ())
    s = EnvState(ip, jnp.asarray(1.5), p.q95_coeff / ip, z, z, key)
    return s, _obs(s, p)


def env_step(p: TokamakEnvParams, s: EnvState, action) -> tuple:
    """Pure plant step -> (state', obs', reward, terminated)."""
    a = jnp.clip(action, -p.act_limit, p.act_limit)
    key, kn = jax.random.split(s.key)
    noise = p.noise * jax.random.normal(kn, (3,))

    ip = jnp.clip(s.ip + p.dt * (3.0 * a[0] - 0.1 * (s.ip - 12.0))
                  + noise[0] * 0.1, 0.1, 25.0)
    beta = jnp.clip(s.beta_n + p.dt * (2.0 * a[1] - 0.5 * (s.beta_n - 1.0))
                    + noise[1] * 0.05, 0.0, 6.0)
    # Vertical: unstable mode gamma with coil authority.
    z = s.z + p.dt * (p.z_gamma * s.z + 1.5 * a[2]) + noise[2] * 1e-3
    q95 = p.q95_coeff / jnp.maximum(ip, 0.1)

    s2 = EnvState(ip, beta, q95, z, s.z, key)
    reward = (- (ip - p.ip_target) ** 2 / 4.0
              - (beta - p.beta_target) ** 2
              - 20.0 * z**2
              - 0.05 * jnp.sum(a**2))
    terminated = (jnp.abs(z) > 0.5) | (q95 < 1.5)
    return s2, _obs(s2, p), reward, terminated


# ---------------------------------------------------------------------------
# Interlock shield + Lyapunov guard
# ---------------------------------------------------------------------------

# Action channel rules: (action index, gating channel, clamp mode).
# heating gates a[1] (freeze), current gates a[0] (non-positive: may only
# ramp down when the current interlock trips), vertical gates a[2] (freeze).
def interlock_allowed(p: TokamakEnvParams, obs, prev_obs):
    """Branch-free channel gates from the safety state
    (reference ``default_obs_to_safety_state`` + interlock thresholds)."""
    dz_dt = (obs[3] - prev_obs[3]) / p.dt
    return {
        "heating": obs[1] < p.beta_n_limit,
        "current": jnp.abs(obs[0]) < p.ip_limit,
        "vertical": jnp.abs(dz_dt) < p.dz_dt_limit,
    }


def shield_action(action, allowed):
    """Clamp gated components; returns (shielded, n_trips)."""
    a = action
    trips = 0
    heat_ok = allowed["heating"]
    cur_ok = allowed["current"]
    vert_ok = allowed["vertical"]
    a = a.at[1].set(jnp.where(heat_ok, a[1], 0.0))                  # freeze
    a = a.at[0].set(jnp.where(cur_ok, a[0], jnp.minimum(a[0], 0.0)))  # <=0
    a = a.at[2].set(jnp.where(vert_ok, a[2], 0.0))                  # freeze
    n_trips = ((~heat_ok) & (action[1] != 0.0)).astype(jnp.int32) \
        + ((~cur_ok) & (action[0] > 0.0)).astype(jnp.int32) \
        + ((~vert_ok) & (action[2] != 0.0)).astype(jnp.int32)
    return a, n_trips


def position_lyapunov_v(obs):
    """V = 2 (1 - exp(-(dR^2 + dZ^2)/2)) in [0, 2)."""
    energy = obs[4] ** 2 + obs[5] ** 2
    return 2.0 * (1.0 - jnp.exp(-0.5 * energy))


class ShieldState(NamedTuple):
    v_buffer: jnp.ndarray       # (window,)
    n_seen: jnp.ndarray
    consecutive: jnp.ndarray
    clamp_events: jnp.ndarray
    halted: jnp.ndarray


def init_shield(window: int = 50) -> ShieldState:
    return ShieldState(jnp.zeros(window), jnp.int32(0), jnp.int32(0),
                       jnp.int32(0), jnp.bool_(False))


def guard_update(sh: ShieldState, v, *, lambda_threshold: float = 0.0,
                 max_violations: int = 3, dt: float = 0.05):
    """Sliding-window Lyapunov check (reference ``LyapunovGuard.check``)."""
    window = sh.v_buffer.shape[0]
    buf = jnp.roll(sh.v_buffer, -1).at[-1].set(v)
    n_seen = sh.n_seen + 1
    n_valid = jnp.minimum(n_seen, window)
    oldest = buf[window - n_valid]
    lam = jnp.where(n_valid < 2, 0.0,
                    jnp.log(jnp.maximum(v, 1e-15)
                            / jnp.maximum(oldest, 1e-15))
                    / (n_valid.astype(buf.dtype) * dt))
    violated = (n_valid >= 2) & (lam > lambda_threshold)
    consecutive = jnp.where(violated, sh.consecutive + 1, 0)
    approved = consecutive < max_violations
    return approved, ShieldState(buf, n_seen, consecutive, sh.clamp_events,
                                 sh.halted)


def shielded_env_step(p: TokamakEnvParams, s: EnvState, sh: ShieldState,
                      prev_obs, action):
    """Shield -> plant -> guard halt (reference ``ShieldedTokamakEnv.step``)."""
    obs_now = _obs(s, p)
    allowed = interlock_allowed(p, obs_now, prev_obs)
    a_shielded, n_trips = shield_action(action, allowed)
    s2, obs2, reward, terminated = env_step(p, s, a_shielded)

    v = position_lyapunov_v(obs2)
    approved, sh = guard_update(sh, v, dt=p.dt)
    halt = ~approved
    reward = jnp.where(halt & ~terminated, reward + p.halt_penalty, reward)
    terminated = terminated | halt
    sh = ShieldState(sh.v_buffer, sh.n_seen, sh.consecutive,
                     sh.clamp_events + n_trips, sh.halted | halt)
    return s2, obs2, reward, terminated, sh, a_shielded


# ---------------------------------------------------------------------------
# Constraint costs (reference q95/beta_N/Ip cost fns, our obs layout)
# ---------------------------------------------------------------------------

N_CONSTRAINTS = 3
CONSTRAINT_NAMES = ("q95_lower_bound", "beta_n_upper_bound", "ip_positive")
CONSTRAINT_LIMITS = jnp.asarray([0.0, 0.0, 0.0])


def constraint_costs(obs, act, next_obs):
    """[max(0, 2 - q95), max(0, beta_N - 3.5), max(0, -I_p)]."""
    return jnp.stack([
        jnp.maximum(0.0, 2.0 - next_obs[2]),
        jnp.maximum(0.0, next_obs[1] - 3.5),
        jnp.maximum(0.0, -next_obs[0]),
    ])


# ---------------------------------------------------------------------------
# Linear-Gaussian policy + Lagrangian PPO
# ---------------------------------------------------------------------------

class PolicyParams(NamedTuple):
    w: jnp.ndarray          # (obs, act)
    b: jnp.ndarray          # (act,)
    log_std: jnp.ndarray    # (act,)


def init_policy(key, obs_dim: int = OBS_DIM, act_dim: int = ACT_DIM,
                log_std: float = -0.5) -> PolicyParams:
    w = 0.01 * jax.random.normal(key, (obs_dim, act_dim))
    return PolicyParams(w, jnp.zeros(act_dim), jnp.full(act_dim, log_std))


def policy_mean(params: PolicyParams, obs):
    return obs @ params.w + params.b


def policy_sample(params: PolicyParams, obs, key):
    mu = policy_mean(params, obs)
    return mu + jnp.exp(params.log_std) * jax.random.normal(key, mu.shape)


def policy_log_prob(params: PolicyParams, obs, action):
    mu = policy_mean(params, obs)
    std = jnp.exp(params.log_std)
    z = (action - mu) / std
    return jnp.sum(-0.5 * z**2 - params.log_std
                   - 0.5 * jnp.log(2.0 * jnp.pi), axis=-1)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.99
    lambda_lr: float = 0.01
    policy_lr: float = 0.05
    clip_epsilon: float = 0.2
    n_epochs: int = 4
    batch_episodes: int = 16
    max_episode_steps: int = 100


class Rollout(NamedTuple):
    obs: jnp.ndarray          # (E, T, obs)
    actions: jnp.ndarray      # (E, T, act)
    log_probs: jnp.ndarray    # (E, T)
    rewards: jnp.ndarray      # (E, T) augmented
    costs: jnp.ndarray        # (E, T, C)
    mask: jnp.ndarray         # (E, T) 1 while alive
    clamp_events: jnp.ndarray  # (E,)
    halted: jnp.ndarray        # (E,)


def _collect_episode(p: TokamakEnvParams, cfg: PPOConfig,
                     params: PolicyParams, lambdas, key):
    s0, obs0 = env_reset(p, key)

    def step(carry, k):
        s, sh, prev_obs, obs, alive = carry
        a = policy_sample(params, obs, k)
        logp = policy_log_prob(params, obs, a)
        s2, obs2, r, term, sh, a_sh = shielded_env_step(p, s, sh, prev_obs, a)
        cost = constraint_costs(obs, a_sh, obs2)
        r_aug = r - jnp.sum(lambdas * cost)
        out = (obs, a, logp, r_aug * alive, cost * alive, alive)
        alive = alive * (1.0 - term.astype(obs.dtype))
        return (s2, sh, obs, obs2, alive), out

    keys = jax.random.split(jax.random.fold_in(key, 1),
                            cfg.max_episode_steps)
    init = (s0, init_shield(), obs0, obs0, jnp.asarray(1.0, obs0.dtype))
    (s_f, sh_f, _, _, _), (obs, acts, logps, rews, costs, mask) = \
        jax.lax.scan(step, init, keys)
    return obs, acts, logps, rews, costs, mask, sh_f.clamp_events, sh_f.halted


@partial(jax.jit, static_argnames=("p", "cfg"))
def collect_batch(p: TokamakEnvParams, cfg: PPOConfig, params: PolicyParams,
                  lambdas, key) -> Rollout:
    keys = jax.random.split(key, cfg.batch_episodes)
    outs = jax.vmap(lambda k: _collect_episode(p, cfg, params, lambdas, k))(
        keys)
    return Rollout(*outs)


def _returns_to_go(rewards, mask, gamma):
    """Discounted suffix sums along T (reverse scan)."""
    def rev(carry, x):
        r, m = x
        carry = r + gamma * carry * m
        return carry, carry

    _, rtg = jax.lax.scan(rev, jnp.zeros(rewards.shape[0]),
                          (rewards.T, mask.T), reverse=True)
    return rtg.T


@partial(jax.jit, static_argnames=("cfg",))
def ppo_update(cfg: PPOConfig, params: PolicyParams, roll: Rollout):
    """Primal: clipped-surrogate ascent with MC advantages, n_epochs."""
    rtg = _returns_to_go(roll.rewards, roll.mask, cfg.gamma)
    total = jnp.maximum(jnp.sum(roll.mask), 1.0)
    mean = jnp.sum(rtg * roll.mask) / total
    var = jnp.sum(((rtg - mean) * roll.mask) ** 2) / total
    adv = (rtg - mean) / jnp.sqrt(var + 1e-8)

    def loss_fn(prm):
        logp = policy_log_prob(prm, roll.obs, roll.actions)
        ratio = jnp.exp(jnp.clip(logp - roll.log_probs, -20.0, 20.0))
        clipped = jnp.clip(ratio, 1.0 - cfg.clip_epsilon,
                           1.0 + cfg.clip_epsilon)
        surr = jnp.minimum(ratio * adv, clipped * adv) * roll.mask
        return -jnp.sum(surr) / total

    def epoch(prm, _):
        loss, g = jax.value_and_grad(loss_fn)(prm)
        prm = PolicyParams(prm.w - cfg.policy_lr * g.w,
                           prm.b - cfg.policy_lr * g.b,
                           prm.log_std)    # fixed exploration like reference
        return prm, loss

    params, losses = jax.lax.scan(epoch, params, None, length=cfg.n_epochs)
    return params, losses


@partial(jax.jit, static_argnames=("cfg",))
def update_lambdas(cfg: PPOConfig, lambdas, roll: Rollout):
    """Dual ascent on mean per-episode constraint costs."""
    ep_costs = jnp.mean(jnp.sum(roll.costs, axis=1), axis=0)   # (C,)
    return jnp.maximum(0.0, lambdas + cfg.lambda_lr
                       * (ep_costs - CONSTRAINT_LIMITS))


def train(p: TokamakEnvParams, cfg: PPOConfig, *, n_iterations: int = 30,
          seed: int = 0):
    """Full primal-dual loop (reference ``LagrangianPPO.train``)."""
    key = jax.random.PRNGKey(seed)
    params = init_policy(jax.random.fold_in(key, 0))
    lambdas = jnp.zeros(N_CONSTRAINTS)
    history = []
    for it in range(n_iterations):
        roll = collect_batch(p, cfg, params, lambdas,
                             jax.random.fold_in(key, it + 1))
        params, losses = ppo_update(cfg, params, roll)
        lambdas = update_lambdas(cfg, lambdas, roll)
        ep_ret = float(jnp.mean(jnp.sum(roll.rewards * roll.mask, axis=1)))
        history.append({
            "iteration": it,
            "mean_return": ep_ret,
            "mean_cost": [float(c) for c in
                          jnp.mean(jnp.sum(roll.costs, axis=1), axis=0)],
            "lambdas": [float(v) for v in lambdas],
            "clamp_events": int(jnp.sum(roll.clamp_events)),
            "halt_rate": float(jnp.mean(roll.halted.astype(jnp.float32))),
        })
    return params, lambdas, history


def predict(params: PolicyParams, obs):
    """Deterministic (mean) action."""
    return policy_mean(params, jnp.asarray(obs))
