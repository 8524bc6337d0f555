"""DREAM-style fluid runaway-electron rates + balance (JAX-native).

Reduced-order runaway density contract ``dn_RE/dt = S_Dreicer +
Gamma_ava n_RE - n_RE/tau_loss`` with the corrected Connor-Hastie Dreicer
generation rate and the compact Rosenbluth-Putvinski avalanche rate, both
with state-dependent Coulomb logarithms.

Physics sources (published formulae, implemented from the papers):
  - Dreicer rate: Connor & Hastie, Nucl. Fusion 15, 415 (1975), in the
    corrected form used by DREAM (Hoppe et al., Comput. Phys. Commun. 268,
    108098 (2021), doi:10.1016/j.cpc.2021.108098).
  - Avalanche: Rosenbluth & Putvinski, Nucl. Fusion 37, 1355 (1997), compact
    form as quoted by Hesslow et al., Nucl. Fusion 59, 084004 (2019):
    ``Gamma_ava = e (E - E_c) / (m_e c lnLambda_c sqrt(5 + Z_eff))``.
  - Coulomb logarithms: thermal ``14.9 - 0.5 ln ne20 + ln Te_keV``,
    relativistic ``14.6 + 0.5 ln(Te_eV / ne20)`` (Hesslow et al. 2019).

Reference-parity anchor: `/root/reference/` ships a really-executed DREAM
fluid trajectory (`validation/reference_data/dream/
dream_fluid_runaway_reference.json`, DREAM commit a08edc0d) and gates its
own rates at Dreicer ratio 0.85-1.15 and avalanche ratio 0.60-1.00
(`validation/benchmark_dream_fluid_parity.py:127-128`; the avalanche band
sits below unity because the compact RP form omits Hesslow's effective
critical momentum).  `validation/run_runaway_dream.py` applies the same
bands to this module.

Reference counterparts: `src/scpn_fusion/core/runaway_electrons.py:104-300`
(NumPy scalars, early-return guards).  This module is array-native JAX:
every rate accepts batched inputs, guards are `jnp.where` masks so the
whole fluid run jits to one `lax.scan` with an exact exponential-integrator
step (the balance is linear in n_RE under prescribed E/n/T).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

E_CHARGE = 1.602176634e-19      # C
M_E = 9.1093837015e-31          # kg
C_LIGHT = 2.99792458e8          # m/s
EPS_0 = 8.8541878128e-12        # F/m
# Classical electron radius r0 = e^2/(4 pi eps0 m_e c^2) [m]
R0_CLASSICAL = 2.8179403262e-15
# E_c = ne20 * lnL * _EC_PER_NE20_LNL  [V/m]; constant pre-folded in f64
# (e^3/(4 pi eps0^2 m_e c^2) * 1e20) so the f32 device path never forms
# the underflowing e^3 product.
_EC_PER_NE20_LNL = 5.0990991e-3
# E_D = ne20 * lnL * _ED_PER_NE20_LNL / Te_keV  [V/m]:
# e^3/(4 pi eps0^2) * 1e20 / (1e3 e)  == _EC_PER_NE20_LNL * (m_e c^2 / keV)
_MEC2_KEV = 510.99895
_ED_PER_NE20_LNL = _EC_PER_NE20_LNL * _MEC2_KEV


def coulomb_log_thermal(ne20, te_kev):
    """Thermal e-e Coulomb log: 14.9 - 0.5 ln(ne20) + ln(Te_keV)."""
    ne20 = jnp.maximum(ne20, 1e-12)
    te = jnp.maximum(te_kev, 1e-12)
    return 14.9 - 0.5 * jnp.log(ne20) + jnp.log(te)


def coulomb_log_relativistic(ne20, te_kev):
    """Relativistic Coulomb log: 14.6 + 0.5 ln(Te_eV / ne20)."""
    ne20 = jnp.maximum(ne20, 1e-12)
    te_ev = jnp.maximum(te_kev, 1e-12) * 1e3
    return 14.6 + 0.5 * jnp.log(te_ev / ne20)


def critical_field(ne20, ln_lambda):
    """E_c = n_e e^3 lnL / (4 pi eps0^2 m_e c^2)  [V/m]."""
    return jnp.maximum(ne20, 0.0) * ln_lambda * _EC_PER_NE20_LNL


def dreicer_field(ne20, te_kev, ln_lambda):
    """E_D = n_e e^3 lnL / (4 pi eps0^2 T_e)  [V/m]."""
    return (jnp.maximum(ne20, 0.0) * ln_lambda * _ED_PER_NE20_LNL
            / jnp.maximum(te_kev, 1e-12))


def dreicer_rate(ne20, te_kev, e_par, z_eff):
    """Corrected Connor-Hastie primary generation rate [m^-3 s^-1].

    gamma_D = (n_e/tau_EE) (E/E_D)^alpha exp(-lambda/(4 E_ED)
              - sqrt(eta (1+Z)/E_ED)),  alpha = -3(1+Z)h/16,
    with h/eta/lambda relativistic correction factors of E/E_c and
    tau_EE = beta_th^3 / (4 pi r0^2 c n_e lnL_T).  Zero below the
    relativistic critical field (masked, not branched).
    """
    lnl_t = coulomb_log_thermal(ne20, te_kev)
    lnl_c = coulomb_log_relativistic(ne20, te_kev)
    e_c = critical_field(ne20, lnl_c)
    e_d = dreicer_field(ne20, te_kev, lnl_t)

    valid = (e_par > e_c) & (te_kev > 0.0) & (ne20 > 0.0)
    # Clamp into the formula's domain (E/E_c > 1) on the masked-out side so
    # sqrt/arcsin stay finite; the result there is discarded by `valid`.
    e_ec = jnp.maximum(e_par / jnp.maximum(e_c, 1e-30), 1.0 + 1e-6)
    e_ed = jnp.maximum(e_par / jnp.maximum(e_d, 1e-30), 1e-8)

    z = z_eff
    h = (e_ec + 2.0 * (e_ec - 2.0) * jnp.sqrt(e_ec / (e_ec - 1.0))
         - (z - 7.0) / (z + 1.0)) / (3.0 * (e_ec - 1.0))
    eta_f = 0.5 * jnp.pi - jnp.arcsin(jnp.clip(1.0 - 2.0 / e_ec, -1.0, 1.0))
    eta = e_ec**2 / (4.0 * (e_ec - 1.0)) * eta_f**2
    lam = 8.0 * e_ec**2 * (1.0 - 0.5 / e_ec
                           - jnp.sqrt(jnp.maximum(1.0 - 1.0 / e_ec, 0.0)))
    alpha = -3.0 / 16.0 * (1.0 + z) * h

    n_e = jnp.maximum(ne20, 1e-12) * 1e20
    beta_th = jnp.sqrt(2.0 * jnp.maximum(te_kev, 1e-12) / _MEC2_KEV)
    tau_ee = beta_th**3 / (4.0 * jnp.pi * R0_CLASSICAL**2 * C_LIGHT
                           * n_e * lnl_t)

    exponent = -lam / (4.0 * e_ed) - jnp.sqrt(eta * (1.0 + z) / e_ed)
    rate = n_e / tau_ee * e_ed**alpha * jnp.exp(jnp.maximum(exponent, -200.0))
    rate = jnp.where(jnp.isfinite(rate), rate, 0.0)
    return jnp.where(valid & (exponent > -200.0), jnp.maximum(rate, 0.0), 0.0)


def avalanche_rate(ne20, te_kev, e_par, z_eff):
    """Rosenbluth-Putvinski exponential avalanche rate Gamma_ava [1/s].

    Gamma = e (E - E_c) / (m_e c lnL_c sqrt(5 + Z_eff)); zero below E_c.
    """
    lnl_c = coulomb_log_relativistic(ne20, te_kev)
    e_c = critical_field(ne20, lnl_c)
    gamma = (E_CHARGE * (e_par - e_c)
             / (M_E * C_LIGHT * lnl_c * jnp.sqrt(5.0 + z_eff)))
    return jnp.maximum(gamma, 0.0)


def hot_tail_seed(te_pre_kev, te_post_kev, ne20, quench_time_ms,
                  *, vc_vte_ref: float = 4.0, quench_exponent: float = 0.2):
    """Thermal-quench hot-tail seed density [m^-3] (Smith et al., Phys.
    Plasmas 15, 072502 (2008); parametric v_c/v_te fit to Fig. 3)."""
    v_c_v_te = vc_vte_ref * jnp.maximum(quench_time_ms, 1e-6) ** quench_exponent
    ratio = jnp.maximum(te_pre_kev, 1e-12) / jnp.maximum(te_post_kev, 1e-12)
    n_e = jnp.maximum(ne20, 0.0) * 1e20
    seed = (n_e * v_c_v_te**3
            * jnp.exp(jnp.maximum(-v_c_v_te**2, -200.0)) * ratio**1.5)
    return jnp.where(te_post_kev < te_pre_kev, jnp.maximum(seed, 0.0), 0.0)


class FluidBalance(NamedTuple):
    dreicer_source: jnp.ndarray     # [m^-3 s^-1]
    avalanche_source: jnp.ndarray   # [m^-3 s^-1]
    loss_source: jnp.ndarray        # [m^-3 s^-1] (positive = loss)
    total_source: jnp.ndarray       # [m^-3 s^-1]
    runaway_fraction: jnp.ndarray
    growth_time_s: jnp.ndarray      # 1/Gamma_net (inf when non-growing)


def fluid_density_balance(ne20, te_kev, e_par, z_eff, n_re,
                          *, loss_time_s=jnp.inf) -> FluidBalance:
    """Evaluate the scalar DREAM-style density balance at one state."""
    s_d = dreicer_rate(ne20, te_kev, e_par, z_eff)
    gamma = avalanche_rate(ne20, te_kev, e_par, z_eff)
    s_a = gamma * n_re
    s_l = n_re / loss_time_s
    total = s_d + s_a - s_l
    net = gamma - 1.0 / loss_time_s
    growth = jnp.where(net > 0.0, 1.0 / jnp.maximum(net, 1e-30), jnp.inf)
    frac = n_re / jnp.maximum(ne20 * 1e20, 1e-30)
    return FluidBalance(s_d, s_a, s_l, total, frac, growth)


class FluidRunawayTrace(NamedTuple):
    time_s: jnp.ndarray
    n_re: jnp.ndarray               # [m^-3]
    dreicer_source: jnp.ndarray
    avalanche_source: jnp.ndarray


def run_fluid_runaway(ne20, te_kev, e_par, z_eff, *,
                      n_re_seed: float, t_max_s: float, n_steps: int,
                      loss_time_s: float = float("inf"),
                      max_runaway_fraction: float = 1.0) -> FluidRunawayTrace:
    """Integrate the fluid balance under prescribed (constant) E/n/T.

    The balance is linear with constant coefficients, so each step uses the
    exact exponential integrator
        n(t+dt) = n e^{g dt} + S_D (e^{g dt} - 1)/g,   g = Gamma - 1/tau,
    (series-expanded near g=0), making the trajectory dt-exact — parity
    with DREAM then measures the *rates*, not integrator error.  The run
    is one `lax.scan`; the density cap is enforced as a clamp (fail-closed
    callers gate on `n_re` reaching the cap).
    """
    dt = t_max_s / n_steps
    s_d = dreicer_rate(ne20, te_kev, e_par, z_eff)
    gamma = avalanche_rate(ne20, te_kev, e_par, z_eff)
    g = gamma - 1.0 / loss_time_s
    cap = max_runaway_fraction * ne20 * 1e20

    small = jnp.abs(g * dt) < 1e-8
    e_gdt = jnp.exp(jnp.clip(g * dt, -200.0, 200.0))
    # (e^{g dt} - 1)/g, stable at g -> 0
    phi = jnp.where(small, dt * (1.0 + 0.5 * g * dt),
                    (e_gdt - 1.0) / jnp.where(small, 1.0, g))

    def step(n, _):
        n_next = jnp.minimum(n * e_gdt + s_d * phi, cap)
        return n_next, (n_next, s_d, gamma * n_next)

    n0 = jnp.asarray(n_re_seed, dtype=jnp.result_type(float))
    _, (n_traj, sd_traj, sa_traj) = jax.lax.scan(
        step, n0, None, length=n_steps)
    t = (jnp.arange(1, n_steps + 1)) * dt
    return FluidRunawayTrace(
        time_s=jnp.concatenate([jnp.zeros((1,)), t]),
        n_re=jnp.concatenate([n0[None], n_traj]),
        dreicer_source=jnp.concatenate([s_d[None], sd_traj]),
        avalanche_source=jnp.concatenate([(gamma * n0)[None], sa_traj]),
    )
