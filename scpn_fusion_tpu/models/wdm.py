"""Whole-device-model driver: transport <-> wall <-> impurity radiation.

Covers the reference's ``core/wdm_engine.py`` (``WholeDeviceModel``):
a discharge timeline that couples core transport to plasma-wall
interaction — edge sound-speed flux drives tungsten sputtering, prompt
redeposition scales with edge density and field, the net impurity flux
feeds back into the core impurity channel, and accumulated high-Z
radiation can quench the core temperature ("radiative collapse").

JAX-native design: the reference's host ``for`` loop over 10 ms steps
with per-step Python dict history (``wdm_engine.py:83-151``) becomes ONE
``lax.scan`` over the jitted transport step
(``models/transport/solver.py`` ``evolve_profiles``), with the wall
model inlined into the scan body.  Collapse does not ``break`` — the
carry holds a ``collapsed`` latch that freezes further evolution, so
shapes stay static and the whole discharge compiles once.  Plotting is
out of scope here (the dashboard generator renders traces).

Deliberate physics correction (documented deviation): the reference's
edge sound speed ``np.sqrt((T+T)/(2*1.67e-27))`` omits the eV->J
conversion (``wdm_engine.py:106``); this implementation uses the
dimensionally correct ``c_s = sqrt(e (T_e + T_i) / m_i)``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.models.nuclear.pwi import (
    SputteringMaterial,
    sputtering_yield,
)
from scpn_fusion_tpu.models.transport.solver import (
    TransportParams,
    TransportState,
    evolve_profiles,
    initial_state,
)

E_CHARGE = 1.602176634e-19
HBAR = 1.054571817e-34
M_ELECTRON = 9.1093837015e-31
M_PROTON = 1.67262192369e-27


@dataclasses.dataclass(frozen=True)
class WDMConfig:
    """Static whole-device discharge configuration (hashable)."""

    transport: TransportParams = TransportParams()
    dt_s: float = 0.01
    p_aux_mw: float = 50.0
    b_edge_t: float = 5.0
    wall_area_m2: float = 700.0
    ion_mass_amu: float = 2.0
    # Fraction of the net (post-redeposition) impurity flux that penetrates
    # into the confined-plasma impurity channel (screening in the SOL).
    core_penetration: float = 1.0e-2
    collapse_te_kev: float = 0.5
    material_name: str = "Tungsten"
    sputter_angle_deg: float = 45.0


class WDMTrace(NamedTuple):
    """Per-step discharge history (stacked scan outputs)."""

    time_s: jnp.ndarray
    te_core_kev: jnp.ndarray
    w_impurity_total: jnp.ndarray    # volume-integrated channel [1e19 units]
    gross_erosion_flux: jnp.ndarray  # [atoms / m^2 s]
    net_impurity_flux: jnp.ndarray   # after prompt redeposition
    redeposition_fraction: jnp.ndarray
    collapsed: jnp.ndarray           # latched bool per step
    final_state: TransportState


def thomas_fermi_pressure(n_e_m3, t_ev) -> jnp.ndarray:
    """Hardened Thomas-Fermi EOS: ideal + electron degeneracy pressure
    ``P = n k_B T + (hbar^2/m_e) n^(5/3)`` (reference
    ``thomas_fermi_pressure:50-64``).  Broadcasts and jits."""
    n_e = jnp.asarray(n_e_m3)
    p_ideal = n_e * jnp.asarray(t_ev) * E_CHARGE
    p_deg = (HBAR**2 / M_ELECTRON) * n_e ** (5.0 / 3.0)
    return p_ideal + p_deg


def redeposition_fraction(b_field_t, n_e_edge_m3) -> jnp.ndarray:
    """Prompt-redeposition fraction of sputtered high-Z atoms,
    ``f = clip(0.95 (1 - exp(-(B/5)(n_edge/1e19))), 0, 0.99)``
    (reference ``calculate_redeposition_fraction:66-81``)."""
    f = 0.95 * (1.0 - jnp.exp(-(jnp.asarray(b_field_t) / 5.0)
                              * (jnp.asarray(n_e_edge_m3) / 1e19)))
    return jnp.clip(f, 0.0, 0.99)


def _volume_m3(tp: TransportParams) -> float:
    return float(2.0 * jnp.pi**2 * tp.r0 * tp.a_minor**2 * tp.kappa)


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run_discharge(
    cfg: WDMConfig,
    state0: TransportState,
    n_steps: int = 200,
) -> WDMTrace:
    """Run the whole-device discharge timeline as one compiled scan
    (reference ``run_discharge:83-151``)."""
    tp = cfg.transport
    mat = SputteringMaterial.from_name(cfg.material_name)
    dt = jnp.asarray(cfg.dt_s, state0.ti.dtype)
    p_aux = jnp.asarray(cfg.p_aux_mw, state0.ti.dtype)
    rho = tp.rho(state0.ti.dtype)
    # Edge-localised deposition profile for the penetrating impurity flux.
    src_shape = jnp.exp(-((rho - 1.0) / 0.08) ** 2)
    src_shape = src_shape / jnp.maximum(jnp.sum(src_shape), 1e-30)
    volume = _volume_m3(tp)
    m_i = cfg.ion_mass_amu * M_PROTON

    def step(carry, _):
        s, t, collapsed = carry
        s_new = evolve_profiles(s, dt, p_aux, tp)

        t_edge_ev = jnp.maximum(s_new.te[-1], tp.t_edge_kev) * 1e3
        n_edge = jnp.maximum(s_new.ne[-1], 0.01) * 1e19
        c_s = jnp.sqrt(E_CHARGE * 2.0 * t_edge_ev / m_i)
        flux_wall = n_edge * c_s

        y = sputtering_yield(mat, 5.0 * t_edge_ev, cfg.sputter_angle_deg)
        gross = flux_wall * y
        f_redep = redeposition_fraction(cfg.b_edge_t, n_edge)
        net = gross * (1.0 - f_redep)

        # atoms/s into the core channel -> density source in 1e19 m^-3.
        atoms_s = net * cfg.wall_area_m2 * cfg.core_penetration
        dn_imp = atoms_s * dt / volume / 1e19
        s_new = s_new._replace(n_imp=s_new.n_imp + dn_imp * src_shape
                               * rho.shape[0])

        te_core = s_new.te[0]
        now_collapsed = collapsed | (te_core < cfg.collapse_te_kev)
        # Latch: once collapsed, freeze the plasma state.
        s_out = jax.tree_util.tree_map(
            lambda frozen, new: jnp.where(collapsed, frozen, new), s, s_new)
        outputs = (t + dt, s_out.te[0],
                   jnp.sum(s_out.n_imp), gross, net, f_redep, now_collapsed)
        return (s_out, t + dt, now_collapsed), outputs

    init = (state0, jnp.asarray(0.0, state0.ti.dtype),
            jnp.asarray(False))
    (s_final, _, _), outs = jax.lax.scan(step, init, None, length=n_steps)
    time_s, te_core, w_tot, gross, net, f_redep, collapsed = outs
    return WDMTrace(
        time_s=time_s, te_core_kev=te_core, w_impurity_total=w_tot,
        gross_erosion_flux=gross, net_impurity_flux=net,
        redeposition_fraction=f_redep, collapsed=collapsed,
        final_state=s_final)


def default_initial_state(cfg: WDMConfig) -> TransportState:
    return initial_state(cfg.transport)


def collapse_time_s(trace: WDMTrace) -> float | None:
    """Host-side: first collapsed sample time, or None."""
    collapsed = jax.device_get(trace.collapsed)
    if not collapsed.any():
        return None
    import numpy as np
    return float(jax.device_get(trace.time_s)[int(np.argmax(collapsed))])
