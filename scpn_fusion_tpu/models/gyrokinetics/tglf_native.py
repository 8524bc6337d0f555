"""Native TGLF-class quasilinear transport model (GK path A, no binary).

JAX-native counterpart of the reference's ``core/gk_tglf_native.py:50-440``
(SAT0/SAT1/SAT2 spectral saturation, E×B shear quench, trapped-particle
damping, multi-scale ITG–ETG coupling, FLR-weighted quasilinear fluxes;
physics per Staebler 2007/2017, Waltz 1997, Maeyama 2015, Connor 1974).

Architectural differences, by design:

* the linear spectrum comes from the resonant local kinetic dispersion
  relation (``local_dispersion.py``) — a jittable complex root-find —
  rather than a host-side dense eigensolve per k_y;
* saturation + quasilinear weights are PURE vectorised ``jnp`` over the
  whole spectrum (masked reductions), not a Python loop over modes;
* :func:`tglf_native_fluxes_profile` evaluates EVERY flux surface of a
  radial profile in one compiled program (``vmap`` over surfaces) — the
  reference calls its solver once per surface from Python.

The deck-file contract (:class:`TGLFNativeSolver`) matches the registry
interface so the native model is a drop-in for the external binary.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from functools import partial
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.models.gyrokinetics.interface import (
    GKLocalParams,
    GKOutput,
    GKSolverBase,
)
from scpn_fusion_tpu.models.gyrokinetics.local_dispersion import (
    solve_local_kinetic_dispersion,
)
from scpn_fusion_tpu.models.gyrokinetics.species import (
    E_CHARGE,
    M_PROTON,
    VelocityGrid,
)

# Staebler et al. 2007, Table I
ALPHA_EXB_DEFAULT = 0.67
# Staebler et al. 2017 Eq. (12) / Maeyama et al. 2015 Fig. 3
ALPHA_CS_DEFAULT = 3.0
# Ion/electron scale boundary in k_y rho_s
KY_ETG_BOUNDARY = 2.0
# sqrt(m_D / m_e): maps electron-scale normalisation to ion-scale units
SQRT_MI_ME = float(np.sqrt(2.0 * M_PROTON / 9.1093837015e-31))


@dataclasses.dataclass(frozen=True)
class TGLFNativeConfig:
    """SAT-model selection + spectrum resolution (hashable: jit-static)."""

    sat_model: str = "SAT1"
    multiscale: bool = False
    n_ky_ion: int = 12
    n_ky_etg: int = 0
    ky_ion_min: float = 0.08
    ky_ion_max: float = 1.0   # TGLF ion-scale standard range k_y rho_s <= 1
    # Velocity resolution: 24x16 is the local-dispersion module's default;
    # coarser grids expose unconverged spurious roots at strong drive.
    n_energy: int = 24
    n_lambda: int = 16
    alpha_exb: float = ALPHA_EXB_DEFAULT
    alpha_cs: float = ALPHA_CS_DEFAULT
    # Opt-in kinetic trapped-electron response in the ion-scale dispersion:
    # gives a genuine TEM branch (positive-omega_r roots driven by R/L_ne
    # and R/L_Te), but the reduced deeply-trapped transit-free model
    # over-drives growth by ~12x vs the TGLF TEM fixture rate at fixture
    # collisionality (measured + pinned by
    # validation/run_gk_growth_rates.py lane tem_overdrive_quantified) —
    # calibration limit disclosed; default stays adiabatic (ITG-accurate).
    kinetic_electrons: bool = False

    def __post_init__(self) -> None:
        if self.sat_model not in ("SAT0", "SAT1", "SAT2"):
            raise ValueError(f"unknown SAT model: {self.sat_model!r}")
        if self.sat_model == "SAT2":
            # SAT2 is the multi-scale rule: force the ETG branch on.
            object.__setattr__(self, "multiscale", True)
            if self.n_ky_etg == 0:
                object.__setattr__(self, "n_ky_etg", 6)


class TGLFNativeFluxes(NamedTuple):
    """Spectrum + fluxes; every leaf is a jnp array (vmap-stackable)."""

    chi_i: jnp.ndarray
    chi_e: jnp.ndarray
    d_e: jnp.ndarray
    v_e: jnp.ndarray
    chi_e_etg: jnp.ndarray
    k_y: jnp.ndarray
    gamma: jnp.ndarray
    gamma_net: jnp.ndarray
    omega_r: jnp.ndarray
    phi_sq: jnp.ndarray
    gamma_exb: jnp.ndarray


# ── Scalar physics factors (Waltz 1997 / Wesson / Connor 1974) ───────────


def exb_shear_rate(s_hat, q, epsilon, r_l_ti):
    """gamma_ExB proxy in c_s/a: |s_hat/q| * eps * R/L_Ti * 0.1."""
    return jnp.where(jnp.abs(q) > 1e-10,
                     jnp.abs(s_hat / jnp.where(jnp.abs(q) > 1e-10, q, 1.0))
                     * epsilon * r_l_ti * 0.1, 0.0)


def trapped_fraction(epsilon):
    """f_t = sqrt(2 eps / (1 + eps))."""
    eps = jnp.maximum(epsilon, 1e-6)
    return jnp.sqrt(2.0 * eps / (1.0 + eps))


def trapped_particle_damping(epsilon, nu_star):
    """Multiplicative growth-rate factor in [0.1, 1]."""
    return jnp.clip(1.0 - trapped_fraction(epsilon) * nu_star, 0.1, 1.0)


def gamma0_flr(b):
    """Gamma_0(b) = I_0(b) exp(-b) FLR reduction."""
    return jax.scipy.special.i0e(jnp.maximum(b, 0.0))


# ── Saturation rules (whole-spectrum, vectorised) ────────────────────────


def spectral_weight(gamma_net, k_y):
    """I_k = (gamma_net/k_y) / sum(gamma_net/k_y) (Staebler 2007 Eq. 7)."""
    raw = jnp.where(gamma_net > 0.0,
                    gamma_net / jnp.maximum(k_y, 1e-10), 0.0)
    total = jnp.sum(raw)
    return jnp.where(total > 1e-30, raw / jnp.maximum(total, 1e-30), 0.0)


def sat_phi_sq(gamma_net, omega_r, k_y, sat_model: str,
               alpha_cs: float, etg_unit_scale=1.0) -> jnp.ndarray:
    """phi^2_k under SAT0/SAT1/SAT2 from the quenched spectrum.

    ``etg_unit_scale`` = sqrt(m_i/m_e * T_e/T_i): the factor by which
    electron-scale growth rates exceed ion-scale ones in c_s/a units.
    The Maeyama cross-scale ratio compares gamma_ETG to gamma_ITG in
    SAME-scale (own gyro-unit) terms, so the ETG gammas are divided by
    this before the ratio — using raw c_s/a values would inflate the
    enhancement by ~sqrt(m_i/m_e).
    """
    etg = k_y > KY_ETG_BOUNDARY
    # Effective frequency max(|w_r|, gamma): a strongly-growing mode with
    # near-zero real frequency saturates on its own growth time — without
    # this the mixing length diverges on marginal-frequency roots.
    w_eff = jnp.maximum(jnp.maximum(jnp.abs(omega_r), gamma_net), 1e-6)
    mixing = jnp.where(gamma_net > 0.0, gamma_net / (k_y**2 * w_eff), 0.0)
    if sat_model == "SAT0":
        return mixing

    # SAT1: ion-scale peak-mode amplitude distributed by spectral weight
    # (Staebler 2007 is an ion-scale rule: ETG modes keep mixing length).
    g_ion = jnp.where(etg, 0.0, gamma_net)
    i_k = spectral_weight(g_ion, k_y)
    idx = jnp.argmax(g_ion)
    peak = g_ion[idx] / jnp.maximum(k_y[idx] ** 2, 1e-10)
    phi_ion = jnp.where(jnp.max(g_ion) > 0.0, i_k * peak, 0.0)
    phi = jnp.where(etg, mixing, phi_ion)
    if sat_model == "SAT1":
        return phi

    # SAT2: cross-scale enhancement of unstable ETG modes by
    # alpha_cs * gamma_ETG / gamma_ITG_max, same-unit ratio (Maeyama 2015).
    # The ratio is clamped: Maeyama reports O(2-3x) flux enhancement when
    # ion-scale turbulence is marginal — an unclamped ratio diverges on the
    # gamma_ITG floor when every ion-scale mode is stable.
    g_itg_max = jnp.maximum(jnp.max(g_ion), 1e-10)
    g_etg_own = gamma_net / jnp.maximum(etg_unit_scale, 1e-10)
    ratio = jnp.minimum(g_etg_own / g_itg_max, 2.0)
    enhance = 1.0 + alpha_cs * ratio
    return jnp.where(etg & (gamma_net > 0.0), phi * enhance, phi)


# ── Quasilinear weights → physical fluxes ────────────────────────────────


def quasilinear_fluxes(
    k_y, gamma_net, omega_r, phi_sq,
    *, r_l_ti, r_l_te, r_l_ne, te_ti, a, b0, t_i_kev,
    ion_mass_amu: float = 2.0, etg_unit_scale=1.0,
):
    """Masked-reduction QL weights (reference ``quasilinear_weights``
    :218-280 semantics, no mode loop).  Returns gyro-Bohm-scaled
    (chi_i, chi_e, D_e, V_e, chi_e_etg) in m^2/s.

    ETG unit algebra (departure from the reference's flat 1/60^2 factor,
    disclosed): the ETG channel is physically normalised in ELECTRON gyro
    units and transported at the electron gyroBohm.  With s = sqrt(m_i/m_e)
    and u = s*sqrt(Te/Ti) (the c_s/a growth-rate scale factor), converting
    phi^2_e = gamma_e/(k_e^2 |w_e|), W_e = k_e R_LTe/|w_e| and
    chi_gB_e = chi_gB_i/s into ion-unit arithmetic collapses to ONE factor:
    chi_etg[i-gB] = mixing_ion * W_ion * u.  The reference's 1/60^2 rule
    under-counts by ~u*s^2 because it mixes ion-unit amplitudes with an
    electron mass-ratio suppression."""
    m_i = ion_mass_amu * M_PROTON
    t_i_j = t_i_kev * 1e3 * E_CHARGE
    c_s = jnp.sqrt(t_i_j / m_i)
    rho_s = m_i * c_s / (E_CHARGE * b0)
    chi_gb = rho_s**2 * c_s / a

    rho_i = m_i * jnp.sqrt(2.0 * t_i_j / m_i) / (E_CHARGE * b0)
    b_i = k_y**2 * (rho_i / a) ** 2
    g0 = gamma0_flr(b_i)

    active = (gamma_net > 0.0) & (phi_sq > 0.0) & (jnp.abs(omega_r) > 1e-10)
    # Same effective-frequency regularisation as the saturation rule.
    inv_w = 1.0 / jnp.maximum(jnp.maximum(jnp.abs(omega_r), gamma_net), 1e-10)
    etg = k_y > KY_ETG_BOUNDARY
    ion_scale = active & ~etg
    etg_scale = active & etg

    w_i = k_y * r_l_ti * inv_w
    w_e = k_y * r_l_te * inv_w
    w_n = k_y * r_l_ne * inv_w

    chi_i_n = jnp.sum(jnp.where(ion_scale, phi_sq * w_i * g0, 0.0))
    chi_e_ion = jnp.sum(jnp.where(ion_scale, phi_sq * w_e, 0.0))
    d_e_n = jnp.sum(jnp.where(ion_scale, phi_sq * w_n, 0.0))
    # Thermodiffusion pinch (Connor & Wilson 1994).
    v_e_n = jnp.sum(jnp.where(ion_scale, phi_sq * w_n * 1.5 * te_ti, 0.0))
    # ETG channel: electron-unit normalisation collapsed to one factor
    # (see docstring).  phi_sq for ETG modes is the ion-unit mixing value.
    chi_e_etg_n = jnp.sum(
        jnp.where(etg_scale, phi_sq * w_e * etg_unit_scale, 0.0))

    return (chi_i_n * chi_gb, (chi_e_ion + chi_e_etg_n) * chi_gb,
            d_e_n * chi_gb, v_e_n * chi_gb, chi_e_etg_n * chi_gb)


# ── Spectrum assembly + the whole model in one jit ───────────────────────


@partial(jax.jit, static_argnames=("cfg",))
def tglf_native_fluxes(
    r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star,
    a, b0, r0, t_i_kev,
    *, cfg: TGLFNativeConfig = TGLFNativeConfig(),
) -> TGLFNativeFluxes:
    """Full native TGLF evaluation at one flux surface, fully jittable.

    All parameters may be traced arrays — ``jax.vmap`` over any of them
    gives whole-profile or scan-space evaluation in one compiled program.
    """
    vgrid = VelocityGrid(n_energy=cfg.n_energy, n_lambda=cfg.n_lambda)
    tau = 1.0 / jnp.maximum(te_ti, 1e-6)          # T_i / T_e
    r_over_a = r0 / a

    ky_ion = jnp.linspace(cfg.ky_ion_min, cfg.ky_ion_max, cfg.n_ky_ion)

    def ion_mode(ky):
        # Optional kinetic trapped electrons: enables the TEM branch (the
        # adiabatic-electron dispersion cannot go unstable from density /
        # electron-temperature gradients alone).  See config note.
        out = solve_local_kinetic_dispersion(
            ky, r_l_t=r_l_ti, r_l_n=r_l_ne, tau=tau, q=q,
            epsilon_r=epsilon, vgrid=vgrid,
            kinetic_electrons=cfg.kinetic_electrons, r_l_te=r_l_te,
            nu_detrap=nu_star / jnp.maximum(epsilon, 1e-3))
        # Unconverged roots are spurious values, not modes: mask them.
        g = jnp.where(out.converged, jnp.maximum(out.gamma, 0.0), 0.0)
        # c_s/R -> c_s/a units.
        return out.omega_r * r_over_a, g * r_over_a

    omega_ion, gamma_ion = jax.vmap(ion_mode)(ky_ion)

    if cfg.multiscale and cfg.n_ky_etg > 0:
        # ETG isomorphism: electrons drive, ions adiabatic (tau -> 1/tau),
        # solved in electron-scale units then mapped back:
        # k_y rho_s = sqrt(m_i/m_e) k_y rho_e; gamma_cs =
        # sqrt(m_i/m_e * T_e/T_i) gamma_ce (v_te / c_s rescale).
        ky_etg_e = jnp.linspace(0.1, 0.6, cfg.n_ky_etg)

        def etg_mode(ky_e):
            out = solve_local_kinetic_dispersion(
                ky_e, r_l_t=r_l_te, r_l_n=r_l_ne,
                tau=jnp.maximum(te_ti, 1e-6), q=q,
                epsilon_r=epsilon, vgrid=vgrid)
            scale = SQRT_MI_ME * jnp.sqrt(jnp.maximum(te_ti, 1e-6)) \
                * r_over_a
            # Only accept roots in the driving species' diamagnetic
            # direction (omega_r < 0 in the iso frame) — the quadrature-
            # approximated integral can expose spurious wrong-direction
            # zeros at strong drive.  Sign then flips: ETG propagates in
            # the ELECTRON direction (positive by our convention).
            genuine = (out.omega_r < 0.0) & out.converged
            g = jnp.where(genuine, jnp.maximum(out.gamma, 0.0), 0.0)
            return -out.omega_r * scale, g * scale

        omega_etg, gamma_etg = jax.vmap(etg_mode)(ky_etg_e)
        k_y = jnp.concatenate([ky_ion, SQRT_MI_ME * ky_etg_e])
        omega_r = jnp.concatenate([omega_ion, omega_etg])
        gamma = jnp.concatenate([gamma_ion, gamma_etg])
    else:
        k_y, omega_r, gamma = ky_ion, omega_ion, gamma_ion

    g_exb = exb_shear_rate(s_hat, q, epsilon, r_l_ti)
    tp = trapped_particle_damping(epsilon, nu_star)
    gamma_net = jnp.maximum(gamma * tp - cfg.alpha_exb * jnp.abs(g_exb), 0.0)
    etg_unit = SQRT_MI_ME * jnp.sqrt(jnp.maximum(te_ti, 1e-6))
    phi_sq = sat_phi_sq(gamma_net, omega_r, k_y, cfg.sat_model, cfg.alpha_cs,
                        etg_unit_scale=etg_unit)

    chi_i, chi_e, d_e, v_e, chi_e_etg = quasilinear_fluxes(
        k_y, gamma_net, omega_r, phi_sq,
        r_l_ti=r_l_ti, r_l_te=r_l_te, r_l_ne=r_l_ne, te_ti=te_ti,
        a=a, b0=b0, t_i_kev=t_i_kev, etg_unit_scale=etg_unit)

    return TGLFNativeFluxes(
        chi_i=chi_i, chi_e=chi_e, d_e=d_e, v_e=v_e, chi_e_etg=chi_e_etg,
        k_y=k_y, gamma=gamma, gamma_net=gamma_net, omega_r=omega_r,
        phi_sq=phi_sq, gamma_exb=g_exb)


@partial(jax.jit, static_argnames=("cfg",))
def tglf_native_fluxes_profile(
    r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star,
    a, b0, r0, t_i_kev,
    *, cfg: TGLFNativeConfig = TGLFNativeConfig(),
) -> TGLFNativeFluxes:
    """Whole radial profile in ONE compiled program: every array argument
    is (n_rho,); scalars broadcast.  This is the lane the transport loop
    calls — n_rho surfaces cost one batched dispersion solve, not n_rho
    host round-trips (the reference loops surfaces in Python)."""
    n = jnp.shape(r_l_ti)[0]

    def bc(x):
        return jnp.broadcast_to(jnp.asarray(x, jnp.result_type(float)), (n,))

    args = tuple(bc(v) for v in (
        r_l_ti, r_l_te, r_l_ne, q, s_hat, epsilon, te_ti, nu_star,
        a, b0, r0, t_i_kev))
    return jax.vmap(lambda *xs: tglf_native_fluxes(*xs, cfg=cfg))(*args)


# ── Deck-file solver wrapper (registry contract) ─────────────────────────


def _classify(r: "TGLFNativeFluxes") -> str:
    """Dominant mode by FLUX attribution, not raw growth rate: electron-
    scale gammas are ~sqrt(m_i/m_e) larger in c_s/a units, so a raw-gamma
    argmax would call every multiscale case ETG even when the ETG channel
    carries negligible transport."""
    gamma_net = np.asarray(r.gamma_net)
    k_y = np.asarray(r.k_y)
    if gamma_net.size == 0 or np.all(gamma_net <= 0.0):
        return "stable"
    if float(r.chi_e_etg) > 0.5 * max(float(r.chi_e), 1e-30):
        return "ETG"
    ion = k_y <= KY_ETG_BOUNDARY
    g_ion = np.where(ion, gamma_net, 0.0)
    if np.all(g_ion <= 0.0):
        return "ETG" if float(r.chi_e_etg) > 0.0 else "stable"
    i = int(np.argmax(g_ion))
    return "ITG" if float(np.asarray(r.omega_r)[i]) < 0.0 else "TEM"


class TGLFNativeSolver(GKSolverBase):
    """Registry adapter around :func:`tglf_native_fluxes`.

    ``prepare_input``/``run`` speak the JSON-deck contract (reference
    ``gk_tglf_native.py:309-361``); ``solve`` exposes the raw fluxes.
    """

    def __init__(self, config: TGLFNativeConfig | None = None) -> None:
        self.config = config or TGLFNativeConfig()

    def is_available(self) -> bool:
        return True

    def prepare_input(self, params: GKLocalParams) -> Path:
        payload = {"params": params.as_dict(),
                   "config": dataclasses.asdict(self.config)}
        with tempfile.NamedTemporaryFile(
                mode="w", encoding="utf-8", prefix="tglf_native_",
                suffix=".json", delete=False) as fh:
            json.dump(payload, fh)
            return Path(fh.name)

    def run(self, input_path: Path, *, timeout_s: float = 30.0) -> GKOutput:
        path = Path(input_path)
        if path.suffix.lower() != ".json":
            raise ValueError("native deck must be a .json file")
        payload = json.loads(path.read_text(encoding="utf-8"))
        params_dict = payload.get("params")
        if not isinstance(params_dict, dict):
            raise ValueError("native deck missing 'params' object")
        cfg_dict = payload.get("config")
        if isinstance(cfg_dict, dict):
            self.config = TGLFNativeConfig(**cfg_dict)
        return self.run_from_params(GKLocalParams(**params_dict),
                                    timeout_s=timeout_s)

    def run_from_params(self, params: GKLocalParams, *,
                        timeout_s: float = 30.0) -> GKOutput:
        del timeout_s  # native model: no subprocess to bound
        r = self.solve(params)
        return GKOutput(
            chi_i=float(r.chi_i), chi_e=float(r.chi_e), d_e=float(r.d_e),
            d_i=0.0, gamma=np.asarray(r.gamma),
            omega_r=np.asarray(r.omega_r), k_y=np.asarray(r.k_y),
            dominant_mode=_classify(r),
            converged=True)

    def solve(self, params: GKLocalParams) -> TGLFNativeFluxes:
        return tglf_native_fluxes(
            params.r_l_ti, params.r_l_te, params.r_l_ne, params.q,
            params.s_hat, params.epsilon, params.te_ti, params.nu_star,
            params.a, params.b0, params.r0, params.t_i_kev,
            cfg=self.config)
