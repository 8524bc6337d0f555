"""Monte Carlo uncertainty quantification for fusion performance.

JAX-native equivalent of the reference UQ chain
(``core/uncertainty.py:124-340``, ``core/uncertainty_full_chain.py:44-300``):
sample the IPB98(y,2) scaling-law coefficients from their Gaussian
(optionally correlated) posteriors, propagate through confinement ->
fusion power with alpha self-heating, and report medians / sigmas /
percentile bands.

The reference loops 10,000 samples in Python; here the entire posterior
ensemble propagates in one ``vmap`` over a coefficient pytree — 10k
samples are a single device launch.  f32-safe: the n_e^2 E_fus volume
factor (~1e40 in SI) is folded into host-double constants in 1e19
units, the same normalisation discipline as ``models/physics/scaling_burn``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from scpn_fusion_tpu.models.physics.scaling_burn import bosch_hale_sigmav

# IPB98(y,2) central exponents and Verdoolaege-2021-style 1-sigma
# posteriors (reference ``uncertainty.py:43-66``).
IPB98_KEYS = ("C", "alpha_I", "alpha_B", "alpha_P", "alpha_n", "alpha_R",
              "alpha_A", "alpha_kappa", "alpha_M")
IPB98_CENTRAL = np.array([0.0562, 0.93, 0.15, -0.69, 0.41, 1.97, -0.58,
                          0.78, 0.19])
IPB98_SIGMA = np.array([0.012, 0.03, 0.05, 0.02, 0.04, 0.08, 0.06, 0.07,
                        0.04])

_KEV_PER_MJ_N19 = 1e6 / (3.0 * 1e19 * 1.602176634e-16)   # Ti = W*this/(n19 V)
_E_FUS_J = 17.6e6 * 1.602176634e-19
_FUS_CONST_MW = 0.25 * 1e38 * _E_FUS_J / 1e6   # P[MW] = this * n19^2 sv V


@dataclasses.dataclass(frozen=True)
class PlasmaScenario:
    """Machine point held fixed during coefficient sampling."""

    i_p_ma: float
    b_t: float
    p_heat_mw: float
    n_e_19: float
    r_major: float
    aspect: float
    kappa: float
    m_amu: float = 2.5


class UQResult(NamedTuple):
    tau_e: jnp.ndarray
    p_fusion: jnp.ndarray
    q: jnp.ndarray
    tau_e_sigma: jnp.ndarray
    p_fusion_sigma: jnp.ndarray
    q_sigma: jnp.ndarray
    tau_e_percentiles: jnp.ndarray     # [5, 25, 50, 75, 95]
    p_fusion_percentiles: jnp.ndarray
    q_percentiles: jnp.ndarray
    n_samples: int


def ipb98_tau_e(s: PlasmaScenario, coeffs: jnp.ndarray) -> jnp.ndarray:
    """tau_E from one coefficient vector (order = IPB98_KEYS); log-linear."""
    c = jnp.maximum(coeffs[0], 1e-4)
    alpha_p = jnp.minimum(coeffs[3], -0.1)
    log_tau = (jnp.log(c)
               + coeffs[1] * jnp.log(s.i_p_ma)
               + coeffs[2] * jnp.log(s.b_t)
               + alpha_p * jnp.log(s.p_heat_mw)
               + coeffs[4] * jnp.log(s.n_e_19)
               + coeffs[5] * jnp.log(s.r_major)
               + coeffs[6] * jnp.log(s.aspect)
               + coeffs[7] * jnp.log(s.kappa)
               + coeffs[8] * jnp.log(s.m_amu))
    return jnp.exp(jnp.clip(log_tau, -60.0, 60.0))


def fusion_power_from_tau(s: PlasmaScenario, tau_e) -> jnp.ndarray:
    """P_fus with one alpha self-heating fixed-point refinement
    (reference ``fusion_power_from_tau``); 1e19-normalised f32-safe."""
    a_minor = s.r_major / s.aspect
    volume = 2.0 * jnp.pi**2 * s.r_major * a_minor**2 * s.kappa
    f_alpha = 3.5 / 17.6

    def pfus_at(p_tot_mw):
        w_mj = p_tot_mw * tau_e
        ti = jnp.clip(w_mj * _KEV_PER_MJ_N19 / (s.n_e_19 * volume),
                      0.5, 100.0)
        sv = bosch_hale_sigmav(ti)
        return _FUS_CONST_MW * s.n_e_19**2 * sv * volume

    p0 = pfus_at(s.p_heat_mw)
    return jnp.maximum(pfus_at(s.p_heat_mw + f_alpha * p0), 0.0)


def _percentiles(x, qs=(5.0, 25.0, 50.0, 75.0, 95.0)):
    return jnp.percentile(x, jnp.asarray(qs))


@partial(jax.jit, static_argnames=("s", "n_samples"))
def quantify_uncertainty(s: PlasmaScenario, *, n_samples: int = 10000,
                         seed: int = 0) -> UQResult:
    """Vectorised MC over the IPB98 posterior (reference
    ``quantify_uncertainty``, which loops sample-by-sample)."""
    key = jax.random.PRNGKey(seed)
    z = jax.random.normal(key, (n_samples, len(IPB98_KEYS)))
    coeffs = jnp.asarray(IPB98_CENTRAL) + z * jnp.asarray(IPB98_SIGMA)

    def chain(cv):
        tau = jnp.maximum(ipb98_tau_e(s, cv), 1e-6)
        pfus = fusion_power_from_tau(s, tau)
        q = jnp.where(s.p_heat_mw > 0, pfus / s.p_heat_mw, 0.0)
        return tau, pfus, jnp.nan_to_num(q)

    tau, pfus, q = jax.vmap(chain)(coeffs)
    return UQResult(
        jnp.median(tau), jnp.median(pfus), jnp.median(q),
        jnp.std(tau), jnp.std(pfus), jnp.std(q),
        _percentiles(tau), _percentiles(pfus), _percentiles(q), n_samples)


@dataclasses.dataclass(frozen=True)
class EquilibriumUncertainty:
    """Reconstruction-channel uncertainty (reference dataclass parity)."""

    psi_nrmse_mean: float = 0.0
    psi_nrmse_sigma: float = 0.01
    r_axis_sigma: float = 0.02
    z_axis_sigma: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransportUncertainty:
    chi_gb_factor_sigma: float = 0.3
    pedestal_height_sigma: float = 0.2


class FullChainUQResult(NamedTuple):
    tau_e: jnp.ndarray
    p_fusion: jnp.ndarray
    q: jnp.ndarray
    tau_e_sigma: jnp.ndarray
    p_fusion_sigma: jnp.ndarray
    q_sigma: jnp.ndarray
    psi_nrmse_bands: jnp.ndarray     # [5, 50, 95]
    tau_e_bands: jnp.ndarray
    p_fusion_bands: jnp.ndarray
    q_bands: jnp.ndarray
    n_samples: int


def ipb98_covariance() -> np.ndarray:
    """Correlated coefficient covariance: C <-> alpha_R anti-correlation
    -0.7 from global regressions (reference ``_build_ipb98_covariance``)."""
    cov = np.diag(IPB98_SIGMA**2)
    cov[0, 5] = cov[5, 0] = -0.7 * IPB98_SIGMA[0] * IPB98_SIGMA[5]
    return cov


@partial(jax.jit, static_argnames=("s", "eq", "tr", "n_samples"))
def quantify_full_chain(
    s: PlasmaScenario,
    eq: EquilibriumUncertainty = EquilibriumUncertainty(),
    tr: TransportUncertainty = TransportUncertainty(),
    *,
    n_samples: int = 5000,
    seed: int = 0,
) -> FullChainUQResult:
    """Equilibrium -> transport -> burn chain with correlated IPB98
    posterior sampling (reference ``quantify_full_chain``):

    - psi reconstruction NRMSE jitters the effective stored energy,
    - the gyro-Bohm / pedestal channels jitter tau_E multiplicatively,
    - the correlated scaling posterior drives the burn model.
    """
    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    chol = jnp.asarray(np.linalg.cholesky(
        ipb98_covariance() + 1e-12 * np.eye(len(IPB98_KEYS))))
    z = jax.random.normal(k1, (n_samples, len(IPB98_KEYS)))
    coeffs = jnp.asarray(IPB98_CENTRAL) + z @ chol.T

    psi_nrmse = jnp.abs(eq.psi_nrmse_mean
                        + eq.psi_nrmse_sigma * jax.random.normal(
                            k2, (n_samples,)))
    chi_factor = jnp.maximum(
        1.0 + tr.chi_gb_factor_sigma * jax.random.normal(k3, (n_samples,)),
        0.1)
    ped_factor = jnp.maximum(
        1.0 + tr.pedestal_height_sigma * jax.random.normal(k4, (n_samples,)),
        0.1)

    def chain(cv, nrmse, chi_f, ped_f):
        tau = jnp.maximum(ipb98_tau_e(s, cv), 1e-6)
        # Higher chi -> shorter tau; taller pedestal -> longer tau;
        # reconstruction error degrades the usable stored energy.
        tau = tau * ped_f / chi_f * (1.0 - jnp.clip(nrmse, 0.0, 0.5))
        pfus = fusion_power_from_tau(s, tau)
        q = jnp.where(s.p_heat_mw > 0, pfus / s.p_heat_mw, 0.0)
        return tau, pfus, jnp.nan_to_num(q)

    tau, pfus, q = jax.vmap(chain)(coeffs, psi_nrmse, chi_factor, ped_factor)
    bands = jnp.asarray([5.0, 50.0, 95.0])
    return FullChainUQResult(
        jnp.median(tau), jnp.median(pfus), jnp.median(q),
        jnp.std(tau), jnp.std(pfus), jnp.std(q),
        jnp.percentile(psi_nrmse, bands), jnp.percentile(tau, bands),
        jnp.percentile(pfus, bands), jnp.percentile(q, bands), n_samples)
