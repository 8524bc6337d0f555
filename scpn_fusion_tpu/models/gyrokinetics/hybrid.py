"""Hybrid surrogate+GK transport lane: OOD detection, spot-check
scheduling, correction, online learning.

JAX-native equivalent of the reference's path-C architecture
(``core/gk_ood_detector.py:85`` Mahalanobis/range/ensemble OOD,
``core/gk_scheduler.py:48`` periodic/adaptive/critical-region spot-check
scheduling with a call budget, ``core/gk_corrector.py:60`` EMA-smoothed
multiplicative corrections interpolated from spot-check surfaces, and
``core/gk_online_learner.py:47`` buffered retraining).  Redesigned around
static shapes and pure functions:

* OOD checks are vectorised over all flux surfaces at once (one matmul for
  the Mahalanobis form),
* the scheduler returns a FIXED-size index set (budget slots + validity
  mask + integer reason codes) so the decision logic jits and the caller
  can batch the GK spot-checks it triggers,
* the corrector is a small pytree updated by pure EMA + interpolation,
* the online learner is a ring buffer + closed-form ridge refit (one
  (d x d) solve) instead of a Python retraining loop.

Feature layout per surface (matches the reference's 10D surrogate input):
[R/L_Ti, R/L_Te, R/L_ne, q, s_hat, alpha_MHD, Te/Ti, Z_eff, nu_star, beta_e]
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.dtypes import canonical, default_float

N_GK_FEATURES = 10

# Scheduler reason codes (static-shape replacement for reason strings).
REASON_NONE, REASON_ANCHOR, REASON_OOD, REASON_CHI_CHANGE, \
    REASON_CRITICAL = 0, 1, 2, 3, 4


# ---------------------------------------------------------------------------
# OOD detection
# ---------------------------------------------------------------------------

class OODParams(NamedTuple):
    mean: jnp.ndarray          # (d,)
    cov_inv: jnp.ndarray       # (d, d)
    std: jnp.ndarray           # (d,)
    mahalanobis_threshold: jnp.ndarray
    soft_sigma_threshold: jnp.ndarray
    ensemble_threshold: jnp.ndarray


def fit_ood(training_x: jnp.ndarray, *, mahalanobis_threshold: float = 4.0,
            soft_sigma_threshold: float = 2.0,
            ensemble_threshold: float = 0.3,
            ridge: float = 1e-6) -> OODParams:
    """Fit training-distribution statistics for the detector."""
    x = jnp.asarray(training_x)
    mean = jnp.mean(x, axis=0)
    std = jnp.maximum(jnp.std(x, axis=0), 1e-12)
    cov = jnp.cov(x, rowvar=False) + ridge * jnp.eye(x.shape[1], dtype=x.dtype)
    return OODParams(
        mean=mean, cov_inv=jnp.linalg.inv(cov), std=std,
        mahalanobis_threshold=jnp.asarray(mahalanobis_threshold, x.dtype),
        soft_sigma_threshold=jnp.asarray(soft_sigma_threshold, x.dtype),
        ensemble_threshold=jnp.asarray(ensemble_threshold, x.dtype))


def mahalanobis_distance(x: jnp.ndarray, p: OODParams) -> jnp.ndarray:
    """Batched Mahalanobis distance; x is (n_surfaces, d) or (d,)."""
    diff = jnp.atleast_2d(x) - p.mean[None, :]
    d2 = jnp.einsum("ni,ij,nj->n", diff, p.cov_inv, diff)
    return jnp.sqrt(jnp.maximum(d2, 0.0))


class OODResult(NamedTuple):
    is_ood: jnp.ndarray        # (n,) bool
    confidence: jnp.ndarray    # (n,) in [0, 1]
    mahalanobis: jnp.ndarray   # (n,)
    range_violation: jnp.ndarray  # (n,) bool


def ood_check(x: jnp.ndarray, p: OODParams,
              ensemble_std: jnp.ndarray | None = None) -> OODResult:
    """Combined detector: Mahalanobis + soft range (+ optional ensemble
    disagreement), vectorised over surfaces (reference
    ``OODDetector.check_*`` :85-200 combined verdict)."""
    x2 = jnp.atleast_2d(x)
    d_m = mahalanobis_distance(x2, p)
    maha_ood = d_m > p.mahalanobis_threshold
    sigma_dev = jnp.abs(x2 - p.mean[None, :]) / p.std[None, :]
    range_ood = jnp.any(sigma_dev > p.soft_sigma_threshold * 3.0, axis=1)
    is_ood = maha_ood | range_ood
    if ensemble_std is not None:
        is_ood = is_ood | (jnp.atleast_1d(ensemble_std)
                           > p.ensemble_threshold)
    conf = jnp.clip(d_m / jnp.maximum(p.mahalanobis_threshold, 1e-12),
                    0.0, 1.0)
    conf = jnp.where(range_ood, jnp.maximum(conf, 1.0), conf)
    return OODResult(is_ood=is_ood, confidence=conf, mahalanobis=d_m,
                     range_violation=range_ood)


# ---------------------------------------------------------------------------
# Spot-check scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    strategy: str = "adaptive"     # "periodic" | "adaptive" | "critical_region"
    period: int = 5
    budget: int = 5
    anchor_rho: tuple = (0.3, 0.5, 0.8)
    pedestal_rho: float = 0.85
    axis_rho: float = 0.15
    chi_change_threshold: float = 0.5

    def __post_init__(self):
        if self.strategy not in ("periodic", "adaptive", "critical_region"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.budget < 1:
            raise ValueError("budget must be >= 1")


class SpotCheckPlan(NamedTuple):
    """Fixed-size plan: `indices[i]` is valid iff `valid[i]`."""

    indices: jnp.ndarray   # (budget,) int32 surface indices
    valid: jnp.ndarray     # (budget,) bool
    reasons: jnp.ndarray   # (budget,) int32 reason codes
    any_requested: jnp.ndarray  # scalar bool


def schedule_spot_checks(cfg: SchedulerConfig, step: jnp.ndarray,
                         rho: jnp.ndarray, chi_i: jnp.ndarray,
                         prev_chi_i: jnp.ndarray,
                         ood_mask: jnp.ndarray | None = None
                         ) -> SpotCheckPlan:
    """Decide which surfaces get an expensive GK run this transport step.

    Jittable: priority scores are built per surface, the top-`budget`
    surfaces win their slots (reference ``GKScheduler.step`` :57-140
    semantics with the dict-of-reasons replaced by score/reason arrays).
    """
    n = rho.shape[0]
    score = jnp.zeros(n, chi_i.dtype)
    reason = jnp.full(n, REASON_NONE, jnp.int32)

    anchor_idx = jnp.stack(
        [jnp.argmin(jnp.abs(rho - r)) for r in cfg.anchor_rho]).astype(
        jnp.int32)
    is_anchor = jnp.zeros(n, bool).at[anchor_idx].set(True)

    if cfg.strategy == "periodic":
        active = (step % cfg.period) == 0
        score = jnp.where(is_anchor & active, 1.0, score)
        reason = jnp.where(is_anchor & active, REASON_ANCHOR, reason)
    elif cfg.strategy == "adaptive":
        if ood_mask is not None:
            score = jnp.where(ood_mask, 3.0, score)
            reason = jnp.where(ood_mask, REASON_OOD, reason)
        rel = jnp.abs(chi_i - prev_chi_i) \
            / jnp.maximum(jnp.abs(prev_chi_i), 1e-10)
        big = rel > cfg.chi_change_threshold
        score = jnp.where(big & (score == 0), 2.0, score)
        reason = jnp.where(big & (reason == REASON_NONE),
                           REASON_CHI_CHANGE, reason)
        score = jnp.where(is_anchor & (score == 0), 1.0, score)
        reason = jnp.where(is_anchor & (reason == REASON_NONE),
                           REASON_ANCHOR, reason)
    else:  # critical_region
        crit = (rho > cfg.pedestal_rho) | (rho < cfg.axis_rho)
        score = jnp.where(crit, 2.0, score)
        reason = jnp.where(crit, REASON_CRITICAL, reason)
        score = jnp.where(is_anchor & (score == 0), 1.0, score)
        reason = jnp.where(is_anchor & (reason == REASON_NONE),
                           REASON_ANCHOR, reason)

    top_scores, top_idx = jax.lax.top_k(score, cfg.budget)
    valid = top_scores > 0.0
    return SpotCheckPlan(
        indices=top_idx.astype(jnp.int32), valid=valid,
        reasons=reason[top_idx], any_requested=jnp.any(valid))


# ---------------------------------------------------------------------------
# Corrector
# ---------------------------------------------------------------------------

class CorrectorState(NamedTuple):
    alpha_chi_i: jnp.ndarray   # (nr,) multiplicative factors
    alpha_chi_e: jnp.ndarray
    alpha_d_e: jnp.ndarray


def init_corrector(nr: int, dtype=None) -> CorrectorState:
    dtype = default_float() if dtype is None else canonical(dtype)
    one = jnp.ones(nr, dtype)
    return CorrectorState(one, one, one)


def corrector_update(state: CorrectorState, rho: jnp.ndarray,
                     spot_rho: jnp.ndarray, spot_valid: jnp.ndarray,
                     gk_fluxes: jnp.ndarray, surr_fluxes: jnp.ndarray,
                     smoothing_alpha: float = 0.3) -> CorrectorState:
    """EMA-blend new correction factors interpolated from spot checks.

    gk_fluxes / surr_fluxes: (budget, 3) columns [chi_i, chi_e, D_e].
    Invalid slots are masked out of the interpolation by collapsing them
    onto the first valid point (reference ``GKCorrector.update`` :71-106).
    """
    ratio = gk_fluxes / jnp.maximum(jnp.abs(surr_fluxes), 1e-10)
    # Sort by rho so interp sees increasing x; push invalid slots to the end
    # with a huge rho and clamp ratios there to 1 (no correction).
    big = jnp.asarray(10.0, rho.dtype)
    x = jnp.where(spot_valid, spot_rho, big)
    ratio = jnp.where(spot_valid[:, None], ratio, 1.0)
    order = jnp.argsort(x)
    x = x[order]
    ratio = ratio[order]

    def interp(col):
        return jnp.interp(rho, x, col)

    new_i, new_e, new_d = (interp(ratio[:, 0]), interp(ratio[:, 1]),
                           interp(ratio[:, 2]))
    a = smoothing_alpha
    any_valid = jnp.any(spot_valid)

    def blend(old, new):
        return jnp.where(any_valid, a * new + (1.0 - a) * old, old)

    return CorrectorState(
        alpha_chi_i=blend(state.alpha_chi_i, new_i),
        alpha_chi_e=blend(state.alpha_chi_e, new_e),
        alpha_d_e=blend(state.alpha_d_e, new_d))


def corrector_apply(state: CorrectorState, chi_i, chi_e, d_e):
    return (chi_i * state.alpha_chi_i, chi_e * state.alpha_chi_e,
            d_e * state.alpha_d_e)


# ---------------------------------------------------------------------------
# Online learner (ring buffer + closed-form ridge refit)
# ---------------------------------------------------------------------------

class LearnerState(NamedTuple):
    x_buf: jnp.ndarray     # (capacity, d)
    y_buf: jnp.ndarray     # (capacity, m)
    count: jnp.ndarray     # total samples seen
    weights: jnp.ndarray   # (d + 1, m) ridge model (bias row last)


def init_learner(capacity: int = 256, d: int = N_GK_FEATURES, m: int = 3,
                 dtype=None) -> LearnerState:
    dtype = default_float() if dtype is None else canonical(dtype)
    return LearnerState(
        x_buf=jnp.zeros((capacity, d), dtype),
        y_buf=jnp.zeros((capacity, m), dtype),
        count=jnp.asarray(0, jnp.int32),
        weights=jnp.zeros((d + 1, m), dtype))


def learner_add(state: LearnerState, x: jnp.ndarray,
                y: jnp.ndarray) -> LearnerState:
    """Insert one (features, fluxes) sample into the ring buffer."""
    cap = state.x_buf.shape[0]
    slot = state.count % cap
    return state._replace(
        x_buf=state.x_buf.at[slot].set(x.astype(state.x_buf.dtype)),
        y_buf=state.y_buf.at[slot].set(y.astype(state.y_buf.dtype)),
        count=state.count + 1)


def learner_refit(state: LearnerState, l2: float = 1e-3) -> LearnerState:
    """Closed-form ridge refit over the filled buffer (one (d+1)^2 solve;
    replaces the reference's buffered SGD retraining
    ``gk_online_learner.py:90-220``)."""
    cap = state.x_buf.shape[0]
    filled = (jnp.arange(cap) < state.count).astype(state.x_buf.dtype)
    xa = jnp.concatenate(
        [state.x_buf, jnp.ones((cap, 1), state.x_buf.dtype)], axis=1)
    xw = xa * filled[:, None]
    gram = xw.T @ xa + l2 * jnp.eye(xa.shape[1], dtype=xa.dtype)
    rhs = xw.T @ state.y_buf
    return state._replace(weights=jnp.linalg.solve(gram, rhs))


def learner_predict(state: LearnerState, x: jnp.ndarray) -> jnp.ndarray:
    x2 = jnp.atleast_2d(x).astype(state.weights.dtype)
    xa = jnp.concatenate([x2, jnp.ones((x2.shape[0], 1), x2.dtype)], axis=1)
    return xa @ state.weights


# ---------------------------------------------------------------------------
# Session verification report
# ---------------------------------------------------------------------------

class ReportState(NamedTuple):
    """Accumulated per-session verification statistics.

    Scan-carry counterpart of the reference's mutable
    ``VerificationReport`` (``core/gk_verification_report.py:25-97``):
    instead of appending ``CorrectionRecord`` objects to a Python list,
    the moments the report exposes (counts, error sums, running max,
    correction-factor sum) accumulate branch-free inside the transport
    scan; ``report_to_dict`` finalises the same JSON summary fields.
    """

    total_steps: jnp.ndarray        # scalar int32
    steps_verified: jnp.ndarray     # scalar int32
    total_spot_checks: jnp.ndarray  # scalar int32
    ood_triggers: jnp.ndarray       # scalar int32
    n_records: jnp.ndarray          # scalar int32 (valid spot comparisons)
    sum_abs_rel_err: jnp.ndarray    # chi_i |rel err| sum over records
    max_abs_rel_err: jnp.ndarray
    sum_correction: jnp.ndarray     # aggregate |alpha - 1| magnitudes
    n_correction: jnp.ndarray


def init_report(dtype=None) -> ReportState:
    dtype = default_float() if dtype is None else canonical(dtype)
    z_i = jnp.asarray(0, jnp.int32)
    z_f = jnp.asarray(0.0, dtype)
    return ReportState(z_i, z_i, z_i, z_i, z_i, z_f, z_f, z_f, z_i)


def report_add_step(rep: ReportState, *, spot_valid: jnp.ndarray,
                    ood_flags: jnp.ndarray, gk_chi_i: jnp.ndarray,
                    surr_chi_i: jnp.ndarray,
                    corrector: CorrectorState | None = None) -> ReportState:
    """Fold one transport step's spot-check outcome into the report.

    ``spot_valid``: (budget,) bool — which scheduled slots ran a GK check;
    ``gk_chi_i`` / ``surr_chi_i``: (budget,) fluxes at those slots;
    ``ood_flags``: (nr,) bool per-surface OOD indicators.
    """
    n_spots = jnp.sum(spot_valid).astype(jnp.int32)
    verified = (n_spots > 0).astype(jnp.int32)
    # Signed relative chi_i error with the reference's tiny-GK guard.
    denom_ok = jnp.abs(gk_chi_i) >= 1e-10
    rel = jnp.where(denom_ok, (surr_chi_i - gk_chi_i)
                    / jnp.where(denom_ok, gk_chi_i, 1.0), 0.0)
    rel = jnp.where(spot_valid, jnp.abs(rel), 0.0)
    new_max = jnp.maximum(rep.max_abs_rel_err, jnp.max(rel))
    corr_mag = jnp.asarray(0.0, rep.sum_correction.dtype)
    n_corr = jnp.asarray(0, jnp.int32)
    if corrector is not None:
        corr_mag = jnp.mean(jnp.abs(corrector.alpha_chi_i - 1.0))
        n_corr = verified
    return ReportState(
        total_steps=rep.total_steps + 1,
        steps_verified=rep.steps_verified + verified,
        total_spot_checks=rep.total_spot_checks + n_spots,
        ood_triggers=rep.ood_triggers
        + jnp.sum(ood_flags).astype(jnp.int32),
        n_records=rep.n_records + n_spots,
        sum_abs_rel_err=rep.sum_abs_rel_err + jnp.sum(rel),
        max_abs_rel_err=new_max,
        sum_correction=rep.sum_correction + corr_mag * n_corr,
        n_correction=rep.n_correction + n_corr)


def report_to_dict(rep: ReportState) -> dict:
    """Finalise the JSON-shape summary (reference ``to_dict`` parity)."""
    total = int(rep.total_steps)
    n_rec = int(rep.n_records)
    n_corr = int(rep.n_correction)
    return {
        "total_steps": total,
        "steps_verified": int(rep.steps_verified),
        "verification_fraction":
            round(int(rep.steps_verified) / total, 4) if total else 0.0,
        "total_spot_checks": int(rep.total_spot_checks),
        "ood_triggers": int(rep.ood_triggers),
        "max_rel_error_chi_i": round(float(rep.max_abs_rel_err), 4),
        "mean_rel_error_chi_i":
            round(float(rep.sum_abs_rel_err) / n_rec, 4) if n_rec else 0.0,
        "n_correction_records": n_rec,
        "mean_correction_factor":
            round(float(rep.sum_correction) / n_corr, 4) if n_corr else 0.0,
    }


def report_to_json(rep: ReportState, path=None) -> str:
    import json as _json
    text = _json.dumps(report_to_dict(rep), indent=2)
    if path is not None:
        from pathlib import Path as _Path
        _Path(path).write_text(text)
    return text
