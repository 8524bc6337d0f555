"""Exactness-class reproduction comparator for evidence claims.

Counterpart of the reference studio's WS-2 comparator
(``studio/exactness.py:40-272``): a committed numeric claim declares HOW
a recompute may be compared —

* ``bit-exact``  — content-digest equality (integer / fixed-point /
  genuinely toolchain-independent kernels only),
* ``tolerance``  — ``atol + rtol*|ref|`` band with finite-aware
  semantics (NaN matches NaN, infinities match by sign — plain
  ``allclose`` would false-drift a faithful reproduction of a result
  that legitimately contains non-finite values),
* ``stochastic`` — caller seeds the RNG and reduces to one of the
  above; dispatching it directly is an error, never a silent pass.

An ABSENT class yields ``unverifiable`` — loud, never a default — and
value digests are taken over the little-endian float64 byte image, not
a decimal repr, so producer and verifier agree byte-for-byte.

This matters here because float kernels are not bit-reproducible across
the backends this framework actually spans (GPU f32/bf16, CPU x64 twin,
the C++ native runtime): a *correct* re-run yields different bits, and
a naive digest gate would read as tampering.  The repo's replay
certificate re-keys on any source change; this module supplies the
value-level verdict for individual claims inside a report.

Self-contained (no platform SDK in this image): the enums live here.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib

import numpy as np


class ExactnessClass(enum.Enum):
    BIT_EXACT = "bit-exact"
    TOLERANCE = "tolerance"
    STOCHASTIC = "stochastic"


class ReproVerdict(enum.Enum):
    MATCH = "match"
    WITHIN_TOLERANCE = "within-tolerance"
    DRIFT = "drift"
    UNVERIFIABLE = "unverifiable"


def parse_exactness_class(text: str | None) -> ExactnessClass | None:
    """Parse the declared class; unknown strings are None (→ unverifiable)."""
    if text is None:
        return None
    try:
        return ExactnessClass(text.strip().lower())
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One reproduction verdict + one-line rationale."""

    verdict: ReproVerdict
    detail: str

    @property
    def reproduced(self) -> bool:
        return self.verdict in (ReproVerdict.MATCH,
                                ReproVerdict.WITHIN_TOLERANCE)


def value_digest(value) -> str:
    """``sha256:<hex>`` over the canonical little-endian f64 byte image."""
    arr = np.ascontiguousarray(np.asarray(value, dtype="<f8"))
    return "sha256:" + hashlib.sha256(arr.tobytes()).hexdigest()


def compare_bit_exact(recomputed_digest: str, committed_digest: str) -> Verdict:
    if recomputed_digest == committed_digest:
        return Verdict(ReproVerdict.MATCH, "bit-exact digest equality")
    return Verdict(ReproVerdict.DRIFT,
                   f"digest mismatch: {recomputed_digest!r} != "
                   f"{committed_digest!r}")


def _finite_aware_within(a: np.ndarray, b: np.ndarray, *, rtol: float,
                         atol: float) -> bool:
    """Band check with structural matching of non-finite positions."""
    if a.shape != b.shape:
        return False
    special_a = np.stack([np.isnan(a), np.isposinf(a), np.isneginf(a)])
    special_b = np.stack([np.isnan(b), np.isposinf(b), np.isneginf(b)])
    if not np.array_equal(special_a, special_b):
        return False
    finite = ~special_a.any(axis=0)
    if not finite.any():
        return True
    return bool(np.all(np.abs(a[finite] - b[finite])
                       <= atol + rtol * np.abs(b[finite])))


def compare_tolerance(recomputed, reference, *, rtol: float = 1e-9,
                      atol: float = 0.0) -> Verdict:
    if rtol < 0.0 or atol < 0.0:
        raise ValueError(
            f"tolerance band must be non-negative (rtol={rtol}, atol={atol})")
    a = np.asarray(recomputed, dtype=np.float64)
    b = np.asarray(reference, dtype=np.float64)
    if _finite_aware_within(a, b, rtol=rtol, atol=atol):
        return Verdict(ReproVerdict.WITHIN_TOLERANCE,
                       f"within band (rtol={rtol:g}, atol={atol:g})")
    return Verdict(ReproVerdict.DRIFT,
                   f"beyond band (rtol={rtol:g}, atol={atol:g})")


def reproduce(exactness_class: ExactnessClass | None, *,
              recomputed_digest: str | None = None,
              committed_digest: str | None = None,
              recomputed_value=None, reference_value=None,
              rtol: float = 1e-9, atol: float = 0.0) -> Verdict:
    """Dispatch on the declared class; absent class is loud-unverifiable."""
    if exactness_class is None:
        return Verdict(ReproVerdict.UNVERIFIABLE,
                       "no exactness class declared")
    if exactness_class is ExactnessClass.STOCHASTIC:
        raise ValueError(
            "stochastic claims must be seed-reduced by the caller to "
            "bit-exact or tolerance before dispatch")
    if exactness_class is ExactnessClass.BIT_EXACT:
        if recomputed_digest is None or committed_digest is None:
            raise ValueError("bit-exact requires both digests")
        return compare_bit_exact(recomputed_digest, committed_digest)
    if recomputed_value is None or reference_value is None:
        raise ValueError("tolerance requires both values")
    return compare_tolerance(recomputed_value, reference_value,
                             rtol=rtol, atol=atol)


def verify_lane_metric(lane: dict, metric: str, recomputed: float, *,
                       exactness: str = "tolerance", rtol: float = 1e-6,
                       atol: float = 0.0) -> Verdict:
    """Check one recomputed metric against a committed evidence lane.

    ``lane`` is an entry from a ``utils.evidence.write_report`` JSON;
    the committed value is ``lane['metrics'][metric]``.  Missing metric
    → unverifiable (the claim was never committed, not a drift).
    """
    committed = lane.get("metrics", {}).get(metric)
    if committed is None:
        return Verdict(ReproVerdict.UNVERIFIABLE,
                       f"metric {metric!r} absent from committed lane")
    klass = parse_exactness_class(exactness)
    if klass is ExactnessClass.BIT_EXACT:
        return reproduce(klass, recomputed_digest=value_digest(recomputed),
                         committed_digest=value_digest(committed))
    return reproduce(klass, recomputed_value=recomputed,
                     reference_value=committed, rtol=rtol, atol=atol)
