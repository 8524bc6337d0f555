"""Director oversight layer (coherence supervision of the controller).

JAX-native port of the reference's experimental
``control/director_interface.py:48-307``: the Director does NOT drive
the coils — it supervises the CONTROLLER, reviewing proposed strategy
(target) updates against a stability flag and a neural-activity entropy
score, approving safe updates and triggering corrective holds otherwise.

Redesign notes: the reference formats the system state as a text
"prompt" and regex-parses it back in the rule-based fallback; here the
review contract is STRUCTURED (a typed snapshot), which is what the
rule-based director actually consumes — the prompt round-trip added
parse hazards without information.  The external DIRECTOR_AI module is
honestly absent in this image; injection of a custom director object is
supported for parity with the reference's ``director=`` hook.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, NamedTuple

import numpy as np


class DirectorSnapshot(NamedTuple):
    """Structured system sample (replaces the reference's prompt string)."""

    stable: bool
    brain_entropy: float
    axis_error_m: float
    tick: int


@dataclasses.dataclass
class RuleBasedDirector:
    """Deterministic fallback director (reference ``_RuleBasedDirector``).

    Scores each snapshot by entropy relative to the threshold; approves
    an update only when the plant reports stable AND the rolling mean
    score over the history window stays <= 1.
    """

    entropy_threshold: float = 0.3
    history_window: int = 10

    def __post_init__(self) -> None:
        if not (math.isfinite(self.entropy_threshold)
                and self.entropy_threshold > 0.0):
            raise ValueError("entropy_threshold must be finite and > 0")
        if self.history_window < 1:
            raise ValueError("history_window must be >= 1")
        self._scores: deque[float] = deque(maxlen=self.history_window)

    def review_action(self, snapshot: DirectorSnapshot,
                      proposed_action: Any) -> tuple[bool, float]:
        del proposed_action
        score = float(np.clip(
            snapshot.brain_entropy / self.entropy_threshold, 0.0, 10.0))
        self._scores.append(score)
        rolling = float(np.mean(self._scores))
        approved = bool(snapshot.stable and rolling <= 1.0)
        return approved, score


def firing_entropy(firing: np.ndarray) -> float:
    """Normalised Shannon entropy of a firing/activity vector in [0, 1]
    (the reference's BrainEntropy signal)."""
    p = np.abs(np.asarray(firing, dtype=np.float64))
    total = p.sum()
    if total <= 0.0 or p.size < 2:
        return 0.0
    p = p / total
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -np.sum(np.where(p > 0, p * np.log(p), 0.0))
    return float(h / np.log(p.size))


class DirectorInterface:
    """Supervises a controller's strategy updates (reference :80-279).

    ``controller_step(targets, tick) -> (snapshot, proposed_targets)``
    is the supervised callable: it advances the plant+controller one
    oversight period under the CURRENT targets and proposes the next
    targets.  The director approves or blocks the proposal; blocked
    proposals trigger a corrective hold (targets frozen) — the Director
    controls the controller, never the coils.
    """

    def __init__(self, controller_step, *, director: Any | None = None,
                 entropy_threshold: float = 0.3,
                 history_window: int = 10) -> None:
        self.controller_step = controller_step
        if director is not None:
            self.director = director
            self.director_backend = "injected"
        else:
            self.director = RuleBasedDirector(
                entropy_threshold=entropy_threshold,
                history_window=history_window)
            self.director_backend = "fallback_rule_based"
        self.log: list[dict[str, float]] = []

    def run_directed_mission(self, targets0, n_periods: int = 10):
        """Run the supervised mission; returns (final_targets, log)."""
        targets = targets0
        for k in range(int(n_periods)):
            snapshot, proposed = self.controller_step(targets, k)
            approved, score = self.director.review_action(snapshot,
                                                          proposed)
            if approved:
                targets = proposed
            self.log.append({
                "tick": float(k),
                "approved": float(approved),
                "security_score": score,
                "entropy": snapshot.brain_entropy,
                "axis_error_m": snapshot.axis_error_m,
            })
        return targets, self.log

    @property
    def approval_rate(self) -> float:
        if not self.log:
            return 0.0
        return float(np.mean([e["approved"] for e in self.log]))
