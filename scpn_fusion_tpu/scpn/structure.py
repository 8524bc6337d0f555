"""Stochastic Petri net builder DSL.

Host-side construction layer with the same builder surface as the reference
(``scpn/structure.py:36-528``): places with token densities in [0, 1],
transitions with thresholds and integer tick delays, Place->Transition input
arcs (optionally inhibitor, stored as negative weights) and
Transition->Place output arcs.  ``compile()`` produces dense incidence
matrices — this framework feeds them straight to the jitted controller
runtime (``scpn/controller.py``), where a dense matvec as one matmul replaces
the reference's sparse matrices + packed uint64 bitstream path.

Topology diagnostics (dead transitions/places, unseeded source places) are
computed at compile time; Monte-Carlo boundedness/liveness verification runs
the compiled float dynamics (``verify_boundedness`` / ``verify_liveness``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class CompiledNet:
    """Dense compiled Petri net (the controller-runtime input contract)."""

    n_places: int
    n_transitions: int
    place_names: List[str]
    transition_names: List[str]
    w_in: np.ndarray          # (nT, nP) — place -> transition input weights
    w_out: np.ndarray         # (nP, nT) — transition -> place output weights
    thresholds: np.ndarray    # (nT,)
    delays: np.ndarray        # (nT,) int32 tick delays
    initial_marking: np.ndarray  # (nP,)

    def place_index(self, name: str) -> int:
        return self.place_names.index(name)

    def transition_index(self, name: str) -> int:
        return self.transition_names.index(name)


class StochasticPetriNet:
    """Petri-net builder: places / transitions / arcs -> incidence matrices."""

    def __init__(self) -> None:
        self._places: List[str] = []
        self._tokens: List[float] = []
        self._transitions: List[str] = []
        self._thresholds: List[float] = []
        self._delays: List[int] = []
        self._kind: Dict[str, str] = {}
        self._arcs: List[Tuple[str, str, float]] = []
        self._compiled: CompiledNet | None = None

    # ── builder API ──────────────────────────────────────────────────

    def add_place(self, name: str, initial_tokens: float = 0.0) -> None:
        if name in self._kind:
            raise ValueError(f"Node '{name}' already exists.")
        if not 0.0 <= initial_tokens <= 1.0:
            raise ValueError(f"initial_tokens must be in [0, 1], got {initial_tokens}")
        self._places.append(name)
        self._tokens.append(float(initial_tokens))
        self._kind[name] = "place"
        self._compiled = None

    def add_transition(self, name: str, threshold: float = 0.5,
                       delay_ticks: int = 0) -> None:
        if name in self._kind:
            raise ValueError(f"Node '{name}' already exists.")
        if threshold < 0.0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        if delay_ticks < 0:
            raise ValueError(f"delay_ticks must be >= 0, got {delay_ticks}")
        self._transitions.append(name)
        self._thresholds.append(float(threshold))
        self._delays.append(int(delay_ticks))
        self._kind[name] = "transition"
        self._compiled = None

    def add_arc(self, source: str, target: str, weight: float = 1.0,
                inhibitor: bool = False) -> None:
        for node in (source, target):
            if node not in self._kind:
                raise ValueError(f"Unknown node '{node}'.")
        sk, tk = self._kind[source], self._kind[target]
        if sk == tk:
            raise ValueError(
                f"Arc must connect Place<->Transition, got {sk}->{tk} "
                f"('{source}'->'{target}').")
        if inhibitor:
            if not (sk == "place" and tk == "transition"):
                raise ValueError("inhibitor arcs are only supported for Place->Transition.")
            if weight <= 0.0:
                raise ValueError(f"inhibitor arc weight must be > 0 (magnitude), got {weight}")
            stored = -abs(float(weight))
        else:
            if weight <= 0.0:
                raise ValueError(f"weight must be > 0, got {weight}")
            stored = float(weight)
        self._arcs.append((source, target, stored))
        self._compiled = None

    # ── compile ──────────────────────────────────────────────────────

    def compile(self, validate_topology: bool = False,
                strict_validation: bool = False) -> CompiledNet:
        n_p, n_t = len(self._places), len(self._transitions)
        if n_p == 0 or n_t == 0:
            raise ValueError("Net must contain at least one place and one transition.")
        p_idx = {n: i for i, n in enumerate(self._places)}
        t_idx = {n: i for i, n in enumerate(self._transitions)}

        w_in = np.zeros((n_t, n_p))
        w_out = np.zeros((n_p, n_t))
        for src, tgt, w in self._arcs:
            if self._kind[src] == "place":
                w_in[t_idx[tgt], p_idx[src]] += w
            else:
                w_out[p_idx[tgt], t_idx[src]] += w

        net = CompiledNet(
            n_places=n_p, n_transitions=n_t,
            place_names=list(self._places),
            transition_names=list(self._transitions),
            w_in=w_in, w_out=w_out,
            thresholds=np.asarray(self._thresholds),
            delays=np.asarray(self._delays, dtype=np.int32),
            initial_marking=np.asarray(self._tokens),
        )
        if validate_topology or strict_validation:
            report = self.topology_report(net)
            if strict_validation and (report["dead_transitions"]
                                      or report["dead_places"]):
                raise ValueError(f"Topology validation failed: {report}")
        self._compiled = net
        return net

    @staticmethod
    def topology_report(net: CompiledNet) -> dict:
        """Dead-node diagnostics (reference ``compile`` validation path)."""
        in_deg_t = (np.abs(net.w_in) > 0).sum(axis=1)
        out_deg_t = (np.abs(net.w_out) > 0).sum(axis=0)
        touched_p = ((np.abs(net.w_in) > 0).sum(axis=0)
                     + (np.abs(net.w_out) > 0).sum(axis=1))
        return {
            "dead_transitions": [net.transition_names[i] for i in range(net.n_transitions)
                                 if in_deg_t[i] == 0 and out_deg_t[i] == 0],
            "dead_places": [net.place_names[i] for i in range(net.n_places)
                            if touched_p[i] == 0],
        }

    # ── Monte-Carlo verification (reference :433-528) ────────────────

    def verify_boundedness(self, n_steps: int = 200, n_trials: int = 16,
                           seed: int = 0, bound: float = 3.0) -> dict:
        """Monte-Carlo boundedness: markings must stay below ``bound``
        under random exogenous injection with the RAW (un-clipped) firing
        dynamics — a place that only accumulates (no consumer) grows
        linearly and fails; conservative nets see at most a one-firing
        transient above 1 (reference ``structure.py:433`` contract)."""
        net = self._compiled or self.compile()
        rng = np.random.default_rng(seed)
        max_token = 0.0
        for _ in range(n_trials):
            m = net.initial_marking.copy()
            for _ in range(n_steps):
                m_in = np.maximum(m + 0.1 * rng.random(net.n_places), 0.0)
                a = net.w_in @ m_in
                f = (a >= net.thresholds).astype(float)
                m = np.maximum(m_in - net.w_in.T @ f + net.w_out @ f, 0.0)
                max_token = max(max_token, float(np.max(m)))
        return {"bounded": max_token <= bound, "max_token": max_token,
                "bound": bound}

    def verify_liveness(self, n_steps: int = 200, n_trials: int = 16,
                        seed: int = 0) -> dict:
        """Check every transition fires at least once under random drive."""
        net = self._compiled or self.compile()
        rng = np.random.default_rng(seed)
        fired_ever = np.zeros(net.n_transitions, dtype=bool)
        for _ in range(n_trials):
            m = net.initial_marking.copy()
            for _ in range(n_steps):
                m_in = np.clip(m + 0.3 * rng.random(net.n_places), 0.0, 1.0)
                a = net.w_in @ m_in
                f = (a >= net.thresholds).astype(float)
                fired_ever |= f > 0
                m = np.clip(m_in - net.w_in.T @ f + net.w_out @ f, 0.0, 1.0)
        dead = [net.transition_names[i] for i in range(net.n_transitions)
                if not fired_ever[i]]
        return {"live": not dead, "dead_transitions": dead}
