"""Strict OMAS free-boundary input extraction (fail-closed contract).

JAX-native port of the reference's
``io/omas_free_boundary_inputs.py:42-598`` semantics: a bounded adapter
that reads a dotted-path ODS-like mapping into typed PF-coil / magnetic-
probe / flux-loop inputs for the predictive free-boundary solver.  It
deliberately does NOT interpolate channels, invent uncertainties, or
infer provenance; strict mode fails closed until every declared channel
requirement is present.

The extracted inputs bridge directly into this framework's shape-control
machinery: ``coils_for_solver`` yields the (r, z, turns) arrays the
``CoilSet``/``probe_response_matrix`` lane consumes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any, Mapping

import numpy as np

OMAS_FB_SCHEMA = "scpn-fusion-tpu.omas-free-boundary-inputs.v1"
CANONICAL_COCOS = frozenset((*range(1, 9), *range(11, 19)))
_SHA256_RE = re.compile(r"^[0-9a-f]{64}$")
_MAX_COLLECTION = 10_000


class OmasInputError(ValueError):
    """Fail-closed extraction error."""


def _get(ods: Any, path: str, default: Any = None) -> Any:
    """Dotted-path read from an ODS-like object or plain nested dict."""
    if hasattr(ods, "get") and not isinstance(ods, Mapping):
        return ods.get(path, default)
    node: Any = ods
    for part in path.split("."):
        if isinstance(node, Mapping) and part in node:
            node = node[part]
        else:
            return default
    return node


def _required(ods: Any, path: str) -> Any:
    value = _get(ods, path, None)
    if value is None:
        raise OmasInputError(f"missing required ODS path: {path}")
    return value


def _finite_scalar(value: Any, path: str) -> float:
    try:
        out = float(value)
    except (TypeError, ValueError) as exc:
        raise OmasInputError(f"{path} must be a scalar: {exc}") from exc
    if not np.isfinite(out):
        raise OmasInputError(f"{path} must be finite")
    return out


def _finite_vector(value: Any, path: str) -> tuple[float, ...]:
    arr = np.asarray(value, dtype=float).ravel()
    if arr.size == 0:
        raise OmasInputError(f"{path} must be non-empty")
    if arr.size > _MAX_COLLECTION:
        raise OmasInputError(f"{path} exceeds the collection bound")
    if not np.all(np.isfinite(arr)):
        raise OmasInputError(f"{path} must be finite")
    return tuple(float(v) for v in arr)


@dataclasses.dataclass(frozen=True)
class OmasProvenance:
    """External binding an ODS alone cannot prove (reference :50-85)."""

    machine: str
    shot_id: int
    run_id: int
    source_uri: str
    source_sha256: str
    license_id: str

    def __post_init__(self) -> None:
        if not self.machine.strip():
            raise OmasInputError("provenance machine must be non-empty")
        if self.shot_id < 0 or self.run_id < 0:
            raise OmasInputError("shot/run ids must be non-negative")
        if not self.source_uri.strip():
            raise OmasInputError("source_uri must be non-empty")
        if not _SHA256_RE.match(self.source_sha256):
            raise OmasInputError("source_sha256 must be 64 lowercase hex")
        if not self.license_id.strip():
            raise OmasInputError("license_id must be non-empty")


@dataclasses.dataclass(frozen=True)
class TimeSeriesSI:
    """One measured channel: (time [s], data [SI])."""

    time_s: tuple[float, ...]
    data: tuple[float, ...]
    units: str

    def __post_init__(self) -> None:
        if len(self.time_s) != len(self.data):
            raise OmasInputError("time/data length mismatch")
        t = np.asarray(self.time_s)
        if t.size >= 2 and not np.all(np.diff(t) > 0):
            raise OmasInputError("time base must be strictly increasing")


@dataclasses.dataclass(frozen=True)
class PfElementGeometry:
    r_m: float
    z_m: float
    width_m: float
    height_m: float
    turns: float

    def __post_init__(self) -> None:
        if self.r_m <= 0:
            raise OmasInputError("pf element r must be > 0")
        if self.width_m <= 0 or self.height_m <= 0:
            raise OmasInputError("pf element extent must be > 0")


@dataclasses.dataclass(frozen=True)
class PfCoilInput:
    name: str
    elements: tuple[PfElementGeometry, ...]
    current: TimeSeriesSI

    def __post_init__(self) -> None:
        if not self.elements:
            raise OmasInputError(f"coil {self.name!r} has no elements")


@dataclasses.dataclass(frozen=True)
class PoloidalFieldProbeInput:
    name: str
    r_m: float
    z_m: float
    poloidal_angle_rad: float
    field: TimeSeriesSI


@dataclasses.dataclass(frozen=True)
class FluxLoopInput:
    name: str
    r_m: float
    z_m: float
    flux: TimeSeriesSI


@dataclasses.dataclass(frozen=True)
class OmasFreeBoundaryInputs:
    """The full validated input bundle + content hash."""

    schema: str
    provenance: OmasProvenance
    cocos: int
    pf_coils: tuple[PfCoilInput, ...]
    bpol_probes: tuple[PoloidalFieldProbeInput, ...]
    flux_loops: tuple[FluxLoopInput, ...]

    def content_sha256(self) -> str:
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()

    def coils_for_solver(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(r, z, turns) arrays over all coil elements — the CoilSet /
        probe-response geometry this framework's shape-control lane uses."""
        r, z, turns = [], [], []
        for coil in self.pf_coils:
            for el in coil.elements:
                r.append(el.r_m)
                z.append(el.z_m)
                turns.append(el.turns)
        return (np.asarray(r), np.asarray(z), np.asarray(turns))

    def probe_points(self) -> np.ndarray:
        return np.asarray([[p.r_m, p.z_m] for p in self.bpol_probes])

    def flux_loop_points(self) -> np.ndarray:
        return np.asarray([[f.r_m, f.z_m] for f in self.flux_loops])


def _series(ods: Any, prefix: str, units: str) -> TimeSeriesSI:
    time = _finite_vector(_required(ods, f"{prefix}.time"), f"{prefix}.time")
    data = _finite_vector(_required(ods, f"{prefix}.data"), f"{prefix}.data")
    return TimeSeriesSI(time_s=time, data=data, units=units)


def _count(ods: Any, path: str) -> int:
    n = _get(ods, path, None)
    if n is None:
        raise OmasInputError(f"missing collection count: {path}")
    n = int(n)
    if n < 0 or n > _MAX_COLLECTION:
        raise OmasInputError(f"{path} out of range: {n}")
    return n


def extract_free_boundary_inputs(
    ods: Any,
    provenance: OmasProvenance,
    *,
    require_ingestion_ready: bool = True,
) -> OmasFreeBoundaryInputs:
    """Extract + validate the free-boundary input bundle from an ODS.

    Strict mode (default) fails closed on any missing channel; with
    ``require_ingestion_ready=False`` coils are still mandatory but the
    magnetics collections may be empty (development inspection lane,
    reference semantics).
    """
    cocos = int(_finite_scalar(
        _required(ods, "dataset_description.cocos"),
        "dataset_description.cocos"))
    if cocos not in CANONICAL_COCOS:
        raise OmasInputError(f"non-canonical COCOS: {cocos}")

    coils = []
    n_coil = _count(ods, "pf_active.n_coil")
    for i in range(n_coil):
        base = f"pf_active.coil.{i}"
        n_el = _count(ods, f"{base}.n_element")
        elements = []
        for j in range(n_el):
            eb = f"{base}.element.{j}.geometry.rectangle"
            elements.append(PfElementGeometry(
                r_m=_finite_scalar(_required(ods, f"{eb}.r"), f"{eb}.r"),
                z_m=_finite_scalar(_required(ods, f"{eb}.z"), f"{eb}.z"),
                width_m=_finite_scalar(_required(ods, f"{eb}.width"),
                                       f"{eb}.width"),
                height_m=_finite_scalar(_required(ods, f"{eb}.height"),
                                        f"{eb}.height"),
                turns=_finite_scalar(
                    _get(ods, f"{base}.element.{j}.turns_with_sign", 1.0),
                    f"{base}.turns")))
        coils.append(PfCoilInput(
            name=str(_get(ods, f"{base}.name", f"coil_{i}")),
            elements=tuple(elements),
            current=_series(ods, f"{base}.current", "A")))
    if not coils:
        raise OmasInputError("no PF coils in ODS (pf_active.n_coil == 0)")

    probes: list[PoloidalFieldProbeInput] = []
    loops: list[FluxLoopInput] = []
    try:
        n_probe = _count(ods, "magnetics.n_bpol_probe")
        for i in range(n_probe):
            base = f"magnetics.bpol_probe.{i}"
            probes.append(PoloidalFieldProbeInput(
                name=str(_get(ods, f"{base}.name", f"bpol_{i}")),
                r_m=_finite_scalar(_required(ods, f"{base}.position.r"),
                                   f"{base}.position.r"),
                z_m=_finite_scalar(_required(ods, f"{base}.position.z"),
                                   f"{base}.position.z"),
                poloidal_angle_rad=_finite_scalar(
                    _get(ods, f"{base}.poloidal_angle", 0.0),
                    f"{base}.poloidal_angle"),
                field=_series(ods, f"{base}.field", "T")))
        n_loop = _count(ods, "magnetics.n_flux_loop")
        for i in range(n_loop):
            base = f"magnetics.flux_loop.{i}"
            loops.append(FluxLoopInput(
                name=str(_get(ods, f"{base}.name", f"loop_{i}")),
                r_m=_finite_scalar(_required(ods, f"{base}.position.r"),
                                   f"{base}.position.r"),
                z_m=_finite_scalar(_required(ods, f"{base}.position.z"),
                                   f"{base}.position.z"),
                flux=_series(ods, f"{base}.flux", "Wb")))
    except OmasInputError:
        if require_ingestion_ready:
            raise
        probes, loops = [], []

    if require_ingestion_ready and (not probes or not loops):
        raise OmasInputError(
            "strict mode requires non-empty bpol probes AND flux loops "
            "(blocked != pass)")

    return OmasFreeBoundaryInputs(
        schema=OMAS_FB_SCHEMA,
        provenance=provenance,
        cocos=cocos,
        pf_coils=tuple(coils),
        bpol_probes=tuple(probes),
        flux_loops=tuple(loops))
