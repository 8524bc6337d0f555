"""Studio capability contract (studio/verbs.py:28-183 parity)."""

import json

import pytest

from scpn_fusion_tpu.ui.studio_verbs import (
    EVIDENCE_SCHEMAS, FUSION_VERBS, Verb, capability_block,
)


def test_eight_verbs_cover_the_reference_spine():
    names = [v.name for v in FUSION_VERBS]
    assert names == ["reconstruct", "simulate", "analyse", "validate",
                     "benchmark", "replay", "control", "predict"]


def test_no_live_hardware_and_research_only():
    for v in FUSION_VERBS:
        assert v.safety_tier == "research"
        assert v.side_effect in ("read-only", "simulated")


def test_control_declares_realtime_deadline():
    control = next(v for v in FUSION_VERBS if v.name == "control")
    assert control.timing_class == "realtime"
    assert control.deadline_us == 100.0   # the 10 kHz loop period


def test_every_schema_produced_by_some_verb():
    produced = {s for v in FUSION_VERBS for s in v.produces}
    assert produced == set(EVIDENCE_SCHEMAS)


def test_attribute_validation_fail_closed():
    with pytest.raises(ValueError, match="safety tier"):
        Verb("x", "read-only", "batch", "analytic",
             ("studio.evidence-replay.v1",), ("python",),
             safety_tier="live-hardware")
    with pytest.raises(ValueError, match="undeclared evidence"):
        Verb("x", "read-only", "batch", "analytic",
             ("studio.bogus.v1",), ("python",))
    with pytest.raises(ValueError, match="deadline"):
        Verb("x", "read-only", "realtime", "analytic",
             ("studio.evidence-replay.v1",), ("python",))
    with pytest.raises(ValueError, match="backends"):
        Verb("x", "read-only", "batch", "analytic",
             ("studio.evidence-replay.v1",), ("rust",))


def test_capability_block_json_serialisable():
    block = capability_block()
    s = json.dumps(block, sort_keys=True)
    assert "scpn-fusion-tpu" in s
    assert len(block["verbs"]) == 8


def test_manifest_carries_capabilities(tmp_path):
    from scpn_fusion_tpu.ui.html_dashboard import emit_studio_manifest
    out = emit_studio_manifest(".", tmp_path / "m.json")
    m = json.loads(out.read_text())
    assert m["capabilities"]["studio_id"] == "scpn-fusion-tpu"
    assert len(m["capabilities"]["verbs"]) == 8
    assert m["n_entries"] > 0


def test_device_tier_is_the_gpu():
    from scpn_fusion_tpu.ui.studio_verbs import BACKENDS
    assert BACKENDS == {"gpu-xla", "cpp-native", "python"}
    compute = [v for v in FUSION_VERBS if v.name != "validate"
               and v.name != "replay"]
    assert all("gpu-xla" in v.backends for v in compute)


@pytest.mark.parametrize("tier", ["julia", "go"])
def test_unlisted_tiers_are_rejected(tier):
    with pytest.raises(ValueError, match="backends"):
        Verb("x", "read-only", "batch", "analytic",
             ("studio.evidence-replay.v1",), (tier,))
