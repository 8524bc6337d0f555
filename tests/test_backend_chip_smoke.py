"""The backend module and ``chip_smoke.py``'s phases, at tiny sizes on the
CPU (the card run is ``python chip_smoke.py``)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import chip_smoke
from scpn_fusion_tpu.core import backend

REPO = Path(__file__).resolve().parents[1]


def test_require_gpu_raises_without_gpu():
    assert jax.devices()[0].platform != "gpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.require_gpu()


def test_device_info_reports_jax_devices():
    info = backend.device_info()
    devices = jax.devices()
    assert info == (devices[0].platform, devices[0].device_kind, len(devices))
    assert info.as_dict() == {"platform": devices[0].platform,
                              "kind": devices[0].device_kind,
                              "count": len(devices)}


def _fake_devices(n):
    return [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")] * n


def test_require_gpu_accepts_gpu_devices(monkeypatch):
    monkeypatch.setattr(backend.jax, "devices", lambda: _fake_devices(4))
    assert backend.require_gpu(4) == ("gpu", "NVIDIA H100", 4)


def test_require_gpu_checks_the_count(monkeypatch):
    monkeypatch.setattr(backend.jax, "devices", lambda: _fake_devices(1))
    with pytest.raises(RuntimeError, match="needs 4 GPUs"):
        backend.require_gpu(4)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache_dir() == tmp_path


def test_compile_cache_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.compile_cache_dir()
    assert path == REPO / ".jax_cache"
    assert path == backend.compile_cache_dir()
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache_sets_dir_only_without_env(
        monkeypatch, tmp_path, env_set):
    updates = {}
    monkeypatch.setattr(backend.jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.enable_compile_cache()
    if env_set:
        assert path == tmp_path
        assert "jax_compilation_cache_dir" not in updates
    else:
        assert updates["jax_compilation_cache_dir"] == str(
            REPO / ".jax_cache")


# ── chip_smoke: gates and phases at tiny sizes ─────────────────────────


def test_span_dev():
    ref = np.array([[0.0, 2.0], [4.0, 8.0]])
    assert chip_smoke.span_dev(ref + 0.08, ref) == pytest.approx(0.01)


def _res(iters, psi, converged=True):
    return SimpleNamespace(iterations=iters, psi=np.asarray(psi),
                           converged=converged)


def test_compare_f64_same_iterations_uses_f64_gate():
    ref = np.linspace(0.0, 1.0, 16).reshape(4, 4)
    ok = chip_smoke.compare_f64("x", _res(7, ref + 1e-12), _res(7, ref), 1e-3)
    bad = chip_smoke.compare_f64("x", _res(7, ref + 1e-6), _res(7, ref), 1e-3)
    assert ok["ok"] and ok["tol"] == chip_smoke.F64_TOL
    assert not bad["ok"]


def test_compare_f64_moved_iteration_uses_tolerance_scale():
    ref = np.linspace(0.0, 1.0, 16).reshape(4, 4)
    one = chip_smoke.compare_f64("x", _res(8, ref + 1e-6), _res(7, ref), 1e-3)
    two = chip_smoke.compare_f64("x", _res(9, ref + 1e-6), _res(7, ref), 1e-3)
    assert one["ok"] and one["tol"] == 1e-3 and "moved" in one["note"]
    assert not two["ok"]


def test_phase_iter_tiny():
    records = chip_smoke.phase_iter(33)
    assert [r["check"] for r in records] == ["iter_f64_gpu_vs_cpu",
                                             "iter_f32_vs_f64",
                                             "iter_f32_forced_tf32"]
    assert all(r["ok"] for r in records), records


def test_phase_fmg_tiny():
    records = chip_smoke.phase_fmg(65, min_coarse=33)
    assert all(r["ok"] for r in records), records


def test_phase_free_boundary_tiny():
    records = chip_smoke.phase_free_boundary(33, batch=2)
    assert all(r["ok"] for r in records), records
    assert len(records[1]["iterations"]) == 2


def test_phase_large_tiny():
    records = chip_smoke.phase_large(65, min_coarse=33)
    assert all(r["ok"] for r in records), records
    assert records[0]["dev"] < chip_smoke.GS_TOL_LARGE


def test_phase_gk_tiny():
    records = chip_smoke.phase_gk((4, 4, 4, 4, 2), calls=2)
    assert all(r["ok"] for r in records), records
    assert records[1]["iterations"] == 4


def test_run_phase_reports_a_raising_phase_as_failed(capsys):
    clock = SimpleNamespace(total=0.0)

    def boom():
        raise ValueError("bad shape")

    assert not chip_smoke.run_phase("p", boom, clock)
    assert "bad shape" in capsys.readouterr().out


def test_main_fails_without_gpu(capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "card_lines", lambda: ["fake, 700 W"])
    monkeypatch.setattr(chip_smoke, "card_tests", lambda: True)
    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
