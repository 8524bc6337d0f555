#!/usr/bin/env python
"""Full validation pipeline: run every campaign, then aggregate.

Counterpart of the reference's ``validation/full_validation_pipeline.py``
(one entry point that executes the whole evidence surface).  Discovers
every ``validation/run_*.py`` campaign, executes each in its own
interpreter with a per-campaign timeout, reads back the campaign's
checksummed report, and finishes by regenerating ``RESULTS.md`` via
``collect_results.py``.

Exit code 0 only if NO campaign fails (blocked lanes are surfaced but do
not fail the pipeline — fail-closed semantics live inside each lane).

Usage:
    python validation/run_all.py            # everything
    python validation/run_all.py --quick    # skip the slow GPU/stress set
"""

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPORTS = HERE / "reports"

# Campaigns needing the real chip or long wall-clock; skipped by --quick.
SLOW = {
    "run_stress_campaign.py",
    "run_micro_kernels.py",
    "run_batched_amortisation.py", "run_real_shot_accuracy.py",
    "run_free_boundary_forward.py", "run_resolution_scaling.py",
}
PER_CAMPAIGN_TIMEOUT_S = 3600   # resolution_scaling compiles 2049^2 programs


def _flag_value(argv: list[str], flag: str) -> float | None:
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return float(argv[i + 1])
        if a.startswith(flag + "="):
            return float(a.split("=", 1)[1])
    return None


def _head_sha() -> str:
    out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                         capture_output=True, text=True, cwd=HERE)
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def main() -> int:
    quick = "--quick" in sys.argv
    # --reuse-at-head: incremental evidence — a campaign whose committed
    # report already carries the CURRENT HEAD sha with a pass/blocked
    # status is counted without re-executing (same single-SHA contract;
    # the reused campaigns are listed explicitly in the summary).
    reuse = "--reuse-at-head" in sys.argv
    # --reuse-shas a,b,c: widen reuse to an EXPLICIT sha window (e.g. the
    # evidence commits of one session, where the only intervening diffs
    # are committed reports themselves).  Every reused row records which
    # sha its report carries — the window is disclosed, never implied.
    extra_shas: set[str] = set()
    for i, a in enumerate(sys.argv):
        if a == "--reuse-shas" and i + 1 < len(sys.argv):
            extra_shas = {s.strip() for s in sys.argv[i + 1].split(",")}
    # --deadline-s N: stop LAUNCHING campaigns once N seconds of wall
    # have elapsed; already-running ones finish.  Not-run campaigns are
    # listed explicitly — the summary never silently claims coverage.
    deadline_s = _flag_value(sys.argv, "--deadline-s")
    head = _head_sha()
    scripts = sorted(p for p in HERE.glob("run_*.py")
                     if p.name != "run_all.py")
    if quick:
        scripts = [p for p in scripts if p.name not in SLOW]

    rows = []
    reused: list[str] = []
    not_run: list[str] = []
    t0 = time.monotonic()
    for script in scripts:
        name = script.stem.removeprefix("run_")
        if reuse:
            report = REPORTS / f"{name}.json"
            try:
                payload = json.loads(report.read_text())
            except (OSError, json.JSONDecodeError):
                payload = {}
            sha = payload.get("git_sha")
            if (sha in ({head} | extra_shas)
                    and payload.get("overall_status") in ("pass", "blocked")):
                rows.append({
                    "campaign": name, "rc": 0, "wall_s": 0.0,
                    "overall": payload["overall_status"],
                    "lanes": {ln["name"]: ln["status"]
                              for ln in payload.get("lanes", [])},
                    "stderr_tail": [], "reused_at_head": True,
                    "reused_sha": sha})
                reused.append(name)
                print(f"[{payload['overall_status']:>7}] {name} "
                      f"(reused report at {sha})", flush=True)
                continue
        if deadline_s is not None and time.monotonic() - t0 > deadline_s:
            not_run.append(name)
            continue
        # Under a deadline, a launched campaign may not run past the
        # deadline + a 600 s grace — subprocess.run kills it on expiry,
        # so no child outlives the pipeline budget.
        cap = PER_CAMPAIGN_TIMEOUT_S
        if deadline_s is not None:
            cap = min(cap, max(60.0,
                               t0 + deadline_s + 600.0 - time.monotonic()))
        start = time.monotonic()
        try:
            proc = subprocess.run(
                [sys.executable, str(script)], capture_output=True,
                text=True, timeout=cap)
            rc = proc.returncode
            err_tail = proc.stderr.strip().splitlines()[-1:] if rc else []
        except subprocess.TimeoutExpired:
            rc, err_tail = -1, ["timeout"]
        wall = time.monotonic() - start

        report = REPORTS / f"{name}.json"
        status = "missing-report"
        lane_statuses = {}
        if report.is_file():
            try:
                payload = json.loads(report.read_text())
                status = payload.get("overall_status", "unknown")
                lane_statuses = {ln["name"]: ln["status"]
                                 for ln in payload.get("lanes", [])}
            except (json.JSONDecodeError, KeyError, TypeError):
                status = "unreadable-report"
        rows.append({"campaign": name, "rc": rc, "wall_s": round(wall, 1),
                     "overall": status, "lanes": lane_statuses,
                     "stderr_tail": err_tail})
        print(f"[{status:>7}] {name} ({wall:.0f}s)", flush=True)

    failed = [r for r in rows if r["overall"]
              not in ("pass", "blocked") or r["rc"] not in (0,)]
    summary = {
        "schema": "scpn-fusion-tpu.full-pipeline.v1",
        "quick": quick,
        "git_sha": head,
        "n_campaigns": len(rows),
        "n_failed": len(failed),
        "n_reused_at_head": len(reused),
        "reused_at_head": reused,
        "n_not_run_deadline": len(not_run),
        "not_run_deadline": not_run,
        "total_wall_s": round(time.monotonic() - t0, 1),
        "campaigns": rows,
    }
    out = REPORTS / "full_pipeline_summary.json"
    out.write_text(json.dumps(summary, indent=2) + "\n")
    print(f"wrote {out}")

    collect = subprocess.run([sys.executable,
                              str(HERE / "collect_results.py")],
                             capture_output=True, text=True)
    if collect.returncode != 0:
        print("collect_results failed:", collect.stderr[-300:])
        return 2

    if failed:
        print("FAILED campaigns:",
              ", ".join(r["campaign"] for r in failed))
        return 1
    if not_run:
        print(f"{len(rows)} campaigns pass ({len(reused)} reused at HEAD); "
              f"{len(not_run)} NOT RUN (deadline): {', '.join(not_run)}")
        return 0
    print(f"all {len(rows)} campaigns pass "
          f"({len(reused)} reused at HEAD; "
          f"{summary['total_wall_s']:.0f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
