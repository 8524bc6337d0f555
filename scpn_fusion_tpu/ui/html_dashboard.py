"""Self-contained HTML evidence dashboard (studio-equivalent, no server).

Role-parity with the reference's Streamlit app + studio manifest
(``ui/app.py:71``, ``studio/federation.py:292-383``): streamlit does not
ship in this image, so the UI lane renders the same evidence — campaign
statuses, headline bench, accuracy bars, committed-artifact metrics — as
ONE static HTML file (inline SVG, zero dependencies, works from
``file://``) plus a checksummed studio manifest JSON.

Visualisation follows the bundled data-viz method: single-hue marks for
magnitude, status colors only for pass/blocked/fail chips (always with
text, never color alone), 24px-max bars with 4px rounded data ends and
2px surface gaps, hairline grid, direct labels, hover tooltips, and a
light/dark scheme from the pre-validated reference palette (values used
verbatim from its documented instance).
"""

from __future__ import annotations

import hashlib
import html
import json
from pathlib import Path
from typing import Any

_CSS = """
:root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f2f1ec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e3e2dc; --series-1: #2a78d6;
  --status-good: #008300; --status-serious: #e34948;
  --status-warning: #eda100;
}
@media (prefers-color-scheme: dark) {
  :root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242422;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #3a3936; --series-1: #3987e5;
    --status-good: #00a300; --status-serious: #e66767;
    --status-warning: #c98500;
  }
}
* { box-sizing: border-box; }
body { background: var(--surface-1); color: var(--text-primary);
  font: 14px/1.5 system-ui, sans-serif; margin: 0 auto; max-width: 1080px;
  padding: 24px; }
h1 { font-size: 22px; margin: 0 0 4px; }
h2 { font-size: 16px; margin: 28px 0 8px; }
.sub { color: var(--text-secondary); margin: 0 0 20px; }
.kpis { display: flex; flex-wrap: wrap; gap: 12px; }
.tile { background: var(--surface-2); border-radius: 8px; padding: 12px 16px;
  min-width: 150px; flex: 1; }
.tile .v { font-size: 32px; font-weight: 650; }
.tile .hero { font-size: 48px; }
.tile .l { color: var(--text-secondary); font-size: 12px; }
table { border-collapse: collapse; width: 100%; }
th, td { text-align: left; padding: 6px 10px;
  border-bottom: 1px solid var(--grid); }
th { color: var(--text-secondary); font-weight: 500; font-size: 12px; }
.chip { border-radius: 10px; padding: 1px 8px; font-size: 12px;
  color: #fff; display: inline-block; }
.chip.pass { background: var(--status-good); }
.chip.blocked { background: var(--status-warning); }
.chip.fail { background: var(--status-serious); }
.bar-row:hover rect.bar { opacity: 0.8; }
svg text { fill: var(--text-primary); font: 12px system-ui, sans-serif; }
svg text.axis { fill: var(--text-secondary); font-size: 11px; }
svg line.grid { stroke: var(--grid); stroke-width: 1; }
svg line.gate { stroke: var(--status-serious); stroke-width: 1; }
rect.bar { fill: var(--series-1); }
"""


def _load_reports(reports_dir: Path) -> list[dict[str, Any]]:
    out = []
    for path in sorted(reports_dir.glob("*.json")):
        try:
            out.append(json.loads(path.read_text()))
        except (OSError, json.JSONDecodeError):
            continue
    return out


def _chip(status: str) -> str:
    status = html.escape(status)
    return f'<span class="chip {status}">{status}</span>'


def _bar_chart_svg(rows: list[tuple[str, float]], gate: float,
                   title: str, unit: str) -> str:
    """Horizontal single-hue bar chart with a gate reference line.

    Mark spec: bars <= 24px, 4px rounded DATA end (square baseline via a
    squared underlay), 2px surface gaps, hairline grid, direct labels.
    """
    if not rows:
        return ""
    width, label_w, pad = 720, 150, 14
    bar_h, gap = 22, 2
    chart_h = len(rows) * (bar_h + gap + 8) + 40
    vmax = max(max(v for _, v in rows), gate) * 1.15
    plot_w = width - label_w - 90

    def x(v: float) -> float:
        return label_w + plot_w * v / vmax

    parts = [f'<svg viewBox="0 0 {width} {chart_h}" role="img" '
             f'aria-label="{html.escape(title)}">']
    # Hairline grid at quarter intervals.
    for frac in (0.25, 0.5, 0.75, 1.0):
        gx = label_w + plot_w * frac
        parts.append(f'<line class="grid" x1="{gx:.1f}" y1="8" '
                     f'x2="{gx:.1f}" y2="{chart_h - 26}"/>')
        parts.append(f'<text class="axis" x="{gx:.1f}" '
                     f'y="{chart_h - 12}" text-anchor="middle">'
                     f'{vmax * frac:.3g}</text>')
    y = 10.0
    for name, value in rows:
        bw = max(x(value) - label_w, 2.0)
        label = html.escape(name)
        parts.append('<g class="bar-row">')
        parts.append(f'<title>{label}: {value:.4g} {unit} '
                     f'(gate {gate:g})</title>')
        parts.append(f'<text x="{label_w - 8}" y="{y + bar_h - 6}" '
                     f'text-anchor="end">{label}</text>')
        # Rounded data end, square baseline: squared underlay half-bar.
        parts.append(f'<rect class="bar" x="{label_w}" y="{y}" '
                     f'width="{bw:.1f}" height="{bar_h}" rx="4"/>')
        if bw > 8:
            parts.append(f'<rect class="bar" x="{label_w}" y="{y}" '
                         f'width="4" height="{bar_h}"/>')
        parts.append(f'<text class="axis" x="{x(value) + 6:.1f}" '
                     f'y="{y + bar_h - 6}">{value:.3g}</text>')
        parts.append('</g>')
        y += bar_h + gap + 8
    gx = x(gate)
    parts.append(f'<line class="gate" x1="{gx:.1f}" y1="6" '
                 f'x2="{gx:.1f}" y2="{chart_h - 26}"/>')
    parts.append(f'<text class="axis" x="{gx + 4:.1f}" y="16">gate '
                 f'{gate:g}</text>')
    parts.append("</svg>")
    return "".join(parts)


def generate_html_dashboard(
    repo_root: str | Path = ".",
    out_path: str | Path = "DASHBOARD.html",
) -> Path:
    """Render the evidence dashboard; returns the written path."""
    repo = Path(repo_root)
    reports = _load_reports(repo / "validation" / "reports")

    statuses = [r.get("overall_status", "fail") for r in reports]
    n_pass = sum(s == "pass" for s in statuses)
    n_blocked = sum(s == "blocked" for s in statuses)
    n_fail = len(statuses) - n_pass - n_blocked

    # Headline bench (driver artifact, newest round available).
    bench_value = bench_speedup = None
    for name in sorted(repo.glob("BENCH_r*.json"), reverse=True):
        try:
            payload = json.loads(name.read_text())
            bench_value = payload.get("value")
            bench_speedup = payload.get("vs_baseline")
            break
        except (OSError, json.JSONDecodeError):
            continue

    # SPARC accuracy rows from the real-shot report.
    sparc_rows: list[tuple[str, float]] = []
    for rep in reports:
        for lane in rep.get("lanes", []):
            if lane.get("name") == "sparc_strict_nrmse":
                for key, value in sorted(lane.get("metrics", {}).items()):
                    if key.endswith(".nrmse") and isinstance(
                            value, (int, float)):
                        sparc_rows.append((key.split(".")[0],
                                           float(value)))

    # Committed surrogate artifacts.
    artifacts = []
    for metrics_path in sorted((repo / "weights").glob("*.metrics.json")):
        try:
            m = json.loads(metrics_path.read_text())
            artifacts.append((m.get("artifact", metrics_path.stem),
                              m.get("test_rel_l2"), m.get("sha256", "")[:12]))
        except (OSError, json.JSONDecodeError):
            continue

    rows_html = []
    for rep in reports:
        lanes = rep.get("lanes", [])
        lane_bits = ", ".join(
            f'{html.escape(lane.get("name", "?"))} '
            f'{_chip(lane.get("status", "fail"))}' for lane in lanes)
        rows_html.append(
            f"<tr><td>{html.escape(str(rep.get('campaign', '?')))}</td>"
            f"<td>{_chip(rep.get('overall_status', 'fail'))}</td>"
            f"<td>{html.escape(str(rep.get('git_sha', ''))[:9])}</td>"
            f"<td>{lane_bits}</td></tr>")

    art_html = "".join(
        f"<tr><td>{html.escape(str(name))}</td>"
        f"<td>{rel:.4g}</td><td><code>{html.escape(sha)}…</code></td></tr>"
        for name, rel, sha in artifacts if rel is not None)

    hero = (f'<div class="tile"><div class="v hero">{bench_value:g} ms'
            f'</div><div class="l">513² converged GS solve (bench.py; '
            f'{bench_speedup:g}× the NumPy twin)</div>'
            '</div>') if bench_value is not None else ""

    chart = _bar_chart_svg(sparc_rows, 0.05,
                           "SPARC reconstruction NRMSE per file",
                           "NRMSE")

    page = f"""<!doctype html><html lang="en"><head>
<meta charset="utf-8"><meta name="viewport" content="width=device-width">
<meta http-equiv="Content-Security-Policy" content="default-src 'none'; \
base-uri 'none'; object-src 'none'; img-src data:; \
style-src 'unsafe-inline'">
<meta name="referrer" content="no-referrer">
<title>scpn_fusion_tpu evidence dashboard</title>
<style>{_CSS}</style></head><body>
<h1>scpn_fusion_tpu — evidence dashboard</h1>
<p class="sub">Static studio view over validation/reports, the driver
bench artifact, and committed surrogate weights. Regenerate with
<code>python -m scpn_fusion_tpu.ui.html_dashboard</code>.</p>
<div class="kpis">{hero}
<div class="tile"><div class="v">{n_pass}</div>
<div class="l">campaigns passing</div></div>
<div class="tile"><div class="v">{n_blocked}</div>
<div class="l">blocked (honest: blocked ≠ pass)</div></div>
<div class="tile"><div class="v">{n_fail}</div>
<div class="l">failing</div></div>
</div>
<h2>SPARC GEQDSK reconstruction accuracy</h2>
<p class="sub">Full measured-external-source re-solve per public EFIT
file; the red line is the reference's own 5% NRMSE gate.</p>
{chart}
<h2>Validation campaigns</h2>
<table><tr><th>Campaign</th><th>Status</th><th>Git</th><th>Lanes</th></tr>
{''.join(rows_html)}</table>
<h2>Committed surrogate artifacts</h2>
<table><tr><th>Artifact</th><th>Held-out rel-L2</th><th>SHA-256</th></tr>
{art_html}</table>
</body></html>"""

    out = Path(out_path)
    out.write_text(page, encoding="utf-8")
    return out


def emit_studio_manifest(
    repo_root: str | Path = ".",
    out_path: str | Path = "studio_manifest.json",
) -> Path:
    """Checksummed federation manifest over reports + artifacts
    (reference ``studio/federation.py:292-383`` role)."""
    repo = Path(repo_root)
    entries = []
    for pattern, kind in (("validation/reports/*.json", "report"),
                          ("weights/*.npz", "weights"),
                          ("weights/*.metrics.json", "metrics"),
                          ("BENCH_r*.json", "bench")):
        for path in sorted(repo.glob(pattern)):
            entries.append({
                "path": str(path.relative_to(repo)),
                "kind": kind,
                "bytes": path.stat().st_size,
                "sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
            })
    from scpn_fusion_tpu.ui.studio_verbs import capability_block
    manifest = {
        "schema": "scpn-fusion-tpu.studio-manifest.v1",
        "capabilities": capability_block(),
        "n_entries": len(entries),
        "entries": entries,
    }
    payload = json.dumps(manifest, indent=1, sort_keys=True)
    manifest["manifest_sha256"] = hashlib.sha256(
        payload.encode()).hexdigest()
    out = Path(out_path)
    out.write_text(json.dumps(manifest, indent=1, sort_keys=True))
    return out


if __name__ == "__main__":
    print(generate_html_dashboard())
    print(emit_studio_manifest())
