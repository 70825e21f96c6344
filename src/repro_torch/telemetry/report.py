"""Render a telemetry run (JSONL events + metrics) as markdown tables.

    PYTHONPATH=src python -m repro_torch.telemetry.report telemetry_events.jsonl

The torch port of ``repro.telemetry.report``: the same tables from the same
rows.  Reads the JSON-lines stream written by an enabled telemetry session
(``telemetry.enable(jsonl=...)`` + ``telemetry.export_jsonl()``) and prints
one table per row family (solves, assemblies, spans, SLOs, counters/gauges,
histograms).  With ``--snapshot`` it renders the **current process**
registry instead — useful at the end of an instrumented script.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from . import metrics, slo


def load_rows(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _fmt(x, spec: str = "") -> str:
    if x is None:
        return "—"
    if isinstance(x, float):
        return format(x, spec or ".4g")
    return str(x)


def solve_table(rows: list[dict]) -> str:
    out = [
        "| solve | n | iters (Σ/max) | final residual | converged | wall |",
        "|---|---|---|---|---|---|",
    ]
    groups: dict[str, list[dict]] = defaultdict(list)
    for r in rows:
        if r.get("kind") == "solve":
            groups[r["name"]].append(r)
    for name, rs in groups.items():
        iters = [r.get("iterations", 0) for r in rs]
        res = [r.get("final_residual") for r in rs if r.get("final_residual") is not None]
        conv = all(r.get("converged", False) for r in rs)
        walls = [r["us_per_call"] for r in rs if r.get("us_per_call")]
        wall = f"{sum(walls) / len(walls):.0f}µs" if walls else "—"
        out.append(
            f"| {name} | {len(rs)} | {sum(iters)}/{max(iters) if iters else 0} "
            f"| {_fmt(max(res) if res else None, '.2e')} "
            f"| {'✓' if conv else '**✗**'} | {wall} |"
        )
    return "\n".join(out)


def assembly_table(rows: list[dict]) -> str:
    out = [
        "| assembly | n | dofs | nnz | cells | form |",
        "|---|---|---|---|---|---|",
    ]
    groups: dict[tuple, list[dict]] = defaultdict(list)
    for r in rows:
        if r.get("kind") == "assembly":
            groups[(r["name"], r.get("form"))].append(r)
    for (name, form), rs in groups.items():
        r0 = rs[-1]
        out.append(
            f"| {name} | {len(rs)} | {_fmt(r0.get('num_dofs'))} "
            f"| {_fmt(r0.get('nnz'))} | {_fmt(r0.get('num_cells'))} "
            f"| {form or '—'} |"
        )
    return "\n".join(out)


def metric_table(rows: list[dict]) -> str:
    out = ["| metric | value |", "|---|---|"]
    for r in rows:
        if r.get("kind") == "metric" and r.get("metric") in ("counter", "gauge"):
            out.append(f"| {r['name'].removeprefix('metric/')} | {_fmt(r.get('value'))} |")
    return "\n".join(out)


def histogram_table(rows: list[dict]) -> str:
    out = [
        "| histogram | count | mean | p50 | p90 | p99 | max |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("kind") == "metric" and r.get("metric") == "histogram":
            out.append(
                f"| {r['name'].removeprefix('metric/histogram/')} "
                f"| {_fmt(r.get('count'))} | {_fmt(r.get('mean'))} "
                f"| {_fmt(r.get('p50'))} | {_fmt(r.get('p90'))} "
                f"| {_fmt(r.get('p99'))} | {_fmt(r.get('max'))} |"
            )
    return "\n".join(out)


def span_table(rows: list[dict]) -> str:
    """Per-span-name timing summary plus the number of distinct traces —
    the aggregate view of a spans-instrumented run (use the raw ``span/``
    rows' ``trace_id`` to reassemble one request's timeline)."""
    out = [
        "| span | n | traces | mean | max |",
        "|---|---|---|---|---|",
    ]
    groups: dict[str, list[dict]] = defaultdict(list)
    for r in rows:
        if r.get("kind") == "span":
            groups[r["name"].removeprefix("span/")].append(r)
    for name, rs in groups.items():
        walls = [r["us_per_call"] for r in rs]
        traces = len({r.get("trace_id") for r in rs})
        out.append(
            f"| {name} | {len(rs)} | {traces} "
            f"| {sum(walls) / len(walls):.0f}µs | {max(walls):.0f}µs |"
        )
    return "\n".join(out)


def slo_table(rows: list[dict]) -> str:
    """Objective attainment / burn-rate view of ``kind="slo"`` rows (a
    repeated objective keeps its latest row)."""
    out = [
        "| SLO | objective p99 | observed p99 | n | attainment | burn rate | status |",
        "|---|---|---|---|---|---|---|",
    ]
    latest: dict[str, dict] = {}
    for r in rows:
        if r.get("kind") == "slo":
            latest[r["name"]] = r
    for name, r in latest.items():
        status = "✓ met" if r.get("met") else "**✗ BURNING**"
        out.append(
            f"| {name.removeprefix('slo/')} "
            f"| {_fmt(r.get('objective_us'), '.0f')}µs "
            f"| {_fmt(r.get('p99_us'), '.0f')}µs | {_fmt(r.get('count'))} "
            f"| {_fmt(r.get('attainment'), '.4f')} "
            f"| {_fmt(r.get('burn_rate'), '.2f')} | {status} |"
        )
    if len(out) == 2:
        out.append("| (no SLO rows) | — | — | — | — | — | — |")
    return "\n".join(out)


def render(rows: list[dict]) -> str:
    parts = []
    kinds = {r.get("kind") for r in rows}
    if "solve" in kinds:
        parts += ["### Solves\n", solve_table(rows), ""]
    if "assembly" in kinds:
        parts += ["### Assemblies\n", assembly_table(rows), ""]
    if "span" in kinds:
        parts += ["### Spans\n", span_table(rows), ""]
    if "slo" in kinds:
        parts += ["### SLOs\n", slo_table(rows), ""]
    if any(r.get("metric") in ("counter", "gauge") for r in rows):
        parts += ["### Counters & gauges\n", metric_table(rows), ""]
    if any(r.get("metric") == "histogram" for r in rows):
        parts += ["### Histograms\n", histogram_table(rows), ""]
    other = [r for r in rows
             if r.get("kind") not in ("solve", "assembly", "metric", "span",
                                      "slo", "flight", "flight_dump")]
    if other:
        parts.append("### Other events\n")
        for r in other:
            parts.append(f"- `{r.get('name', '?')}` {r.get('derived', '')}")
        parts.append("")
    if not parts:
        parts = ["(no telemetry rows)"]
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", nargs="?", default="telemetry_events.jsonl",
                    help="JSON-lines event file (default: %(default)s)")
    ap.add_argument("--snapshot", action="store_true",
                    help="render the current in-process metrics registry "
                         "instead of reading a file")
    ap.add_argument("--slo", action="store_true",
                    help="render only the SLO attainment / burn-rate table "
                         "(from kind=\"slo\" rows, or the live objectives "
                         "with --snapshot)")
    args = ap.parse_args(argv)
    if args.snapshot:
        rows = slo.slo_rows() if args.slo else metrics.metric_rows()
    else:
        try:
            rows = load_rows(args.path)
        except FileNotFoundError:
            print(f"no such file: {args.path} (run with telemetry.enable"
                  f"(jsonl=...) to produce one, or use --snapshot)",
                  file=sys.stderr)
            return 2
    if args.slo:
        print("### SLOs\n")
        print(slo_table(rows))
        return 0
    print(render(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
