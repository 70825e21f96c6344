"""Render dryrun/perf JSON into markdown tables (a copy of
``repro.analysis.report``: the same tables from the same rows).

    PYTHONPATH=src python -m repro_torch.analysis.report dryrun_results_torch.json
"""

from __future__ import annotations

import json
import sys


def _fmt_t(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}µs"
    if x < 0.1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(rows: list[dict], mesh: str) -> str:
    out = [
        f"| arch | shape | t_compute | t_memory | t_collective | bottleneck "
        f"| useful FLOPs | roofline frac | HBM/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skip":
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | *skip* "
                f"| — | — | {r['reason'][:46]} |"
            )
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | | | | | | |")
            continue
        ma = r.get("memory_analysis", {})
        hbm = ma.get("temp_GiB", 0) + ma.get("arg_GiB", 0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_t(r['t_compute_s'])} "
            f"| {_fmt_t(r['t_memory_s'])} | {_fmt_t(r['t_collective_s'])} "
            f"| **{r['bottleneck']}** | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {hbm:.1f} GiB |"
        )
    return "\n".join(out)


def collective_summary(rows: list[dict], mesh: str) -> str:
    out = ["| arch | shape | AG | AR | RS | A2A | CP |", "|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        bk = r["collectives"]["by_kind"]
        g = lambda k: f"{bk.get(k, 0)/2**30:.1f}G" if bk.get(k, 0) else "—"
        out.append(
            f"| {r['arch']} | {r['shape']} | {g('all-gather')} | {g('all-reduce')} "
            f"| {g('reduce-scatter')} | {g('all-to-all')} | {g('collective-permute')} |"
        )
    return "\n".join(out)


def perf_table(rows: list[dict]) -> str:
    out = [
        "| arch | shape | variant | t_compute | t_memory | t_collective "
        "| bottleneck | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r.get('variant','?')} | FAIL: "
                f"{r.get('error','')[:60]} | | | | |"
            )
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r.get('variant','baseline')} "
            f"| {_fmt_t(r['t_compute_s'])} | {_fmt_t(r['t_memory_s'])} "
            f"| {_fmt_t(r['t_collective_s'])} | {r['bottleneck']} "
            f"| {r['roofline_fraction']:.4f} |"
        )
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results_torch.json"
    rows = json.load(open(path))
    if rows and "variant" in rows[0]:
        print(perf_table(rows))
        return
    for mesh in ("16x16", "2x16x16"):
        print(f"\n### Mesh {mesh}\n")
        print(roofline_table(rows, mesh))
        print(f"\n#### Collective bytes/chip ({mesh})\n")
        print(collective_summary(rows, mesh))


if __name__ == "__main__":
    main()
