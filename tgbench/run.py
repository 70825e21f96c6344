"""One run of one benchmark cell, from the root of a checkout:

    python -m tgbench.run --workload poisson96.assembled --seed 7 --seconds 40 --trace 0

Set-up (imports, the CUDA context, the port's kernels built or loaded from
``build/kernels``, the benchmark's mesh arrays, the problem and one warm
operation of the cell's own shapes), then the mix's loop of whole
operations for ``--seconds`` (``loops/<loop>.py``), then the reference's
check of a sample of the window's answers drawn from the seed.  The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error.  ``--trace 1`` profiles a stretch of
whole operations inside the window and reports the cell's per-layer
metrics instead of its end-to-end ones.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded where the result is printed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
TRACE_FROM = 1  # the traced stretch starts at the window's second operation


def loaded_forbidden() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(root: Path, workload: str) -> Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic mix,
    limits and the metrics it reports."""
    from .plugins import data

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(workload, w["chips"], config, data("traffic", w["traffic"]),
                data("limits", workload), mine(bench["end_to_end"]), mine(bench["per_layer"]))


def run_cell(root: Path, cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0: float | None = None, mesh_n: int | None = None,
             program_cls=None) -> tuple[dict, list]:
    """Run ``cell`` once; returns the result line and the stderr lines.
    ``mesh_n`` and ``program_cls`` exist for the CPU tests, which run the
    cell at a small size or with a broken program in the port's place."""
    import torch

    from . import compare, tracing
    from .generator import WARMUP, Draws
    from .plugins import load
    from .program import Program, import_port
    from .readout import Run, reader
    from .window import Window
    from .work.peaks import peaks

    t0 = T0 if t0 is None else t0
    config, traffic = cell.config, cell.traffic
    is_cuda = torch.device(device).type == "cuda"
    import_port(root)
    from repro_torch import kernels, telemetry

    telemetry.disable()
    if is_cuda:
        torch.cuda.init()
        kernels.build()
    mesh = config["mesh"]
    points, cells = load("reference/meshes", mesh["generator"]).generate(mesh_n or mesh["n"])
    draws = Draws(traffic["input"], seed, points, cells, device)

    def sync():
        if is_cuda:
            torch.cuda.synchronize()

    t_plan = time.perf_counter()
    program = (program_cls or Program)(root, config, traffic, points, cells, device)
    program.warm(draws.input(0, WARMUP))
    sync()
    plan_build_s = time.perf_counter() - t_plan
    # the set-up's garbage (reference cycles that may hold device memory) goes
    # before the window, and later collections pass over what the set-up left
    gc.collect()
    gc.freeze()

    traced = range(TRACE_FROM, TRACE_FROM + traffic["trace_ops"]) if trace else range(0)
    window = Window(seconds, seed, traffic["check_sample"], traced, telemetry)
    load("loops", traffic["loop"]).run(window, program, draws, sync)

    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    del program
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    name = torch.cuda.get_device_name(0) if is_cuda else "cpu"
    cls = load("reference/problems", config["problem"]["class"])
    run = Run(config, traffic, cls.sizes(points, cells) if trace else None,
              peaks(name) if trace else None,
              setup_s=window.t_start - t0, plan_build_s=plan_build_s, walls_s=window.walls,
              iters=window.iters, steps_per_op=len(window.iters[0]), peak_bytes=peak)
    if trace:
        run.trace = tracing.Trace.from_profiler(window.prof)
        run.traced = traced

    # the reference's check of the sample, the program's state freed
    checker = compare.Checker(config, traffic, points, cells, device)
    limit = cell.limits[compare.NUMBER]
    readings = []
    for k, out in sorted(window.kept, key=lambda kv: kv[0]):
        readings.extend(checker.readings(draws.input(k), out))
    over = sum(not (r <= limit) for r in readings)
    worst = max(readings, key=lambda r: (r != r, r), default=float("nan"))
    unconverged = window.unconverged
    attempted = run.ops * run.steps_per_op
    correct = bool(readings) and over == 0 and unconverged == 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader("metrics" if trace else "e2e", m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu", "kind": name, "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": over + unconverged,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["compared"] = {
        compare.NUMBER: {"value": worst if worst == worst else None, "limit": limit},
        "unconverged": {"value": unconverged, "limit": 0},
    }
    lines = [f"checked {len(readings)} answers of {attempted} ({len(window.kept)} operations "
             f"drawn from the seed)",
             f"compared {compare.NUMBER} {worst!r} limit {limit!r}",
             f"compared unconverged {unconverged} limit 0"]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"tgbench: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, lines = run_cell(ROOT, cell, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"tgbench: the run loaded forbidden modules: {found}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
