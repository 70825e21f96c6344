"""Host time a Krylov iteration of the port's ``cg`` / ``bicgstab`` costs,
at a size where the arithmetic is small beside the loop's own Python: a
1-D Laplacian of 256 rows on the ``csr`` backend with Jacobi, each solve
run for exactly 100 (CG) or 60 (BiCGSTAB) iterations (tolerances 0).
``--mode`` sets what is recorded: ``off`` (telemetry off, as the untraced
benchmark runs), ``telemetry`` (telemetry on, no profiler: the serve
tier's mode) or ``traced`` (telemetry on and a ``torch.profiler`` of host
and, on CUDA, device activity around each solve, as a traced benchmark
run).  With ``--device cuda`` the loop is all host time: the device's
share of an iteration is a few µs.

Given a second tree, it compares the two (the ``src`` directories of two
checkouts, say a parent commit and a change) in one process: the second
tree's package is loaded under another name, and the two solve in turn,
the order alternating pair by pair, so that the machine's drift falls on
both sides alike.  Prints the median and quartiles of µs an iteration of
each side and of the pairwise differences::

    python tools/krylov_host_cost.py src ../parent/src --pairs 400 --mode off
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time


def _load(src: str, alias: str):
    """``repro_torch`` of the tree ``src``, imported under ``alias``."""
    pkg = os.path.join(src, "repro_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(f"{alias}.core")
    return mod


ITERS = {"cg": 100, "bicgstab": 60}


def _solver(pkg, method: str, mode: str, device: str, n: int = 256):
    """A closure that runs one solve and returns its µs an iteration."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    core = pkg.core
    rows = np.repeat(np.arange(n), 3)[1:-1]
    cols = (rows + np.tile([-1, 0, 1], n)[1:-1]).astype(np.int64)
    vals = np.where(rows == cols, 2.0, -1.0)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    a = core.CSR.from_arrays(torch.as_tensor(vals, device=device), indptr, cols, (n, n))
    b = torch.ones(n, dtype=torch.float64, device=device)
    solve = {"cg": core.cg, "bicgstab": core.bicgstab}[method]
    m = core.jacobi_preconditioner(a)
    tel = pkg.telemetry
    iters = ITERS[method]

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])

    def run() -> float:
        (tel.disable if mode == "off" else tel.enable)()
        prof = torch.profiler.profile(activities=activities) if mode == "traced" else None
        if prof is not None:
            prof.start()
        t = time.perf_counter()
        _, info = solve(a.matvec, b, tol=0.0, atol=0.0, maxiter=iters, m=m)
        dt = time.perf_counter() - t
        if prof is not None:
            prof.stop()
        if info.iters != iters:
            raise SystemExit(f"the solve stopped after {info.iters} of {iters} iterations")
        return 1e6 * dt / iters

    run()  # warm
    return run


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"q1": q[0], "median": statistics.median(xs), "q3": q[2]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="the src directory to import repro_torch from")
    ap.add_argument("against", nargs="?", help="a second src directory, compared in pairs")
    ap.add_argument("--pairs", type=int, default=400)
    ap.add_argument("--method", choices=tuple(ITERS), default="cg")
    ap.add_argument("--mode", choices=("off", "telemetry", "traced"), default="off")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    opts = (args.method, args.mode, args.device)
    sides = {args.src: _solver(_load(args.src, "repro_torch"), *opts)}
    if args.against is not None:
        sides[args.against] = _solver(_load(args.against, "repro_torch_against"), *opts)
    runs = {src: [] for src in sides}
    order = list(sides)
    for k in range(args.pairs):
        for src in (order if k % 2 == 0 else order[::-1]):
            runs[src].append(sides[src]())
    out = {"method": args.method, "iters": ITERS[args.method], "mode": args.mode,
           "device": args.device, "pairs": args.pairs,
           "us_per_iter": {src: _quartiles(v) for src, v in runs.items()}}
    if args.against is not None:
        out["difference"] = _quartiles([a - b for a, b in zip(*runs.values())])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
