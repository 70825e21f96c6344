"""The control of the comparison, and the readings that its limit is set from.

    python -m tgbench.control --workload poisson96.assembled \\
        --seeds 101,102,...,112 --control-seeds 201,202,203 --ops 8

The control is the reference put in the program's place and computed in
float32, the precision below the configuration's float64: the same
systems (``compare.Checker`` built in float32) solved by the textbook
Jacobi-preconditioned method of ``reference/krylov/<method>.py`` with the
configuration's stopping rule, as the operation's reference side drives
it (``reference/operations/<operation>.py``: a θ step warm-started at the
state before it).  Its answers have to fail the
comparison.  In one process, at the cell's own size, the command reads
the program's ``residual_over_target`` over the first ``--ops`` operations
of each of ``--seeds`` (the lower reading) and the control's over those of
each of ``--control-seeds`` (the upper reading), and prints one JSON line.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .compare import Checker
from .generator import Draws
from .plugins import load
from .program import Outcome, Program
from .run import ROOT, load_cell

__all__ = ["Float32Reference", "readings"]


class Float32Reference:
    """The reference in the program's place, in float32."""

    def __init__(self, root, config, traffic, points, cells, device):
        self.ref = Checker(config, traffic, points, cells, device, dtype=torch.float32)
        s = config["solver"]
        self.solve = load("reference/krylov", s["method"]).solve
        self.stop = {"tol": s["tol"], "atol": s["atol"], "maxiter": s["maxiter"]}

    def _solve(self, op, b, x0=None):
        free = self.ref.free

        def apply(x):
            return free * op.apply(free * x) + (1 - free) * x

        inv_diag = 1.0 / (free * op.diagonal() + (1 - free))
        return self.solve(apply, b, inv_diag, x0, **self.stop)

    def run(self, x) -> Outcome:
        return Outcome(*self.ref.operation.control(self._solve, x))

    def warm(self, x) -> None:
        pass


def readings(impl, checker: Checker, spec: dict, seed: int, points, cells, device,
             ops: int) -> tuple[list, list]:
    """``residual_over_target`` of every answer of the first ``ops``
    operations of ``seed``, and their Krylov iterations."""
    draws = Draws(spec, seed, points, cells, device)
    out, iters = [], []
    for i in range(ops):
        x = draws.input(i)
        outcome = impl.run(x)
        out.extend(checker.readings(x, outcome.out))
        iters.append(sum(outcome.iters))
    return out, iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--ops", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tgbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    mesh = cell.config["mesh"]
    points, cells = load("reference/meshes", mesh["generator"]).generate(mesh["n"])
    checker = Checker(cell.config, cell.traffic, points, cells, "cuda")
    row = {"workload": args.workload, "kind": torch.cuda.get_device_name(0), "ops": args.ops,
           "program": {}, "control": {}}
    for key, seeds, cls in (("program", args.seeds, Program),
                            ("control", args.control_seeds, Float32Reference)):
        if not seeds:
            continue
        t = time.perf_counter()
        impl = cls(ROOT, cell.config, cell.traffic, points, cells, "cuda")
        for seed in (int(s) for s in seeds.split(",")):
            values, iters = readings(impl, checker, cell.traffic["input"], seed, points,
                                     cells, "cuda", args.ops)
            row[key][str(seed)] = {"worst": max(values, key=lambda r: (r != r, r)),
                                   "iters": iters}
        row[key + "_wall_s"] = time.perf_counter() - t
        del impl
        torch.cuda.empty_cache()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
