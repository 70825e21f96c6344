"""Krylov iterations a solve (``SolveInfo.iters``), the mean over every
solve of the window."""


def read(run):
    solves = [n for op in run.iters for n in op]
    return sum(solves) / len(solves) if solves else None
