"""The 95th percentile (nearest rank) of the window's per-solve walls, each
from when the solve was due (its input drawn and on the device) to a
synchronised u; the traced solves left out.  A per-layer metric: across processes the
tail spreads too widely for an end-to-end bound (PERF.md §2)."""

import math


def read(run):
    walls = sorted(w for k, w in enumerate(run.walls_s) if k not in run.traced)
    if run.steps_per_op != 1 or not walls:
        return None
    return 1e3 * walls[math.ceil(0.95 * len(walls)) - 1]
