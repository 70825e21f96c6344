"""What a metric's reader is handed, and how readers are found.

Each end-to-end metric has a reader ``tgbench/e2e/<name>.py`` and each
per-layer metric ``tgbench/metrics/<name>.py`` (the file named after the
metric, dots and all), with one function ``read(run)`` that returns the
value or ``None`` where the run holds nothing to read.
"""

from __future__ import annotations

import dataclasses

from .plugins import load
from .work.counts import Work, least_s
from .work.sizes import Sizes

__all__ = ["Run", "reader", "roofline_pct"]


@dataclasses.dataclass
class Run:
    """One run, as the readers see it."""

    config: dict
    traffic: dict
    sizes: Sizes
    peaks: tuple            # (bytes/s, float64 flop/s) of the card; None untraced
    setup_s: float
    plan_build_s: float
    walls_s: list           # each operation's wall, from when it was due (window.py)
    iters: list             # each operation's Krylov iterations, a list per operation
    steps_per_op: int       # solves an operation makes (a rollout's steps)
    peak_bytes: int
    trace: object = None    # tracing.Trace of the traced stretch (--trace 1)
    traced: range = range(0)  # the traced operations' indices

    @property
    def traced_iters(self) -> list:
        return [self.iters[k] for k in self.traced]

    @property
    def ops(self) -> int:
        return len(self.walls_s)

    @property
    def method(self) -> str:
        return self.config["solver"]["method"]


def roofline_pct(run: Run, work: Work, device_s: float):
    """The least time of ``work`` as a share of ``device_s`` in %, or None
    where no device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * least_s(work, *run.peaks) / device_s


def reader(kind: str, name: str):
    """The ``read`` function of ``tgbench/<kind>/<name>.py``.  A metric split
    by the end-to-end metric it moves reads as the one it was split from:
    ``read = reader("metrics", "<name it was split from>")``."""
    return load(kind, name).read
