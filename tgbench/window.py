"""What a run records of its measured window, whatever loop drives it.

A loop (``loops/<loop>.py``, the mix's ``loop``) issues the operations and
hands each outcome to ``Window.record`` with its wall: the host seconds
from when the operation was due, its input drawn and on the device, to its
answer synchronised.  The harness's own work (drawing inputs, keeping the
sample) lies outside every wall.  The window records the walls, the Krylov
iterations, the solves that did not converge, a sample of the answers
drawn from the seed and kept on the host, and with ``--trace 1`` a
profiler trace of the operations ``traced``.
"""

from __future__ import annotations

import contextlib
import random
import time

import torch

from . import tracing

__all__ = ["Window"]


class Window:
    def __init__(self, seconds: float, seed: int, sample: int, traced: range, telemetry):
        self.seconds, self.traced, self.telemetry = seconds, traced, telemetry
        self.walls, self.iters, self.unconverged = [], [], 0
        self.kept = []            # (operation index, answer), the sample
        self._sample, self._rng = sample, random.Random(seed)
        self.prof = self._stretch = None
        self.t_start = None

    def start(self) -> None:
        self.t_start = time.perf_counter()

    def open(self, i: int) -> bool:
        """Whether operation ``i`` starts: inside ``seconds``, or traced."""
        return (time.perf_counter() - self.t_start < self.seconds
                or (bool(self.traced) and i <= self.traced[-1]))

    def record(self, i: int, outcome, wall: float) -> None:
        self.walls.append(wall)
        self.iters.append(outcome.iters)
        self.unconverged += sum(not c for c in outcome.converged)
        slot = len(self.kept) if len(self.kept) < self._sample else self._rng.randrange(i + 1)
        if slot < self._sample:
            # a traced operation's answer leaves the device once the trace closes
            answer = outcome.out if self.tracing else outcome.out.cpu()
            if slot == len(self.kept):
                self.kept.append((i, answer))
            else:
                self.kept[slot] = (i, answer)

    def op(self):
        """The range around one operation in the trace (none untraced)."""
        if self.tracing:
            return torch.profiler.record_function(tracing.OP)
        return contextlib.nullcontext()

    @property
    def tracing(self) -> bool:
        return self.prof is not None and self._stretch is not None

    def begin_trace(self) -> None:
        self.telemetry.enable()
        self.prof = tracing.open_trace()
        self._stretch = torch.profiler.record_function(tracing.STRETCH)
        self._stretch.__enter__()

    def end_trace(self) -> None:
        self._stretch.__exit__(None, None, None)
        self._stretch = None
        self.prof.stop()
        self.telemetry.disable()
        self.kept = [(k, a.cpu()) for k, a in self.kept]
