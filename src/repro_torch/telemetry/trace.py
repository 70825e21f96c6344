"""Named-phase profiler tracing.

:class:`annotate` names a phase (``tg.map``, ``tg.reduce``, ``tg.solve.cg``)
on the host timeline of a ``torch.profiler`` trace through
``torch.profiler.record_function``, and on CUDA also as an NVTX range.  It
records only while telemetry is enabled: when off, entering it costs one
boolean check.

:func:`capture` records a ``torch.profiler`` trace of a block and writes it
as Chrome/Perfetto JSON (the counterpart of the reference's
``jax.profiler.trace``): the host ops, the phases named by
:class:`annotate` and, on a CUDA machine, every kernel the block launched.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

from . import events, metrics

__all__ = ["annotate", "capture"]


class annotate:
    """Name a phase: context manager *and* decorator."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        if not metrics.is_enabled():
            return self
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(self.name):
                return fn(*args, **kwargs)

        return wrapped


@contextlib.contextmanager
def capture(path: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into the
    directory ``path``, as ``trace_<ns>.json`` (Chrome trace format: load it
    in Perfetto or ``chrome://tracing``)::

        with telemetry.capture("/tmp/tg_profile"):
            u = prob.solve(backend="matfree")

    Device activity is recorded when CUDA is available.  Emits a
    ``trace_captured`` telemetry event when recording is enabled."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(path, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    file = os.path.join(path, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(file)
    events.record_event("profile", "trace_captured", path=path, file=file)
