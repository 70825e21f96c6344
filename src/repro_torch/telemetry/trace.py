"""Named-phase profiler tracing.

:class:`annotate` names a phase (``tg.map``, ``tg.reduce``, ``tg.solve.cg``)
on the host timeline of a ``torch.profiler`` trace through
``torch.profiler.record_function``, and on CUDA also as an NVTX range.  It
records only while telemetry is enabled: when off, entering it costs one
boolean check.  :func:`span` is the request-tracing hook of the JAX
package; request tracing is not ported yet, so it is a no-op.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from . import metrics

__all__ = ["annotate", "span"]


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


def span(name: str, **tags):
    """Request-tracing span: a no-op context in this port."""
    return contextlib.nullcontext()
