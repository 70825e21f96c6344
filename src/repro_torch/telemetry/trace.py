"""Named-phase profiler tracing.

:class:`annotate` names a phase (``tg.map``, ``tg.reduce``, ``tg.solve.cg``)
on the host timeline of a ``torch.profiler`` trace, as a
``torch.profiler.record_function`` range does (through the binding
underneath it, which skips the operator dispatch and costs about a third),
and on CUDA also as an NVTX range.  It records only while telemetry is
enabled: when off, entering it costs one boolean check.  A range opened
with ``profiler_only=True`` records only while a profiler records too
(:func:`recording`): the solve path's per-iteration and per-solve child
ranges, which cost the loop nothing while no trace is taken.

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
    """Name a phase: context manager *and* decorator.

    The port's ranges, by layer (a child range opens inside its parent;
    those marked † are ``profiler_only``):

    * assembly — ``tg.map`` (its child ``tg.map.context``†: the element
      context an einsum Map builds from the coordinates), ``tg.reduce``,
      ``tg.facet_inject`` (facet terms only), ``tg.all_reduce`` (sharded);
    * boundary and layout — ``tg.condense``† (Dirichlet condensation of a
      matrix and its load), ``tg.ell.values``† (a CSR's values put into the
      ELL layout);
    * Krylov loop — ``tg.solve.cg`` / ``tg.solve.bicgstab`` (the loop),
      ``tg.solve.matvec``† and ``tg.solve.precond``† (each application,
      the initial residual's too), ``tg.sync``† (each device scalar read on
      the host: the stopping target, every stopping test, the final
      residual, a solve's relative residual), ``tg.solve.residual``† (a
      problem solve's fused residual after its loop);
    * matrix-free apply — ``tg.matfree.gather``, ``tg.matfree.action``,
      ``tg.matfree.scatter``, ``tg.matfree.all_reduce`` (the fused P1
      diffusion kernel gathers inside ``tg.matfree.action``, and opens no
      ``tg.matfree.gather``);
    * preconditioners and condensed solves — ``tg.precond.ebe_apply``,
      ``tg.precond.chebyshev_apply``, ``tg.elemalg.condense``,
      ``tg.elemalg.schur_apply``;
    * time stepping — ``tg.theta.step``† and its right-hand side
      ``tg.theta.rhs``†.
    """

    def __init__(self, name: str, *, profiler_only: bool = False):
        self.name = name
        self.profiler_only = profiler_only
        self._handle = None
        self._nvtx = False

    def __enter__(self):
        if not metrics.is_enabled() or (self.profiler_only
                                        and not torch.autograd._profiler_enabled()):
            return self
        self._handle = _range_enter(self.name)
        if torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        if self._handle is not None:
            handle, self._handle = self._handle, None
            _range_exit(handle)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(self.name, profiler_only=self.profiler_only):
                return fn(*args, **kwargs)

        return wrapped


def _range_enter(name: str):
    """Open a ``user_annotation`` range (the one ``record_function`` opens)."""
    return torch._C._autograd._record_function_with_args_enter(name)


def _range_exit(handle) -> None:
    torch._C._autograd._record_function_with_args_exit(handle)


def recording() -> bool:
    """True while telemetry is on and a profiler records: when a
    ``profiler_only`` range opens."""
    return metrics.is_enabled() and torch.autograd._profiler_enabled()


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
