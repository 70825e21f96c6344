"""Structured runtime events and the convergence policy.

The torch port of ``repro.telemetry.events``, cut to what the solver path
calls.  An *event* is a host-side record emitted at an eager boundary (a
solve returning, an assembly producing a CSR); it goes to a bounded
in-memory log and is folded into the metrics registry.

:func:`check_convergence` is the host-side guard that turns a ``maxiter``
exit into a :class:`ConvergenceWarning` (default) or
:class:`NonConvergedError` — it works with telemetry disabled, because a
wrong answer should never need a flag to be reported.
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np

from . import metrics

__all__ = [
    "ConvergenceWarning",
    "NonConvergedError",
    "record_event",
    "record_solve",
    "record_assembly",
    "check_convergence",
    "event_log",
    "clear_events",
]

_EVENTS: list[dict] = []
_EVENT_LIMIT = 65536
_EVENTS_LOCK = threading.Lock()


class ConvergenceWarning(UserWarning):
    """A Krylov solve exited at ``maxiter`` without reaching tolerance."""


class NonConvergedError(RuntimeError):
    """Raised (under the ``on_nonconverged="raise"`` policy) when a solve
    reports ``converged=False``."""


def event_log() -> list[dict]:
    """The in-memory event list (bounded; newest last)."""
    with _EVENTS_LOCK:
        return list(_EVENTS)


def clear_events() -> None:
    with _EVENTS_LOCK:
        _EVENTS.clear()


def record_event(kind: str, name: str, *, wall_us: float | None = None, **fields):
    """Record one structured event; returns it, or ``None`` when telemetry
    is disabled."""
    if not metrics.is_enabled():
        return None
    ev = {"kind": kind, "name": name, "t": time.time(),
          **{k: metrics.concrete_or_none(v) for k, v in fields.items()}}
    if wall_us is not None:
        ev["wall_us"] = round(float(wall_us), 1)
    with _EVENTS_LOCK:
        if len(_EVENTS) < _EVENT_LIMIT:
            _EVENTS.append(ev)
    metrics.counter_inc("events", 1, kind=kind)
    return ev


def _summarize_info(info) -> dict:
    """Host scalars from a ``SolveInfo`` whose leaves are scalars or
    stacked per-step / per-instance host tensors: total and max iterations,
    number of solves, worst residual, all-converged."""
    it = np.asarray(info.iters)
    res = np.asarray(info.residual)
    conv = np.asarray(info.converged)
    return {
        "iterations": int(it.sum()),
        "iterations_max": int(it.max()),
        "n_solves": int(it.size),
        "final_residual": float(res.max()),
        "converged": bool(conv.all()),
    }


def check_convergence(info, where: str = "solve", on_fail: str | None = None):
    """Host-side non-convergence guard for a ``SolveInfo`` (scalar or
    stacked leaves).  If any solve has ``converged=False``, apply the
    policy: ``"warn"`` (default, a :class:`ConvergenceWarning`),
    ``"raise"`` (:class:`NonConvergedError`), or ``"ignore"``."""
    s = _summarize_info(info)
    if s["converged"]:
        return
    policy = on_fail or metrics.nonconverged_policy()
    msg = (
        f"{where}: solver did NOT converge after {s['iterations_max']} iterations "
        f"(final residual {s['final_residual']:.3e}"
        + (f", {s['n_solves']} solves" if s["n_solves"] > 1 else "")
        + ") — the returned solution does not meet tolerance"
    )
    if policy == "raise":
        raise NonConvergedError(msg)
    if policy == "warn":
        warnings.warn(msg, ConvergenceWarning, stacklevel=3)


def record_solve(name: str, info, *, method: str | None = None,
                 backend: str | None = None, precond: str | None = None,
                 phase: str = "forward", wall_us: float | None = None, **extra):
    """Record one solve event from a ``SolveInfo`` (scalar or stacked
    leaves) and fold it into the metrics (iteration histogram, optional
    wall-time histogram, solve counter).  No-op when disabled."""
    if not metrics.is_enabled():
        return None
    s = _summarize_info(info)
    labels = {"solver": method or "?", "phase": phase}
    if backend:
        labels["backend"] = backend
    if precond:
        labels["precond"] = precond
    metrics.counter_inc("solves", s["n_solves"], **labels)
    metrics.histogram_observe("solve_iterations", s["iterations"], **labels)
    if wall_us is not None:
        metrics.histogram_observe("solve_wall_us", wall_us, **labels)
    return record_event(
        "solve", name, wall_us=wall_us, method=method, backend=backend,
        precond=precond, phase=phase, **s, **extra,
    )


def record_assembly(name: str, *, num_dofs: int | None = None,
                    nnz: int | None = None, num_cells: int | None = None,
                    form: str | None = None, wall_us: float | None = None, **extra):
    """Record one assembly event (an ``assemble``/``assemble_rhs`` call
    producing a global operator or load vector)."""
    if not metrics.is_enabled():
        return None
    metrics.counter_inc("assemblies", 1, form=form or "?")
    if wall_us is not None:
        metrics.histogram_observe("assembly_wall_us", wall_us, form=form or "?")
    return record_event(
        "assembly", name, wall_us=wall_us, num_dofs=num_dofs, nnz=nnz,
        num_cells=num_cells, form=form, **extra,
    )
