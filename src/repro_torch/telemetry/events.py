"""Structured runtime events and the convergence policy.

The torch port of ``repro.telemetry.events``.  An *event* is a host-side
record emitted at an eager boundary (a solve returning, an assembly
producing a CSR, a profile capture finishing).  Events are appended to a
bounded in-memory log, folded into the metrics registry, and streamed to
the configured JSON-lines file in the ``BENCH_JSON`` row format
(``{"name", "us_per_call", "derived", ...extras}``).  An event recorded
under an open span carries that span's ``trace_id`` and ``span_id``.

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

from . import metrics, spans

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


def _derived(fields: dict) -> str:
    return ";".join(f"{k}={v}" for k, v in fields.items() if v is not None)


def record_event(kind: str, name: str, *, wall_us: float | None = None, **fields):
    """Record one structured event.  Returns the event dict, or ``None``
    when telemetry is disabled or a field cannot be read on the host."""
    if not metrics.is_enabled():
        return None
    clean: dict = {}
    for k, v in fields.items():
        c = metrics.concrete_or_none(v)
        if c is None and v is not None:
            return None  # an unreadable value: skip the whole event
        if isinstance(c, np.ndarray):
            c = c.tolist()
        if isinstance(c, np.generic):
            c = c.item()
        clean[k] = c
    wall = metrics.concrete_or_none(wall_us)
    ev = {"kind": kind, "name": name, "t": time.time(), **clean}
    if wall is not None:
        ev["wall_us"] = round(float(wall), 1)
    # an event recorded under an open span inherits its trace identity, so
    # per-request timelines include their solve events
    sp = spans.current_span()
    if sp is not None and sp is not spans.NULL_SPAN:
        ev["trace_id"] = sp.trace_id
        ev["span_id"] = sp.span_id
    with _EVENTS_LOCK:
        if len(_EVENTS) < _EVENT_LIMIT:
            _EVENTS.append(ev)
    metrics.counter_inc("events", 1, kind=kind)
    if metrics.jsonl_path():
        row = {
            "name": f"{kind}/{name}",
            "us_per_call": ev.get("wall_us", 0.0),
            "derived": _derived(clean),
            "kind": kind,
            **clean,
        }
        if "trace_id" in ev:
            row["trace_id"] = ev["trace_id"]
            row["span_id"] = ev["span_id"]
        metrics.append_jsonl_row(row)
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
    ``"raise"`` (:class:`NonConvergedError`), or ``"ignore"``.  Returns
    the summary dict."""
    s = _summarize_info(info)
    if s["converged"]:
        return s
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
    return s


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
