"""Host-side span trees with propagated trace IDs + the flight recorder.

The torch port of ``repro.telemetry.spans``.  A :class:`Span` is a
lightweight host-side timing record — ``(trace_id, span_id, parent_id,
name, tags, start_ns, end_ns)`` — organized into trees: one root per traced
operation (a serve request, an instrumented driver loop), children for its
phases (queue wait, dispatch, device solve, slice).  Every span of one
request shares its ``trace_id``, so a JSONL stream from many concurrent
requests reassembles into per-request timelines.

* **disabled ⇒ zero cost** — :func:`span_root` / :func:`span` return the
  process-wide :data:`NULL_SPAN` after one boolean check; every operation
  on it is a no-op.
* **no tensors in tags** — a tag value that is a tensor is dropped, never
  stored (the reference drops tracers the same way): reading a CUDA tensor
  would synchronise the host with the device, and a span must never do
  that.

On :meth:`Span.finish` a span folds into the registry — one
``span_us{span=<name>}`` histogram observation — and, when a JSONL stream
is configured, appends one ``BENCH_JSON``-format row
(``{"name": "span/<name>", "us_per_call", "derived", "trace_id", ...}``).

The **flight recorder** is a bounded ring buffer of the last K completed
span trees plus caller context (admission key, bucket, ``SolveInfo``
summary, outcome).  The serve tier records every completed request into it
and auto-dumps the ring to JSONL on anomalies (non-convergence, deadline
expiry, shedding, failure); :func:`flight_dump` dumps it on demand.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque

import numpy as np
import torch

from . import metrics

__all__ = [
    "Span",
    "NULL_SPAN",
    "span_root",
    "span",
    "current_span",
    "push_span",
    "pop_span",
    "configure_flight",
    "flight_record",
    "flight_records",
    "flight_dump",
    "flight_autodump",
    "clear_flight",
]

_TRACE_IDS = itertools.count(1)
_SPAN_IDS = itertools.count(1)
_TLS = threading.local()  # per-thread stack of open spans


def _clean_tag(v):
    """Host value for a span tag, or ``None`` for tensors and values that
    cannot be read on the host."""
    if isinstance(v, torch.Tensor):
        return None
    c = metrics.concrete_or_none(v)
    if isinstance(c, np.ndarray):
        c = c.tolist()
    if isinstance(c, np.generic):
        c = c.item()
    return c


class Span:
    """One timed phase.  Build children with :meth:`child`; close with
    :meth:`finish` (idempotent).  All times are ``time.monotonic_ns()``
    integers — the serve tier's clock, so span walls and
    ``t_done - t_submit`` agree."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "tags",
                 "start_ns", "end_ns", "children")

    def __init__(self, name: str, *, trace_id: int | None = None,
                 parent: "Span | None" = None, start_ns: int | None = None, **tags):
        self.trace_id = next(_TRACE_IDS) if trace_id is None else trace_id
        self.span_id = next(_SPAN_IDS)
        self.parent_id = None if parent is None else parent.span_id
        self.name = name
        self.tags: dict = {}
        self.start_ns = time.monotonic_ns() if start_ns is None else int(start_ns)
        self.end_ns: int | None = None
        self.children: list[Span] = []
        if tags:
            self.tag(**tags)

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        state = "open" if self.end_ns is None else f"{self.wall_us:.1f}us"
        return (f"Span({self.name!r}, trace={self.trace_id}, id={self.span_id}, {state}, "
                f"children={len(self.children)})")

    @property
    def wall_us(self) -> float | None:
        """Closed wall time in µs (``None`` while the span is open)."""
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e3

    def tag(self, **tags) -> "Span":
        """Attach host-safe tag values (tensors are silently dropped)."""
        for k, v in tags.items():
            c = _clean_tag(v)
            if c is not None or v is None:
                self.tags[k] = c
        return self

    def child(self, name: str, *, start_ns: int | None = None, **tags) -> "Span":
        """Open a child span inheriting this span's ``trace_id``."""
        c = Span(name, trace_id=self.trace_id, parent=self, start_ns=start_ns, **tags)
        self.children.append(c)
        return c

    def finish(self, *, end_ns: int | None = None, **tags) -> "Span":
        """Close the span (idempotent): stamp ``end_ns``, fold the wall into
        the ``span_us`` histogram, and stream one JSONL row when a stream
        is configured.  Open children are closed at the same instant."""
        if tags:
            self.tag(**tags)
        if self.end_ns is not None:
            return self
        self.end_ns = time.monotonic_ns() if end_ns is None else int(end_ns)
        for c in self.children:
            if c.end_ns is None:
                c.finish(end_ns=self.end_ns)
        metrics.histogram_observe("span_us", self.wall_us, span=self.name)
        path = metrics.jsonl_path()
        if path:
            metrics.append_jsonl_row(self.to_row(), path)
        return self

    def to_dict(self) -> dict:
        """The span (sub)tree as plain dicts — what a
        :class:`~repro_torch.serve.batching.SolveResponse` carries in
        ``trace``."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "tags": dict(self.tags),
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "wall_us": None if self.wall_us is None else round(self.wall_us, 3),
            "children": [c.to_dict() for c in self.children],
        }

    def to_row(self) -> dict:
        """This span (no children) as one ``BENCH_JSON`` row."""
        wall = self.wall_us
        derived = (f"trace={self.trace_id};span={self.span_id}"
                   + (f";parent={self.parent_id}" if self.parent_id is not None else ""))
        return {
            "name": f"span/{self.name}",
            "us_per_call": 0.0 if wall is None else round(wall, 1),
            "derived": derived,
            "kind": "span",
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            **self.tags,
        }

    # -- context-manager protocol (pushes onto the thread-local stack) -----
    def __enter__(self) -> "Span":
        push_span(self)
        return self

    def __exit__(self, *exc) -> None:
        pop_span(self)
        self.finish()


class _NullSpan:
    """The disabled-telemetry span: every operation is a no-op, ``bool()``
    is ``False``, and ``to_dict()`` is ``None`` — instrumented code never
    needs its own enabled check."""

    __slots__ = ()
    trace_id = 0
    span_id = 0
    parent_id = None
    name = ""
    tags: dict = {}
    start_ns = 0
    end_ns = 0
    children: list = []
    wall_us = 0.0

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return "NULL_SPAN"

    def tag(self, **tags) -> "_NullSpan":
        return self

    def child(self, name: str, **kw) -> "_NullSpan":
        return self

    def finish(self, **kw) -> "_NullSpan":
        return self

    def to_dict(self):
        return None

    def to_row(self):
        return None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


def span_root(name: str, **tags):
    """A new root span with a fresh ``trace_id`` — or :data:`NULL_SPAN`
    when telemetry is disabled (the one boolean check)."""
    if not metrics.is_enabled():
        return NULL_SPAN
    return Span(name, **tags)


def span(name: str, **tags):
    """Context-manager span: a child of the current thread's open span (or
    a new root), pushed onto the thread-local stack for the block.  Returns
    :data:`NULL_SPAN` when disabled."""
    if not metrics.is_enabled():
        return NULL_SPAN
    parent = current_span()
    if parent is not None and parent is not NULL_SPAN:
        return parent.child(name, **tags)
    return Span(name, **tags)


def current_span():
    """The innermost open span on this thread's stack, or ``None``."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def push_span(sp) -> None:
    """Manually push a span as this thread's current context."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(sp)


def pop_span(sp) -> None:
    stack = getattr(_TLS, "stack", None)
    if stack and stack[-1] is sp:
        stack.pop()
    elif stack and sp in stack:
        stack.remove(sp)


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

_FLIGHT_LOCK = threading.Lock()
_FLIGHT_CAPACITY = 256
_FLIGHT: deque = deque(maxlen=_FLIGHT_CAPACITY)
_FLIGHT_PATH: str | None = None


def configure_flight(capacity: int | None = None, path: str | None = None) -> None:
    """Size the ring (last ``capacity`` completed records) and/or set the
    auto-dump JSONL path.  With no explicit path, anomaly auto-dumps derive
    ``<stream>.flight.jsonl`` from the configured telemetry stream (and are
    silently skipped when neither exists)."""
    global _FLIGHT, _FLIGHT_CAPACITY, _FLIGHT_PATH
    with _FLIGHT_LOCK:
        if capacity is not None:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            _FLIGHT_CAPACITY = int(capacity)
            _FLIGHT = deque(_FLIGHT, maxlen=_FLIGHT_CAPACITY)
        if path is not None:
            _FLIGHT_PATH = path


def _flight_path() -> str | None:
    if _FLIGHT_PATH:
        return _FLIGHT_PATH
    stream = metrics.jsonl_path()
    return f"{stream}.flight.jsonl" if stream else None


def flight_record(trace, **context):
    """Append one completed record (a :class:`Span` tree or ``None``) plus
    caller context to the ring.  Tensor fields are dropped, the ring is
    bounded, and it records nothing when disabled.  Returns the record
    dict (or ``None``)."""
    if not metrics.is_enabled():
        return None
    clean = {}
    for k, v in context.items():
        c = _clean_tag(v)
        if c is None and v is not None:
            continue  # a tensor or unreadable value: drop the field, keep the record
        clean[k] = c
    rec = {
        "kind": "flight",
        "t": time.time(),
        "trace": trace.to_dict() if trace else None,
        **clean,
    }
    with _FLIGHT_LOCK:
        _FLIGHT.append(rec)
    return rec


def flight_records() -> list[dict]:
    """The ring contents, oldest first."""
    with _FLIGHT_LOCK:
        return list(_FLIGHT)


def clear_flight() -> None:
    with _FLIGHT_LOCK:
        _FLIGHT.clear()


def flight_dump(path: str | None = None, *, reason: str = "manual") -> int:
    """Dump the ring to a JSONL file (one header row ``kind=flight_dump``
    then one row per record, oldest first).  ``path`` defaults to the
    configured/derived flight path.  Returns the number of records written
    (0 when there is nowhere to write or nothing recorded)."""
    recs = flight_records()
    path = path or _flight_path()
    if not path or not recs:
        return 0
    header = {
        "name": f"flight_dump/{reason}",
        "us_per_call": 0.0,
        "derived": f"records={len(recs)};reason={reason}",
        "kind": "flight_dump",
        "reason": reason,
        "records": len(recs),
        "t": time.time(),
    }
    with open(path, "a") as f:
        f.write(json.dumps(header) + "\n")
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    metrics.counter_inc("flight_dumps", 1, reason=reason)
    return len(recs)


def flight_autodump(reason: str) -> int:
    """Anomaly-triggered dump (non-convergence / deadline expiry / shed /
    failure): dump the ring to the auto path when one is configured or
    derivable.  No-op (returns 0) otherwise — the ring still holds the
    history for an on-demand :func:`flight_dump`."""
    if not metrics.is_enabled():
        return 0
    if _flight_path() is None:
        return 0
    return flight_dump(reason=reason)
