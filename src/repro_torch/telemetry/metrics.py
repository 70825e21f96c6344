"""Process-global runtime metrics registry (counters / gauges / histograms).

The torch port of ``repro.telemetry.metrics``.  One registry for the whole
stack:

* **counters** — monotone totals: entry builds ("traces", see below) and
  cache lookups of the assembly core, the matrix-free operators and the
  serve tier, keyed on (plan identity, form signature, backend) via
  :func:`count_trace` / :func:`count_cache`; solve totals; matvec-backend
  selections.
* **gauges** — last-write-wins values: CSR / operator memory footprints,
  device memory (:func:`gauge_set`).
* **histograms** — distributions with summary statistics: solver iteration
  counts and host-side wall times (:func:`histogram_observe`).

**What a "trace" is in an eager port.**  The reference counts a jaxpr trace
each time ``jax.jit`` stages a function for a new signature.  The port has
no tracer: it counts one trace where it *builds* a cached per-signature
object — the first assembly or operator build of a (plan, form signature)
pair, which stages the plan's device mirrors on that path, and the building
of an executable-cache entry in the serve tier.  Value-only updates build
nothing, so "zero retraces after warmup" keeps its meaning: no entry built
after warmup.  A build compiles nothing, so traces are recorded only while
telemetry is on.

Telemetry is **off by default**: every recording entry point returns after
one boolean check.  Values are converted to host scalars
(:func:`concrete_or_none`) before they are stored, so no tensor (and no
autograd graph) is kept alive by the registry.

``snapshot()`` renders the registry as plain dicts; ``export_jsonl(path)``
appends one JSON object per metric in the ``BENCH_JSON`` row format
(``{"name", "us_per_call", "derived", ...}``), key for key as the reference
writes them.  Set ``REPRO_TELEMETRY=1`` (optionally
``REPRO_TELEMETRY_JSONL=<path>``) to enable at import time.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
from typing import Any

import numpy as np
import torch

__all__ = [
    "enable",
    "disable",
    "is_enabled",
    "enabled",
    "jsonl_path",
    "nonconverged_policy",
    "concrete_or_none",
    "counter_inc",
    "gauge_set",
    "histogram_observe",
    "count_trace",
    "count_cache",
    "jit_trace_total",
    "histogram_values",
    "snapshot",
    "reset",
    "export_jsonl",
    "append_jsonl_row",
    "register_snapshot_section",
    "register_row_provider",
]

# one observation cap per histogram key: summaries stay exact for any run
# that fits, and a runaway loop cannot grow host memory without bound
_HIST_LIMIT = 65536


class _State:
    """The process-global telemetry switchboard (thread-safe registry)."""

    def __init__(self):
        self.enabled = False
        self.jsonl: str | None = None
        self.on_nonconverged = "warn"  # "warn" | "raise" | "ignore"
        self.lock = threading.Lock()
        self.counters: dict[tuple, float] = {}
        self.gauges: dict[tuple, float] = {}
        self.hists: dict[tuple, list] = {}


_STATE = _State()

# serializes JSONL appends across threads (events, spans, metric exports all
# share one stream file) — a row is always exactly one line
_IO_LOCK = threading.Lock()

# extension hooks: sibling modules (slo, spans) register here instead of
# being imported, keeping this module dependency-free within the package
_SNAPSHOT_SECTIONS: dict[str, Any] = {}
_ROW_PROVIDERS: list = []


def register_snapshot_section(name: str, fn) -> None:
    """Add a computed section to :func:`snapshot` — ``fn()`` returning a
    dict (or ``None``/falsy to omit the section this time)."""
    _SNAPSHOT_SECTIONS[name] = fn


def register_row_provider(fn) -> None:
    """Add a ``BENCH_JSON``-row source to :func:`metric_rows` — ``fn()``
    returning a list of row dicts."""
    _ROW_PROVIDERS.append(fn)


def enable(jsonl: str | None = None, on_nonconverged: str | None = None) -> None:
    """Turn telemetry recording on.

    ``jsonl``: stream structured events and closed spans to this JSON-lines
    file as they are recorded.  ``on_nonconverged`` selects the host-side
    policy when a solve reports ``converged=False``: ``"warn"`` (default),
    ``"raise"`` or ``"ignore"``.
    """
    if on_nonconverged is not None:
        if on_nonconverged not in ("warn", "raise", "ignore"):
            raise ValueError(
                f"on_nonconverged={on_nonconverged!r}: use 'warn', 'raise' or 'ignore'"
            )
        _STATE.on_nonconverged = on_nonconverged
    if jsonl is not None:
        _STATE.jsonl = jsonl
    _STATE.enabled = True


def disable() -> None:
    """Turn recording off (the registry contents are kept — :func:`reset`
    drops them)."""
    _STATE.enabled = False


def is_enabled() -> bool:
    return _STATE.enabled


@contextlib.contextmanager
def enabled(jsonl: str | None = None, on_nonconverged: str | None = None):
    """Scoped :func:`enable`: restores the previous state on exit."""
    prev = (_STATE.enabled, _STATE.jsonl, _STATE.on_nonconverged)
    enable(jsonl=jsonl, on_nonconverged=on_nonconverged)
    try:
        yield
    finally:
        _STATE.enabled, _STATE.jsonl, _STATE.on_nonconverged = prev


def jsonl_path() -> str | None:
    return _STATE.jsonl if _STATE.enabled else None


def nonconverged_policy() -> str:
    return _STATE.on_nonconverged


def concrete_or_none(x) -> Any:
    """``x`` as a host scalar (0-d tensors and arrays via ``.item()``) or a
    numpy array (more than one element), or ``None`` when it cannot be read
    as either.  Reading a CUDA tensor synchronises with the device."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    try:
        arr = np.asarray(x)
    except Exception:
        return None
    return arr.item() if arr.ndim == 0 else arr


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

def counter_inc(name: str, value: float = 1, **labels) -> None:
    if not _STATE.enabled:
        return
    v = concrete_or_none(value)
    if v is None:
        return
    k = _key(name, labels)
    with _STATE.lock:
        _STATE.counters[k] = _STATE.counters.get(k, 0) + v


def gauge_set(name: str, value: float, **labels) -> None:
    if not _STATE.enabled:
        return
    v = concrete_or_none(value)
    if v is None:
        return
    with _STATE.lock:
        _STATE.gauges[_key(name, labels)] = v


def histogram_observe(name: str, value: float, **labels) -> None:
    if not _STATE.enabled:
        return
    v = concrete_or_none(value)
    if v is None:
        return
    k = _key(name, labels)
    with _STATE.lock:
        h = _STATE.hists.setdefault(k, [])
        if len(h) < _HIST_LIMIT:
            h.append(float(v))


# -- entry-build ("trace") and cache accounting -------------------------------

def _form_tag(spec) -> str:
    """Human-readable form signature: the ``+``-joined term kinds."""
    try:
        return "+".join(kind for kind, _, _ in spec)
    except Exception:
        return "?"


def _plan_tag(plan) -> str:
    """Identity tag of an ``AssemblyPlan`` (plans key caches by identity)."""
    return f"{id(plan) & 0xFFFFFFFF:08x}"


def count_trace(kind: str, plan=None, spec=None, backend: str | None = None) -> None:
    """One build of a cached per-signature object (the eager counterpart of
    a jit trace, module docstring), keyed on (plan identity, form
    signature, backend)."""
    if not _STATE.enabled:
        return
    labels = {"kind": kind}
    if plan is not None:
        labels["plan"] = _plan_tag(plan)
    if spec is not None:
        labels["form"] = _form_tag(spec)
    if backend is not None:
        labels["backend"] = backend
    counter_inc("jit_traces", 1, **labels)


def count_cache(kind: str, hit: bool) -> None:
    """Cache lookup accounting (hit = a built entry reused)."""
    if not _STATE.enabled:
        return
    counter_inc("cache_lookups", 1, kind=kind, outcome="hit" if hit else "miss")


def histogram_values(name: str) -> dict[tuple, list]:
    """Raw observations of every series of one histogram family:
    ``{labels_tuple: [values, oldest first]}`` — what the SLO evaluator
    windows over.  Copies, so callers never race the recording paths."""
    with _STATE.lock:
        return {labels: list(v) for (n, labels), v in _STATE.hists.items() if n == name}


def jit_trace_total(kind: str | None = None) -> int:
    """Sum of the ``jit_traces`` counters, optionally of one kind —
    comparable against ``n_core_traces`` / ``n_matfree_traces``."""
    with _STATE.lock:
        total = 0
        for (name, labels), v in _STATE.counters.items():
            if name != "jit_traces":
                continue
            if kind is not None and dict(labels).get("kind") != kind:
                continue
            total += v
        return int(total)


# ---------------------------------------------------------------------------
# Snapshot / export
# ---------------------------------------------------------------------------

def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return math.nan
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _hist_summary(vals: list) -> dict:
    s = sorted(vals)
    n = len(s)
    return {
        "count": n,
        "sum": sum(s),
        "min": s[0] if n else math.nan,
        "max": s[-1] if n else math.nan,
        "mean": (sum(s) / n) if n else math.nan,
        "p50": _percentile(s, 0.50),
        "p90": _percentile(s, 0.90),
        "p99": _percentile(s, 0.99),
    }


def snapshot() -> dict:
    """The registry as plain dicts: ``{"counters": {name{labels}: value},
    "gauges": {...}, "histograms": {name{labels}: summary}}``, plus any
    registered section (``"slo"`` when an objective is defined)."""
    with _STATE.lock:
        counters = dict(_STATE.counters)
        gauges = dict(_STATE.gauges)
        hists = {k: list(v) for k, v in _STATE.hists.items()}
    snap = {
        "counters": {f"{n}{_label_str(lb)}": v for (n, lb), v in counters.items()},
        "gauges": {f"{n}{_label_str(lb)}": v for (n, lb), v in gauges.items()},
        "histograms": {f"{n}{_label_str(lb)}": _hist_summary(v)
                       for (n, lb), v in hists.items()},
    }
    for name, fn in _SNAPSHOT_SECTIONS.items():
        section = fn()
        if section:
            snap[name] = section
    return snap


def reset() -> None:
    """Drop every recorded metric (the enabled flag is untouched)."""
    with _STATE.lock:
        _STATE.counters.clear()
        _STATE.gauges.clear()
        _STATE.hists.clear()


def metric_rows() -> list[dict]:
    """The registry as ``BENCH_JSON``-format rows (``name`` / ``us_per_call``
    / ``derived`` + extras): counters and gauges carry their value in the
    ``value`` extra; histograms put the mean in ``us_per_call`` and the full
    summary in extras."""
    snap = snapshot()
    rows: list[dict] = []
    for name, v in snap["counters"].items():
        rows.append({
            "name": f"metric/counter/{name}", "us_per_call": 0.0,
            "derived": f"value={v}", "kind": "metric", "metric": "counter",
            "value": v,
        })
    for name, v in snap["gauges"].items():
        rows.append({
            "name": f"metric/gauge/{name}", "us_per_call": 0.0,
            "derived": f"value={v}", "kind": "metric", "metric": "gauge",
            "value": v,
        })
    for name, s in snap["histograms"].items():
        rows.append({
            "name": f"metric/histogram/{name}",
            "us_per_call": round(s["mean"], 1) if s["count"] else 0.0,
            "derived": f"count={s['count']};p50={s['p50']:.6g};p99={s['p99']:.6g}",
            "kind": "metric", "metric": "histogram", **s,
        })
    for provider in _ROW_PROVIDERS:
        rows.extend(provider())
    return rows


def append_jsonl_row(row: dict, path: str | None = None) -> None:
    """Append one row to the JSONL stream (default: the configured file)
    under the shared I/O lock — concurrent recorders always produce whole
    single-line rows.  No-op without a path."""
    path = path or _STATE.jsonl
    if not path:
        return
    line = json.dumps(row) + "\n"
    with _IO_LOCK:
        with open(path, "a") as f:
            f.write(line)


def export_jsonl(path: str | None = None) -> list[dict]:
    """Append the registry's :func:`metric_rows` to ``path`` (default: the
    configured streaming file) and return them.  With no path configured the
    rows are only returned."""
    rows = metric_rows()
    path = path or _STATE.jsonl
    if path:
        lines = "".join(json.dumps(row) + "\n" for row in rows)
        with _IO_LOCK:
            with open(path, "a") as f:
                f.write(lines)
    return rows


# env opt-in: REPRO_TELEMETRY=1 [REPRO_TELEMETRY_JSONL=<path>]
if os.environ.get("REPRO_TELEMETRY", "") not in ("", "0"):
    enable(jsonl=os.environ.get("REPRO_TELEMETRY_JSONL") or None)
