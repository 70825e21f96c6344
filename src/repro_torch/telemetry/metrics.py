"""Process-global runtime metrics registry (counters / gauges / histograms).

The torch port of ``repro.telemetry.metrics``, cut to what the solver path
calls.  Telemetry is **off by default**: every recording entry point
returns after one boolean check.  Values are converted to host scalars
(:func:`concrete_or_none`) before they are stored, so no tensor (and no
autograd graph) is kept alive by the registry.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any

__all__ = [
    "enable",
    "disable",
    "is_enabled",
    "enabled",
    "nonconverged_policy",
    "concrete_or_none",
    "counter_inc",
    "gauge_set",
    "histogram_observe",
    "snapshot",
    "reset",
]

# one observation cap per histogram key: summaries stay exact for any run
# that fits, and a runaway loop cannot grow host memory without bound
_HIST_LIMIT = 65536


class _State:
    """The process-global telemetry switchboard (thread-safe registry)."""

    def __init__(self):
        self.enabled = False
        self.on_nonconverged = "warn"  # "warn" | "raise" | "ignore"
        self.lock = threading.Lock()
        self.counters: dict[tuple, float] = {}
        self.gauges: dict[tuple, float] = {}
        self.hists: dict[tuple, list] = {}


_STATE = _State()


def enable(on_nonconverged: str | None = None) -> None:
    """Turn telemetry recording on.  ``on_nonconverged`` selects the policy
    when a solve reports ``converged=False``: ``"warn"`` (default),
    ``"raise"`` or ``"ignore"``."""
    if on_nonconverged is not None:
        if on_nonconverged not in ("warn", "raise", "ignore"):
            raise ValueError(
                f"on_nonconverged={on_nonconverged!r}: use 'warn', 'raise' or 'ignore'"
            )
        _STATE.on_nonconverged = on_nonconverged
    _STATE.enabled = True


def disable() -> None:
    """Turn recording off (the registry contents are kept — :func:`reset`
    drops them)."""
    _STATE.enabled = False


def is_enabled() -> bool:
    return _STATE.enabled


@contextlib.contextmanager
def enabled(on_nonconverged: str | None = None):
    """Scoped :func:`enable`: restores the previous state on exit."""
    prev = (_STATE.enabled, _STATE.on_nonconverged)
    enable(on_nonconverged=on_nonconverged)
    try:
        yield
    finally:
        _STATE.enabled, _STATE.on_nonconverged = prev


def nonconverged_policy() -> str:
    return _STATE.on_nonconverged


def concrete_or_none(x) -> Any:
    """``x`` as a host scalar (0-d tensors and arrays via ``.item()``), or
    ``None`` when it cannot be read as one."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    item = getattr(x, "item", None)
    if item is None:
        return None
    try:
        return item()
    except (RuntimeError, ValueError):
        return None


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


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
    "gauges": {...}, "histograms": {name{labels}: summary}}``."""
    with _STATE.lock:
        counters = dict(_STATE.counters)
        gauges = dict(_STATE.gauges)
        hists = {k: list(v) for k, v in _STATE.hists.items()}
    return {
        "counters": {f"{n}{_label_str(lb)}": v for (n, lb), v in counters.items()},
        "gauges": {f"{n}{_label_str(lb)}": v for (n, lb), v in gauges.items()},
        "histograms": {f"{n}{_label_str(lb)}": _hist_summary(v)
                       for (n, lb), v in hists.items()},
    }


def reset() -> None:
    """Drop every recorded metric (the enabled flag is untouched)."""
    with _STATE.lock:
        _STATE.counters.clear()
        _STATE.gauges.clear()
        _STATE.hists.clear()
