"""Latency SLOs: declared objectives, attainment, and burn rate.

The torch port of ``repro.telemetry.slo``.  An :class:`SLO` declares a
latency objective over one telemetry histogram family — canonically
``serve_e2e_us`` for a tenant or admission class::

    telemetry.define_slo("checkout", p99_us=50_000)           # all e2e
    telemetry.define_slo("csr", p99_us=20_000, backend="csr") # one backend

``p99_us`` is the "99% of requests faster than X" objective: the
good-event fraction must stay ≥ 0.99 over the rolling ``window`` (the most
recent observations of the matched histogram series).  Status is computed
on demand from the registry — no extra recording cost on the hot path.

* **attainment** — fraction of windowed observations ≤ ``p99_us``.
* **error budget** — the allowed bad fraction, ``1 − 0.99 = 0.01``.
* **burn rate** — observed bad fraction ÷ budget: ``1.0`` burns the budget
  exactly at the sustainable rate, ``> 1`` exhausts it early, ``0`` means
  no violations in the window.

``slo_status()`` is surfaced in ``telemetry.snapshot()["slo"]`` (when any
SLO is defined), exported as ``kind="slo"`` rows by ``export_jsonl``, and
rendered by ``python -m repro_torch.telemetry.report --slo``.
"""

from __future__ import annotations

import dataclasses
import math

from . import metrics

__all__ = [
    "SLO",
    "define_slo",
    "clear_slos",
    "defined_slos",
    "slo_status",
    "slo_rows",
]

# a p99 objective: 99% of requests must beat the target latency
_GOOD_FRACTION = 0.99


@dataclasses.dataclass(frozen=True)
class SLO:
    """One latency objective.  ``labels`` restricts the histogram series
    the objective reads: a series matches when its label set contains
    every ``(k, v)`` pair (no labels matches every series of the family)."""

    name: str
    p99_us: float
    window: int = 1024
    histogram: str = "serve_e2e_us"
    labels: tuple = ()

    def __post_init__(self):
        if self.p99_us <= 0:
            raise ValueError(f"p99_us must be > 0, got {self.p99_us}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


_SLOS: dict[str, SLO] = {}


def define_slo(name: str, p99_us: float, *, window: int = 1024,
               histogram: str = "serve_e2e_us", **labels) -> SLO:
    """Declare (or replace) one objective.  Returns the :class:`SLO`."""
    slo = SLO(name=name, p99_us=float(p99_us), window=int(window),
              histogram=histogram, labels=tuple(sorted(labels.items())))
    _SLOS[name] = slo
    return slo


def clear_slos() -> None:
    _SLOS.clear()


def defined_slos() -> dict[str, SLO]:
    return dict(_SLOS)


def _matched_values(slo: SLO) -> list[float]:
    """Windowed observations: merge every series of ``slo.histogram`` whose
    labels cover ``slo.labels``, keep the most recent ``window``."""
    want = dict(slo.labels)
    merged: list[float] = []
    for labels, vals in metrics.histogram_values(slo.histogram).items():
        have = dict(labels)
        if all(have.get(k) == v for k, v in want.items()):
            merged.extend(vals)
    return merged[-slo.window:]


def _status_of(slo: SLO) -> dict:
    vals = _matched_values(slo)
    n = len(vals)
    if n == 0:
        return {
            "objective_us": slo.p99_us, "window": slo.window,
            "histogram": slo.histogram, "labels": dict(slo.labels),
            "count": 0, "p99_us": math.nan, "attainment": math.nan,
            "burn_rate": 0.0, "met": True,  # no traffic burns no budget
        }
    s = sorted(vals)
    p99 = s[min(n - 1, max(0, int(round(0.99 * (n - 1)))))]
    good = sum(1 for v in vals if v <= slo.p99_us)
    attainment = good / n
    burn_rate = (1.0 - attainment) / (1.0 - _GOOD_FRACTION)
    return {
        "objective_us": slo.p99_us, "window": slo.window,
        "histogram": slo.histogram, "labels": dict(slo.labels),
        "count": n, "p99_us": p99,
        "attainment": attainment, "burn_rate": burn_rate,
        "met": attainment >= _GOOD_FRACTION,
    }


def slo_status() -> dict[str, dict]:
    """Every defined objective → its current status dict (attainment, burn
    rate, observed p99, met).  Empty dict with nothing defined."""
    return {name: _status_of(slo) for name, slo in _SLOS.items()}


def slo_rows() -> list[dict]:
    """The status as ``BENCH_JSON`` rows (``kind="slo"``) for
    ``export_jsonl`` — the ``report --slo`` input format."""
    rows = []
    for name, st in slo_status().items():
        rows.append({
            "name": f"slo/{name}",
            "us_per_call": 0.0 if math.isnan(st["p99_us"]) else round(st["p99_us"], 1),
            "derived": (f"objective={st['objective_us']:g}"
                        f";attainment={st['attainment']:.4f}"
                        f";burn={st['burn_rate']:.2f}"
                        f";met={st['met']}"),
            "kind": "slo",
            "slo": name,
            **{k: v for k, v in st.items() if k != "labels"},
            "labels": st["labels"],
        })
    return rows


# surface SLO status in snapshot() / export_jsonl without metrics importing
# this module (registration keeps the dependency one-way)
metrics.register_snapshot_section("slo", lambda: slo_status() or None)
metrics.register_row_provider(slo_rows)
