"""repro_torch.telemetry — convergence diagnostics, named-phase profiler
tracing, a runtime metrics/event registry, request spans, the flight
recorder and latency SLOs: the torch port of ``repro.telemetry``, with the
same public names.

* **Convergence diagnostics** — every Krylov solve carries a
  ``SolveInfo(iters, residual, converged)``; :func:`check_convergence`
  turns a silent ``maxiter`` exit into a warning or an error.
* **Named-phase tracing** — :class:`annotate` names the Map / Reduce /
  gather / scatter / Krylov phases in a ``torch.profiler`` trace;
  :func:`capture` writes a Chrome-format trace of any block.
* **Metrics & events** — a process-global registry (entry-build and cache
  counters, memory gauges, iteration/wall-time histograms) plus a
  structured event stream with JSON-lines export in the ``BENCH_JSON`` row
  format; rendered by ``python -m repro_torch.telemetry.report``.
* **Request tracing** — :func:`span_root` / :func:`span` build host-side
  span trees with one trace id per request; a bounded flight recorder
  (:func:`configure_flight` / :func:`flight_dump`) keeps the last K
  completed request traces; :func:`define_slo` tracks latency SLO
  attainment and burn rate against any histogram.

In an eager port a "trace" (:func:`count_trace`, :func:`jit_trace_total`,
``repro_torch.core.n_core_traces`` / ``n_matfree_traces``) is the build of
a cached per-signature object: the first assembly or operator build of a
(plan, form signature) pair, or an executable-cache entry of the serve
tier (:mod:`repro_torch.telemetry.metrics`), recorded while telemetry is
on.

Disabled by default: every recording entry point returns after one boolean
check, and no tag or registry entry holds a tensor.  Enable with
:func:`enable` (or ``REPRO_TELEMETRY=1`` in the environment).  This package
imports nothing from :mod:`repro_torch.core` — the core imports *it*.
"""

from .events import (  # noqa: F401
    ConvergenceWarning,
    NonConvergedError,
    check_convergence,
    clear_events,
    event_log,
    record_assembly,
    record_event,
    record_solve,
)
from .metrics import (  # noqa: F401
    count_cache,
    count_trace,
    counter_inc,
    disable,
    enable,
    enabled,
    export_jsonl,
    gauge_set,
    histogram_observe,
    is_enabled,
    jit_trace_total,
    jsonl_path,
    metric_rows,
    nonconverged_policy,
    reset,
    snapshot,
)
from .slo import (  # noqa: F401
    SLO,
    clear_slos,
    define_slo,
    defined_slos,
    slo_status,
)
from .spans import (  # noqa: F401
    NULL_SPAN,
    Span,
    clear_flight,
    configure_flight,
    current_span,
    flight_autodump,
    flight_dump,
    flight_record,
    flight_records,
    span,
    span_root,
)
from .trace import annotate, capture  # noqa: F401

__all__ = [
    # switchboard
    "enable", "disable", "enabled", "is_enabled", "reset", "jsonl_path",
    "nonconverged_policy",
    # tracing
    "annotate", "capture",
    # metrics
    "counter_inc", "gauge_set", "histogram_observe", "count_trace",
    "count_cache", "jit_trace_total", "snapshot", "export_jsonl",
    "metric_rows",
    # spans / flight recorder
    "Span", "NULL_SPAN", "span", "span_root", "current_span",
    "configure_flight", "flight_record", "flight_records", "flight_dump",
    "flight_autodump", "clear_flight",
    # SLOs
    "SLO", "define_slo", "defined_slos", "clear_slos", "slo_status",
    # events / convergence
    "record_event", "record_solve", "record_assembly", "check_convergence",
    "event_log", "clear_events", "ConvergenceWarning", "NonConvergedError",
]
