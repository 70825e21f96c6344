"""repro_torch.telemetry — convergence diagnostics, named-phase tracing and
a runtime metrics/event registry (the part of ``repro.telemetry`` the
solver path calls).

Disabled by default; every recording entry point returns after one
boolean check when off.  This package imports nothing from
:mod:`repro_torch.core` — the core imports *it*.
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
    counter_inc,
    disable,
    enable,
    enabled,
    gauge_set,
    histogram_observe,
    is_enabled,
    nonconverged_policy,
    reset,
    snapshot,
)
from .trace import annotate, span  # noqa: F401
