"""repro_torch.serve — multi-tenant batched PDE solve service.

The torch port of ``repro.serve``, with the same public names.  One-shot
solves become admitted requests that an admission batcher groups — same
``(plan, form signature, bc, backend, SolverSpec)`` within a configurable
window — into ONE batched assembly (:class:`~repro_torch.core.BatchedCSR`:
one batched B1 and one batched B2 launch) or one
:class:`~repro_torch.core.MatFreeFamily`, served from a persistent
executable cache with warmup/pinning and LRU eviction.

Module map
----------
* :mod:`~repro_torch.serve.batching` — :class:`SolveRequest` /
  :class:`SolveResponse` / :class:`PendingSolve`, admission keys,
  power-of-two padding buckets, the typed errors (:class:`Overloaded`,
  :class:`DeadlineExpired`, :class:`NonConverged`).
* :mod:`~repro_torch.serve.cache` — :class:`ExecutableCache`: per-entry
  batched-solve closures, pinning, the padding rule.
* :mod:`~repro_torch.serve.service` — :class:`SolveService`: bounded
  admission queue, dispatch worker, deadline/shedding/non-convergence
  policies, all accounting through :mod:`repro_torch.telemetry`.
* :mod:`~repro_torch.serve.client` — request factories and the synthetic
  open-loop (Poisson-arrival) load driver + :class:`LoadReport`.

Quick start (on the card; pass ``device="cpu"`` to run on the CPU)::

    from repro_torch import serve, telemetry
    telemetry.enable()
    reqs = serve.poisson_requests(n_requests=16, backend="csr")
    with serve.SolveService(window=0.002) as svc:
        svc.warmup(reqs[0], batch_sizes=(16,))
        report = serve.open_loop_load(svc, reqs, rate=2000.0)
    print(report.e2e_p99_us, report.cache_hit_rate)
"""

from .batching import (  # noqa: F401
    DeadlineExpired,
    NonConverged,
    Overloaded,
    PendingSolve,
    SolveRequest,
    SolveResponse,
    admission_key,
    pad_bucket,
)
from .cache import ExecutableCache  # noqa: F401
from .client import LoadReport, open_loop_load, poisson_requests  # noqa: F401
from .service import SolveService  # noqa: F401

__all__ = [
    "SolveService",
    "SolveRequest",
    "SolveResponse",
    "PendingSolve",
    "ExecutableCache",
    "Overloaded",
    "DeadlineExpired",
    "NonConverged",
    "admission_key",
    "pad_bucket",
    "LoadReport",
    "open_loop_load",
    "poisson_requests",
]
