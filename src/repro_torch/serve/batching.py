"""Admission-batching data model: requests, responses, compatibility keys.

The torch port of ``repro.serve.batching``.  A :class:`SolveRequest` is one
tenant's PDE solve: a plan, a :class:`~repro_torch.core.weakform.WeakForm`
(whose value leaves carry the tenant's coefficients), an assembled RHS
vector, an optional Dirichlet condenser, and solve/QoS knobs.  Two requests
are *compatible* — batchable into one executable-cache entry — exactly when
they share the admission key

    (plan identity, lowered form signature, bc identity, backend, SolverSpec)

so only the coefficient leaf *values* and the RHS differ across a batch,
and B compatible requests run as ONE batched assembly (one batched B1 and
one batched B2 launch) and their solves, or one
:class:`~repro_torch.core.operator.MatFreeFamily` and its solves.

A :class:`PendingSolve` is a minimal future (threading.Event + slot)
resolved by the service worker with a :class:`SolveResponse` whose
``status`` is one of ``"ok"``, ``"overloaded"`` (shed at admission),
``"expired"`` (deadline passed before dispatch), ``"nonconverged"``
(Krylov maxiter exit under the ``on_nonconverged="raise"`` policy) or
``"failed"`` (the batch raised).  ``result()`` raises the typed error;
``response()`` never raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any

import numpy as np
import torch

from ..core import weakform
from ..core.solvers import SolverSpec, resolve_solver_spec
from ..telemetry.spans import NULL_SPAN

__all__ = [
    "SolveRequest",
    "SolveResponse",
    "PendingSolve",
    "Overloaded",
    "DeadlineExpired",
    "NonConverged",
    "admission_key",
    "pad_bucket",
]

_REQUEST_IDS = itertools.count()


class Overloaded(RuntimeError):
    """Request shed at admission: the bounded queue was full."""


class DeadlineExpired(TimeoutError):
    """Request expired in the admission queue before dispatch."""


class NonConverged(RuntimeError):
    """The request's Krylov solve exited at ``maxiter`` and the service
    runs under the ``on_nonconverged="raise"`` policy."""


def _leaf_on(leaf, device) -> torch.Tensor:
    """A form's value leaf as a tensor on the plan's device (python and
    numpy values keep numpy's dtype: a float is float64)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.as_tensor(np.asarray(leaf), device=device)


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One tenant solve: ``A(form) u = rhs`` on ``plan``, condensed by ``bc``.

    ``form``'s value leaves are the tenant's coefficients; ``rhs`` is the
    *assembled* load vector ``(n,)`` (``assemble_rhs(plan,
    wf.source(f))``).  Dirichlet conditions are homogeneous (condensation
    masks the RHS); ``timeout`` is the seconds the request may wait in the
    admission queue before it is answered ``"expired"`` instead of solved.
    """

    plan: Any                      # AssemblyPlan (shared across a batch)
    form: Any                      # WeakForm — per-tenant coefficient leaves
    rhs: torch.Tensor              # assembled (n,) load vector
    bc: Any = None                 # DirichletCondenser | None (homogeneous)
    backend: str = "csr"           # "csr" | "matfree"
    spec: SolverSpec | None = None  # Krylov config; part of the admission key
    method: str | None = None      # deprecated → spec.method
    tol: float | None = None       # deprecated → spec.tol (and atol)
    maxiter: int | None = None     # deprecated → spec.maxiter
    timeout: float | None = None   # admission-queue deadline [s]
    request_id: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))

    def __post_init__(self):
        if self.backend not in ("csr", "matfree"):
            raise ValueError(f"unknown backend {self.backend!r}: expected 'csr' or 'matfree'")
        # fold the legacy per-field knobs into one hashable SolverSpec (the
        # admission key carries the spec, so every solver knob — precond
        # included — separates compatibility classes)
        spec = resolve_solver_spec(
            self.spec, method=self.method, tol=self.tol, atol=self.tol,
            maxiter=self.maxiter,
            default=SolverSpec(method="cg", tol=1e-10, atol=1e-10, maxiter=10000),
            where="SolveRequest")
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "method", spec.method)
        object.__setattr__(self, "tol", spec.tol)
        object.__setattr__(self, "maxiter", spec.maxiter)
        form_sig, leaves = weakform.lower(self.form, weakform.MATRIX)
        object.__setattr__(self, "_form_sig", form_sig)
        object.__setattr__(self, "_leaves",
                           tuple(_leaf_on(lf, self.plan.device) for lf in leaves))

    @property
    def form_sig(self):
        """The lowered (hashable) form signature — the batching key part."""
        return self._form_sig

    @property
    def leaves(self) -> tuple:
        """The coefficient leaves on the plan's device, in lowering slot
        order."""
        return self._leaves


@dataclasses.dataclass
class SolveResponse:
    """What a :class:`PendingSolve` resolves to.  ``u``/``info`` are set for
    ``status == "ok"`` (and ``info`` for ``"nonconverged"``); ``error``
    carries the typed exception otherwise.  ``u`` lies on the plan's
    device.  Timestamps are ``time.monotonic()`` seconds (the service's
    clock) so clients can cross-check the telemetry histograms."""

    status: str                    # "ok" | "overloaded" | "expired" | "nonconverged" | "failed"
    u: torch.Tensor | None = None
    info: Any = None               # the request's SolveInfo
    error: Exception | None = None
    batch_size: int = 0            # admission batch the request rode in
    cache_hit: bool | None = None  # executable-cache outcome of that batch
    t_submit: float = 0.0
    t_dispatch: float = 0.0
    t_done: float = 0.0
    trace: dict | None = None      # span tree (telemetry on) — see spans.py

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def span_segments_us(self) -> dict:
        """Top-level segment walls (µs) of the carried span tree —
        ``{"queue_wait": ..., "dispatch": ..., "solve": ..., "slice": ...}``
        summing to the end-to-end latency.  Empty without telemetry."""
        if not self.trace:
            return {}
        return {c["name"]: c["wall_us"] for c in self.trace.get("children", ())
                if c.get("wall_us") is not None}

    @property
    def queue_wait_s(self) -> float:
        return max(0.0, self.t_dispatch - self.t_submit)

    @property
    def e2e_s(self) -> float:
        return max(0.0, self.t_done - self.t_submit)


class PendingSolve:
    """A minimal future for one submitted request."""

    def __init__(self, request: SolveRequest):
        self.request = request
        # the request's root span, set by SolveService.submit() when
        # telemetry is on (NULL_SPAN otherwise: every span call is a no-op)
        self.span = NULL_SPAN
        self._event = threading.Event()
        self._response: SolveResponse | None = None

    def _resolve(self, response: SolveResponse) -> None:
        self._response = response
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def response(self, timeout: float | None = None) -> SolveResponse:
        """Block until the service answers; never raises on error statuses."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id} not answered within {timeout}s")
        return self._response

    def result(self, timeout: float | None = None) -> torch.Tensor:
        """The solution vector; raises the typed error on non-``ok`` statuses
        (:class:`Overloaded` / :class:`DeadlineExpired` /
        :class:`NonConverged`, or the batch's own exception)."""
        resp = self.response(timeout)
        if resp.error is not None:
            raise resp.error
        return resp.u


def admission_key(req: SolveRequest) -> tuple:
    """The compatibility key: requests with equal keys batch into one
    executable-cache entry.  Plan and condenser enter by *identity* (the
    port's per-plan caches key on the plan object); the frozen
    :class:`~repro_torch.core.SolverSpec` enters by value, so every solver
    knob separates compatibility classes."""
    return (
        id(req.plan),
        req.form_sig,
        id(req.bc) if req.bc is not None else None,
        req.backend,
        req.spec,
    )


def pad_bucket(b: int) -> int:
    """Round a batch size up to the next power of two.  Padding admission
    batches to bucket sizes keeps the executable cache small and stable:
    waves of 9, 13 and 16 requests all reuse the B=16 entry."""
    if b < 1:
        raise ValueError(f"batch size must be >= 1, got {b}")
    return 1 << (b - 1).bit_length()
