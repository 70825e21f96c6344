"""Client helpers: request factories and a synthetic open-loop load driver.

The torch port of ``repro.serve.client``.  Open-loop means arrivals do NOT
wait for completions — requests arrive on a Poisson process at a fixed
offered rate, the regime where admission batching pays: a loaded service
sees many compatible requests inside one window and answers them with one
batched entry.

The report reads its latency percentiles from the telemetry histograms the
*service* recorded (``serve_e2e_us`` / ``serve_queue_wait_us``) — the
client adds no timing machinery of its own.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import telemetry
from .batching import PendingSolve, SolveRequest

__all__ = ["LoadReport", "open_loop_load", "poisson_requests"]


_WORKLOADS: dict = {}


def _poisson_workload(resolution: int, device):
    """The shared (plan, bc, rhs) of the canonical Poisson workload, built
    once per (resolution, device): request *waves* must share the plan
    identity or they would never be admission-compatible (plans enter the
    key by identity)."""
    from ..core import resolve_device

    device = resolve_device(device)
    key = (resolution, str(device))
    if key not in _WORKLOADS:
        from ..core import (
            DirichletCondenser,
            FunctionSpace,
            assemble_rhs,
            build_plan,
            element_for_mesh,
            unit_square_tri,
            weakform as wf,
        )

        mesh = unit_square_tri(resolution)
        space = FunctionSpace(mesh, element_for_mesh(mesh, 1))
        plan = build_plan(space, device=device)
        bc = DirichletCondenser(plan.mat_routing, space.boundary_dofs(), device=device)
        rhs = assemble_rhs(plan, wf.source(1.0))
        _WORKLOADS[key] = (plan, bc, rhs)
    return _WORKLOADS[key]


def poisson_requests(*, n_requests: int = 16, resolution: int = 16,
                     backend: str = "csr", spec=None, method: str | None = None,
                     tol: float | None = None, timeout: float | None = None,
                     seed: int = 0, coeff_range=(0.5, 2.0),
                     device=None) -> list[SolveRequest]:
    """A family of heterogeneous-coefficient Poisson requests on ONE shared
    plan — the canonical compatible workload: −∇·(ρ_i ∇u) = f with a
    per-request piecewise-constant ρ_i and shared homogeneous Dirichlet
    boundary, on ``device`` (default CUDA).  The coefficients are drawn
    with ``np.random.default_rng(seed)`` as the reference draws them, so a
    seed gives the same requests in both packages.  All requests of a
    resolution carry the same admission key (the plan/bc are
    process-cached), so the service batches them into one entry and later
    waves hit the same cache entries."""
    from ..core import weakform as wf

    plan, bc, rhs = _poisson_workload(resolution, device)
    rng = np.random.default_rng(seed)
    lo, hi = coeff_range
    return [
        SolveRequest(
            plan=plan,
            form=wf.diffusion(torch.as_tensor(rng.uniform(lo, hi, size=plan.num_cells),
                                              device=plan.device)),
            rhs=rhs, bc=bc, backend=backend, spec=spec, method=method,
            tol=tol, timeout=timeout,
        )
        for _ in range(n_requests)
    ]


@dataclasses.dataclass
class LoadReport:
    """Outcome of one open-loop run.  Percentiles come from the service's
    telemetry histograms; counts from the resolved responses."""

    offered: int
    ok: int
    shed: int
    expired: int
    nonconverged: int
    failed: int
    duration_s: float
    e2e_p50_us: float
    e2e_p99_us: float
    queue_wait_p50_us: float
    batch_size_mean: float
    cache_hit_rate: float
    queue_depth_max: float = float("nan")
    # median over answered requests of (Σ top-level span segment walls) /
    # (t_done - t_submit): ≈1.0 when the span trees account for the full
    # request lifetime; NaN with telemetry off (no traces carried)
    span_coverage: float = float("nan")

    @property
    def throughput(self) -> float:
        return self.ok / self.duration_s if self.duration_s > 0 else 0.0


def _hist(snap: dict, name: str, field: str, default=float("nan")) -> float:
    """One field of a telemetry histogram summary, merged over label
    variants (the service labels by backend)."""
    vals, counts = [], []
    for key, s in snap["histograms"].items():
        if key == name or key.startswith(name + "{"):
            vals.append(s[field])
            counts.append(s["count"])
    if not vals:
        return default
    if field in ("count", "sum"):
        return sum(vals)
    # weighted merge is overkill for a report: take the largest population
    return vals[int(np.argmax(counts))]


def open_loop_load(service, requests, *, rate: float,
                   seed: int = 0) -> LoadReport:
    """Drive ``service`` with ``requests`` arriving as a Poisson process of
    ``rate`` requests/second (exponential inter-arrivals), then wait for
    every response.  Telemetry must be enabled for the percentile fields —
    with it disabled they come back NaN and only the counts are filled."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=len(requests))
    t0 = time.monotonic()
    pendings: list[PendingSolve] = []
    for req, gap in zip(requests, gaps):
        time.sleep(gap)
        pendings.append(service.submit(req))
    responses = [p.response() for p in pendings]
    duration = time.monotonic() - t0

    by_status: dict[str, int] = {}
    for r in responses:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    snap = telemetry.snapshot() if telemetry.is_enabled() else {
        "histograms": {}, "counters": {}, "gauges": {}}
    coverages = [
        sum(r.span_segments_us.values()) / (1e6 * r.e2e_s)
        for r in responses
        if r.trace and r.span_segments_us and r.e2e_s > 0
    ]
    coverage = float(np.median(coverages)) if coverages else float("nan")
    return LoadReport(
        offered=len(requests),
        ok=by_status.get("ok", 0),
        shed=by_status.get("overloaded", 0),
        expired=by_status.get("expired", 0),
        nonconverged=by_status.get("nonconverged", 0),
        failed=by_status.get("failed", 0),
        duration_s=duration,
        e2e_p50_us=_hist(snap, "serve_e2e_us", "p50"),
        e2e_p99_us=_hist(snap, "serve_e2e_us", "p99"),
        queue_wait_p50_us=_hist(snap, "serve_queue_wait_us", "p50"),
        batch_size_mean=_hist(snap, "serve_batch_size", "mean"),
        cache_hit_rate=service.cache.hit_rate(),
        queue_depth_max=_hist(snap, "serve_queue_depth", "max"),
        span_coverage=coverage,
    )
