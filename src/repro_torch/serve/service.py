"""`SolveService` — the multi-tenant batched PDE solve front-end.

The torch port of ``repro.serve.service``.  Request lifecycle::

    submit() ──▶ admission queue ──▶ [window] ──▶ group by admission key
       │              │                               │
       │ queue full   │ deadline passed               ▼
       ▼              ▼                      pad to bucket, fetch/build the
    "overloaded"   "expired"                 entry, ONE batched assembly
                                                      │
                                                      ▼
                                        per-request slice → PendingSolve

The dispatch worker wakes on the first queued request, sleeps ``window``
seconds while compatible requests accumulate, then drains the queue grouped
by :func:`~repro_torch.serve.batching.admission_key` — each group becomes
one batched assembly (``csr``: one batched B1 and one batched B2 launch)
or one :class:`~repro_torch.core.operator.MatFreeFamily` (``matfree``: B2
once per operator apply), padded to a power-of-two bucket so wave-to-wave
size jitter builds no new entry.  The Krylov solves run one real request
after another (the padding rule of :mod:`repro_torch.serve.cache`).  The
worker runs each group with the plan's CUDA device current.

All accounting goes through :mod:`repro_torch.telemetry`:

* ``serve_queue_wait_us`` / ``serve_e2e_us`` histograms (p50/p90/p99 via
  ``telemetry.snapshot()``; the SLO gate reads these),
* ``serve_batch_size`` histogram,
* ``serve_requests{outcome=...}`` counters (ok / shed / expired /
  nonconverged / failed),
* ``cache_lookups{kind=serve_exec}`` + ``jit_traces{kind=serve}`` — the
  executable-cache hit rate and the no-entry-built-after-warmup proof,
* ``record_solve("serve.dispatch", ...)`` — Krylov iteration stats and
  solve wall time per dispatched batch,
* ``serve_queue_depth`` gauge + histogram — admission depth at every drain,
* **span trees** — every request gets a root span at :meth:`submit` with
  ``queue_wait`` / ``dispatch`` / ``solve`` / ``slice`` children summing
  exactly to its end-to-end latency (the ``solve`` segment ends after the
  device has finished); the tree rides back on ``SolveResponse.trace`` and
  every completed request is recorded in the flight recorder, which
  auto-dumps on shed / expiry / non-convergence / failure.

Non-converged solves follow ``telemetry.nonconverged_policy()``:
``"warn"`` answers ``"ok"`` with a ``ConvergenceWarning``; ``"raise"``
answers ``"nonconverged"`` with a typed
:class:`~repro_torch.serve.batching.NonConverged` error on exactly the
requests whose solve hit ``maxiter``; ``"ignore"`` stays silent.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from collections import OrderedDict

import numpy as np
import torch

from .. import telemetry
from ..core.solvers import SolveInfo
from ..telemetry.events import ConvergenceWarning
from .batching import (
    DeadlineExpired,
    NonConverged,
    Overloaded,
    PendingSolve,
    SolveRequest,
    SolveResponse,
    admission_key,
    pad_bucket,
)
from .cache import ExecutableCache, synchronize

__all__ = ["SolveService"]


def _on_device(device: torch.device):
    """Make ``device`` the current CUDA device for the block (a worker
    thread starts on device 0)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class SolveService:
    """Admission-batched solve service over one or more assembly plans.

    ``window``: seconds the dispatcher waits after the first queued request
    before draining (the batching window — higher amortizes better, costs
    p50 latency).  ``max_batch`` bounds one dispatched family;
    ``queue_limit`` bounds the admission queue (submissions beyond it are
    shed with an ``"overloaded"`` response).  ``cache_capacity`` sizes the
    unpinned part of the executable cache.

    Use as a context manager (starts/stops the dispatch thread), or leave
    it unstarted and call :meth:`drain` for synchronous, deterministic
    dispatch (tests, batch jobs).
    """

    def __init__(self, *, window: float = 0.002, max_batch: int = 64,
                 queue_limit: int = 1024, cache_capacity: int = 32):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.window = float(window)
        self.max_batch = int(max_batch)
        self.queue_limit = int(queue_limit)
        self.cache = ExecutableCache(cache_capacity)
        self._queue: list[tuple[PendingSolve, float, float | None]] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._worker: threading.Thread | None = None
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SolveService":
        """Start the dispatch thread (idempotent).  Requests submitted
        before ``start()`` sit in the queue and dispatch on the first
        window after it."""
        with self._lock:
            if self._worker is not None:
                return self
            self._stopping = False
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="repro-torch-serve-dispatch", daemon=True)
        self._worker.start()
        return self

    def stop(self) -> None:
        """Drain the queue, then stop the dispatch thread."""
        with self._lock:
            worker, self._worker = self._worker, None
            self._stopping = True
            self._wake.notify_all()
        if worker is not None:
            worker.join()
        self.drain()

    def __enter__(self) -> "SolveService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission ---------------------------------------------------------
    def submit(self, request: SolveRequest) -> PendingSolve:
        """Admit one request.  Returns immediately with a
        :class:`PendingSolve`; if the admission queue is full the future is
        already resolved with an ``"overloaded"`` response (typed
        :class:`Overloaded` error from ``result()``) — overload is shed,
        not queued."""
        now_ns = time.monotonic_ns()
        now = now_ns / 1e9
        pending = PendingSolve(request)
        # root of the request's span tree: trace_id minted here, carried to
        # the response via the dispatch path (NULL_SPAN when telemetry off)
        pending.span = telemetry.span_root(
            "serve.request", start_ns=now_ns, request_id=request.request_id,
            backend=request.backend, method=request.spec.method)
        deadline = None if request.timeout is None else now + request.timeout
        with self._lock:
            if len(self._queue) >= self.queue_limit:
                telemetry.counter_inc("serve_requests", outcome="shed")
                root = pending.span.finish(end_ns=now_ns, outcome="shed")
                telemetry.flight_record(
                    root, outcome="shed", request_id=request.request_id,
                    backend=request.backend, queue_limit=self.queue_limit)
                telemetry.flight_autodump("shed")
                pending._resolve(SolveResponse(
                    status="overloaded",
                    error=Overloaded(f"admission queue full ({self.queue_limit} pending)"),
                    t_submit=now, t_dispatch=now, t_done=now, trace=root.to_dict()))
                return pending
            self._queue.append((pending, now, deadline))
            self._wake.notify_all()
        return pending

    def solve(self, request: SolveRequest, timeout: float | None = None):
        """Convenience synchronous path: submit and wait.  With no worker
        running the queue is drained inline."""
        pending = self.submit(request)
        if self._worker is None and not pending.done():
            self.drain()
        return pending.result(timeout)

    # -- dispatch ----------------------------------------------------------
    def drain(self) -> int:
        """Synchronously dispatch everything queued right now (no window
        wait).  Returns the number of requests answered — the deterministic
        path used by tests and by :meth:`stop`."""
        with self._lock:
            batch, self._queue = self._queue, []
        self._sample_queue_depth(len(batch))
        return self._dispatch(batch)

    def _sample_queue_depth(self, depth: int) -> None:
        """Admission queue depth at drain time — separates 'the service is
        loaded' (depth grows) from 'one entry is slow' (depth normal,
        queue-wait p99 grows)."""
        telemetry.gauge_set("serve_queue_depth", depth)
        telemetry.histogram_observe("serve_queue_depth", depth)

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._stopping:
                    self._wake.wait()
                if self._stopping:
                    return
            # open the admission window: compatible requests accumulate
            if self.window > 0:
                time.sleep(self.window)
            with self._lock:
                batch, self._queue = self._queue, []
            self._sample_queue_depth(len(batch))
            self._dispatch(batch)

    def _dispatch(self, entries) -> int:
        """Group → pad → run → slice → resolve.  ``entries`` are
        ``(pending, t_submit, deadline)`` triples."""
        if not entries:
            return 0
        now_ns = time.monotonic_ns()
        now = now_ns / 1e9
        groups: OrderedDict = OrderedDict()
        n_done = 0
        for pending, t_submit, deadline in entries:
            if deadline is not None and now > deadline:
                telemetry.counter_inc("serve_requests", outcome="expired")
                root = pending.span
                root.child("queue_wait", start_ns=root.start_ns).finish(end_ns=now_ns)
                root.finish(end_ns=now_ns, outcome="expired")
                telemetry.flight_record(
                    root, outcome="expired", request_id=pending.request.request_id,
                    backend=pending.request.backend, waited_s=round(now - t_submit, 4))
                telemetry.flight_autodump("expired")
                pending._resolve(SolveResponse(
                    status="expired",
                    error=DeadlineExpired(
                        f"request {pending.request.request_id} expired after "
                        f"{now - t_submit:.3f}s in the admission queue"),
                    t_submit=t_submit, t_dispatch=now, t_done=now, trace=root.to_dict()))
                n_done += 1
                continue
            key = admission_key(pending.request)
            groups.setdefault(key, []).append((pending, t_submit))
        for key, members in groups.items():
            for start in range(0, len(members), self.max_batch):
                chunk = members[start:start + self.max_batch]
                with _on_device(chunk[0][0].request.plan.device):
                    self._run_group(key, chunk)
                n_done += len(chunk)
        return n_done

    def _run_group(self, key, members) -> None:
        pendings = [p for p, _ in members]
        submits = [t for _, t in members]
        template = pendings[0].request
        device = template.plan.device
        b = len(pendings)
        padded = min(pad_bucket(b), self.max_batch)
        t_dispatch_ns = time.monotonic_ns()
        t_dispatch = t_dispatch_ns / 1e9
        roots = [p.span for p in pendings]
        # segment 1: queue_wait — submit (the root's start) → dispatch
        for t, root in zip(submits, roots):
            telemetry.histogram_observe("serve_queue_wait_us", 1e6 * (t_dispatch - t),
                                        backend=template.backend)
            root.child("queue_wait", start_ns=root.start_ns).finish(end_ns=t_dispatch_ns)
        telemetry.histogram_observe("serve_batch_size", b, backend=template.backend)
        try:
            fn, cache_hit = self.cache.get(key, padded, template)
            t_lookup_ns = time.monotonic_ns()
            leaves = tuple(
                _stack_padded([p.request.leaves[j] for p in pendings], padded, device)
                for j in range(len(template.leaves)))
            rhs = _stack_padded([p.request.rhs for p in pendings], padded, device)
            t_solve_ns = time.monotonic_ns()
            # segment 2: dispatch — cache lookup + pad/stack to the bucket
            # (the batch-level walls are duplicated into every member's
            # tree: each response carries its complete timeline)
            for root in roots:
                d = root.child("dispatch", start_ns=t_dispatch_ns, batch=b, padded=padded,
                               cache_hit=cache_hit)
                d.child("cache_lookup", start_ns=t_dispatch_ns).finish(end_ns=t_lookup_ns)
                d.child("pad", start_ns=t_lookup_ns).finish(end_ns=t_solve_ns)
                d.finish(end_ns=t_solve_ns)
            x, info = fn(template.plan, leaves, rhs, b)
            # segment 3: solve — the batched assembly and the solves of the
            # real rows, ended once the device has finished them (an entry
            # built on this call pays its first launches here)
            synchronize(device)
            converged = np.asarray(info.converged)
            iters = np.asarray(info.iters)
            residual = np.asarray(info.residual)
            t_solved_ns = time.monotonic_ns()
            for root in roots:
                root.child("solve", start_ns=t_solve_ns,
                           compiled=not cache_hit).finish(end_ns=t_solved_ns)
        except Exception as err:  # build/solve failure → fail the batch
            t_done_ns = time.monotonic_ns()
            t_done = t_done_ns / 1e9
            telemetry.counter_inc("serve_requests", value=b, outcome="failed")
            for (p, t), root in zip(members, roots):
                root.finish(end_ns=t_done_ns, outcome="failed", error=type(err).__name__)
                telemetry.flight_record(
                    root, outcome="failed", request_id=p.request.request_id,
                    admission=_key_tag(key), bucket=padded, batch=b, error=repr(err))
                p._resolve(SolveResponse(
                    status="failed", error=err, batch_size=b, t_submit=t,
                    t_dispatch=t_dispatch, t_done=t_done, trace=root.to_dict()))
            telemetry.flight_autodump("failed")
            return
        info_b = SolveInfo(iters, residual, converged)
        t_done_ns = time.monotonic_ns()
        t_done = t_done_ns / 1e9
        telemetry.record_solve(
            "serve.dispatch", info_b, method=template.spec.method,
            precond=template.spec.precond_name, backend=template.backend,
            wall_us=1e-3 * (t_done_ns - t_dispatch_ns),
            batch=b, padded=padded, cache_hit=cache_hit)
        policy = telemetry.nonconverged_policy()
        any_nonconverged = False
        for i, (p, t) in enumerate(members):
            root = roots[i]
            # segment 4: slice — per-request extraction from the batch; ends
            # at t_done, so the four segments sum exactly to the response's
            # end-to-end latency (t_done - t_submit)
            root.child("slice", start_ns=t_solved_ns).finish(end_ns=t_done_ns)
            resp = SolveResponse(
                status="ok", u=x[i],
                info=SolveInfo(int(iters[i]), float(residual[i]), bool(converged[i])),
                batch_size=b, cache_hit=cache_hit,
                t_submit=t, t_dispatch=t_dispatch, t_done=t_done)
            if not converged[i]:
                msg = (f"request {p.request.request_id}: solve not converged "
                       f"after {int(iters[i])} iterations "
                       f"(residual {float(residual[i]):.3e})")
                if policy == "raise":
                    resp.status = "nonconverged"
                    resp.error = NonConverged(msg)
                    resp.u = None
                    telemetry.counter_inc("serve_requests", outcome="nonconverged")
                    any_nonconverged = True
                else:
                    if policy == "warn":
                        warnings.warn(msg, ConvergenceWarning, stacklevel=2)
                    telemetry.counter_inc("serve_requests", outcome="ok")
            else:
                telemetry.counter_inc("serve_requests", outcome="ok")
            telemetry.histogram_observe("serve_e2e_us", 1e6 * (t_done - t),
                                        backend=template.backend)
            root.finish(end_ns=t_done_ns, outcome=resp.status,
                        converged=bool(converged[i]), iters=int(iters[i]))
            resp.trace = root.to_dict()
            telemetry.flight_record(
                root, outcome=resp.status, request_id=p.request.request_id,
                admission=_key_tag(key), bucket=padded, batch=b, backend=template.backend,
                cache_hit=cache_hit, iterations=int(iters[i]),
                final_residual=float(residual[i]), converged=bool(converged[i]))
            p._resolve(resp)
        if any_nonconverged:
            telemetry.flight_autodump("nonconverged")

    # -- warmup ------------------------------------------------------------
    def warmup(self, request: SolveRequest, batch_sizes=(1,), pin: bool = True) -> None:
        """Build (and optionally pin) the entries a production signature
        needs: one padded-bucket entry per entry of ``batch_sizes``.  The
        request's coefficient values are only a template — warmup runs each
        entry once on copies of it (the bucket's assembly, one real solve)
        so the first tenant wave is a pure cache hit."""
        key = admission_key(request)
        device = request.plan.device
        with telemetry.span("serve.warmup", backend=request.backend,
                            buckets=len(tuple(batch_sizes))), _on_device(device):
            for bs in batch_sizes:
                padded = min(pad_bucket(int(bs)), self.max_batch)
                if pin:
                    self.cache.pin(key, padded)
                fn, hit = self.cache.get(key, padded, request)
                if not hit:
                    leaves = tuple(_stack_padded([lf], padded, device) for lf in request.leaves)
                    rhs = _stack_padded([request.rhs], padded, device)
                    fn(request.plan, leaves, rhs, 1)
                    synchronize(device)


def _key_tag(key) -> str:
    """Short printable admission-key tag for flight-recorder context (the
    raw key holds object ids and a lowered form signature — not JSON)."""
    plan_id, _form, _bc, backend, spec = key
    return f"plan={plan_id & 0xFFFFFFFF:08x};backend={backend};method={spec.method}"


def _stack_padded(tensors, padded: int, device: torch.device) -> torch.Tensor:
    """Stack per-request tensors to ``(padded, ...)`` on ``device``,
    repeating the last entry into the padding rows."""
    out = torch.stack([torch.as_tensor(t, device=device) for t in tensors])
    if out.shape[0] < padded:
        reps = out[-1:].expand(padded - out.shape[0], *out.shape[1:])
        out = torch.cat([out, reps], dim=0)
    return out
