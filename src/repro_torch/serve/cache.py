"""Persistent executable cache for the solve service.

The torch port of ``repro.serve.cache``.  One cache entry is one batched
solve closure keyed on ``(admission key, padded batch size)``; it is built
once per entry, so evicting an entry drops it.  Entries survive across
requests and waves: after a warmup wave every later wave is a pure cache
hit — no entry built, read from the ``jit_traces{kind=serve}`` counter,
which counts entry builds (the eager counterpart of a jit trace,
:mod:`repro_torch.telemetry.metrics`).  ``pin()``-ed entries (from
:meth:`~repro_torch.serve.service.SolveService.warmup`) are exempt from
LRU eviction.

An entry is an eager closure, not a CUDA graph or a ``torch.compile`` of
the loop: the Krylov loop reads ‖r‖ on the host every iteration
(``repro_torch.core.solvers.cg``), which a graph cannot capture.

**Padding rule.**  An entry assembles the whole padded bucket — for
``csr`` one batched B1 and one batched B2 launch at the bucket's shape, as
the reference's vmapped entry does — but runs the Krylov solve only on the
``n_real`` real rows: the port's batched solves run one instance after
another, so solving the padding rows would cost whole extra solves, and
the reference reads only the real rows of its padded answer.

Every lookup is accounted through ``telemetry.count_cache("serve_exec",
hit)`` and every entry build through ``telemetry.count_trace("serve",
plan, form signature, backend=...)``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import torch

from .. import telemetry
from ..core.assembly import assemble_batched
from ..core.operator import matfree_family
from ..core.solvers import matfree_solve_batched, sparse_solve_batched

__all__ = ["ExecutableCache"]


def _entry_tag(full_key) -> str:
    """Stable short label for one cache entry's gauges."""
    (key, padded) = full_key
    return f"{hash(key) & 0xFFFFFFFF:08x}/B{padded}"


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample_device_memory(device: torch.device) -> None:
    """Record the device-memory gauges ``device_bytes_in_use``,
    ``device_peak_bytes_in_use`` (the caching allocator's current and peak
    allocated bytes) and ``device_bytes_limit`` (the card's total memory).
    A CPU device records nothing."""
    if not telemetry.is_enabled() or device.type != "cuda":
        return
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    label = f"cuda:{device.index}"
    for field, value in (("bytes_in_use", stats.get("allocated_bytes.all.current", 0)),
                         ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak", 0)),
                         ("bytes_limit", total)):
        telemetry.gauge_set(f"device_{field}", float(value), device=label)


def _instrument_compile(fn, full_key, backend, device):
    """Wrap a freshly built entry so its first call — first launches,
    device mirrors staged on the way, the one the reference spends
    compiling — is attributed: ``serve_compile_us`` histogram, a per-entry
    ``serve_exec_compile_us`` gauge, and a device-memory sample once the
    entry has run.  Later calls pay one list check."""
    pending = [True]

    def wrapper(plan, leaves, rhs, n_real):
        if not pending:
            return fn(plan, leaves, rhs, n_real)
        pending.clear()
        t0 = time.perf_counter()
        out = fn(plan, leaves, rhs, n_real)
        synchronize(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
        telemetry.histogram_observe("serve_compile_us", wall_us, backend=backend)
        telemetry.gauge_set("serve_exec_compile_us", wall_us, entry=_entry_tag(full_key))
        _sample_device_memory(device)
        return out

    wrapper.device = device
    return wrapper


def _build_executable(template):
    """One batched-solve closure for a compatibility class, built from a
    representative request.  Signature: ``fn(plan, leaves, rhs, n_real) ->
    (X, info)`` with every coefficient leaf batched ``(B, ...)``, ``rhs:
    (B, n)``, and ``X``/``info`` the solves of the first ``n_real`` rows
    (the padding rule, module docstring).  The template's *values* never
    leak into later batches: the form only contributes its signature."""
    form, bc, backend = template.form, template.bc, template.backend
    spec = template.spec

    if backend == "matfree":

        def run(plan, leaves, rhs, n_real):
            fam = matfree_family(plan, form, leaves_batch=leaves)
            if bc is not None:
                fam = fam.condensed(bc)
                rhs = rhs * bc.free_mask
            fam = dataclasses.replace(fam, batch=n_real)
            return matfree_solve_batched(fam, rhs[:n_real], spec, return_info=True)

    else:

        def run(plan, leaves, rhs, n_real):
            kb = csr_system(plan, form, bc, leaves)
            if bc is not None:
                rhs = rhs * bc.free_mask
            return sparse_solve_batched(kb[:n_real], rhs[:n_real], spec, return_info=True)

    return run


def csr_system(plan, form, bc, leaves):
    """A ``csr`` entry's batched system over the whole padded bucket: one
    batched B1 and one batched B2 launch at the bucket's shape (for P1
    diffusion on a CUDA plan), Dirichlet rows applied when ``bc`` is
    given."""
    kb = assemble_batched(plan, form, leaves_batch=leaves)
    return kb if bc is None else bc.apply_matrix_only(kb)


class ExecutableCache:
    """LRU cache of batched-solve entries with pinning.

    ``capacity`` bounds the number of *unpinned* entries; pinned entries
    (warmed-up production signatures) never count against it and never
    evict.  Thread-safe use is the caller's job — the service only touches
    the cache from its single dispatch thread.
    """

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()
        self._pinned: set = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple, padded_batch: int, template):
        """The entry for ``(key, padded_batch)``, building (and possibly
        evicting) on miss.  Returns ``(fn, hit)``."""
        full_key = (key, padded_batch)
        hit = full_key in self._entries
        telemetry.count_cache("serve_exec", hit)
        if hit:
            self.hits += 1
            self._entries.move_to_end(full_key)
            return self._entries[full_key], True
        self.misses += 1
        telemetry.count_trace("serve", template.plan, template.form_sig,
                              backend=template.backend)
        fn = _instrument_compile(_build_executable(template), full_key, template.backend,
                                 template.plan.device)
        self._entries[full_key] = fn
        telemetry.gauge_set("serve_exec_entries", len(self._entries))
        self._evict()
        return fn, False

    def pin(self, key: tuple, padded_batch: int) -> None:
        """Exempt an entry from eviction (idempotent; the entry need not
        exist yet — pinning is by key)."""
        self._pinned.add((key, padded_batch))

    def unpin(self, key: tuple, padded_batch: int) -> None:
        self._pinned.discard((key, padded_batch))
        self._evict()

    def _evict(self) -> None:
        unpinned = [k for k in self._entries if k not in self._pinned]
        devices = set()
        while len(unpinned) > self.capacity:
            victim = unpinned.pop(0)  # least recently used unpinned entry
            devices.add(self._entries.pop(victim).device)
            self.evictions += 1
            telemetry.counter_inc("serve_cache_evictions")
            telemetry.gauge_set("serve_exec_compile_us", 0.0, entry=_entry_tag(victim))
        if devices:
            telemetry.gauge_set("serve_exec_entries", len(self._entries))
            for device in devices:
                _sample_device_memory(device)

    def clear(self) -> None:
        self._entries.clear()
        self._pinned.clear()

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
