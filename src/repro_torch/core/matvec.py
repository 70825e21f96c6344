"""Unified matvec-backend registry — one dispatch point for the inner loop.

The torch port of ``repro.core.matvec``.  Backend names and what they run:

=============  =============================================================
backend        apply path
=============  =============================================================
``csr``        gather + index-add on the assembled values (plain torch)
``ell``        the ELL SpMV kernel (``repro_torch.kernels.spmv_ell``) over
               the padded ELL layout; ``make_residual`` runs the fused
               residual kernel (``galerkin_residual_ell``)
``ell_pallas`` the same entry as ``ell``
``ell_stream`` the streaming ELL SpMV kernel
               (``repro_torch.kernels.spmv_ell_stream``): each row block
               stages its x-window in shared memory and streams its
               vals/cols tiles through a ``cp.async`` pipeline, on the plan
               the sparsity pattern caches; ``make_residual`` runs the fused
               streaming residual (``galerkin_residual_ell_stream``)
``matfree``    element-local gather → per-element action → scatter-Reduce
               (B2) with no global values
               (:class:`repro_torch.core.operator.MatFreeOperator`)
``matfree_``   the same apply split over the element axis of a mesh of
``sharded``    ranks: each rank's block, then one all-reduce
               (:class:`repro_torch.core.operator.ShardedMatFreeOperator`;
               a ``MatFreeOperator`` is sharded over the default mesh)
=============  =============================================================

Name mapping against ``repro.core.matvec``: there, ``ell`` is plain jnp,
``ell_pallas`` the Pallas TPU kernel of the broadcast plan and
``ell_stream`` the Pallas kernel of the streaming plan.  Here ``ell`` and
``ell_pallas`` both run the broadcast-plan CUDA kernels and ``ell_stream``
the streaming ones, on CUDA tensors, and their plain versions on CPU
tensors, so the names of both registries select the same arithmetic.

``make_matvec(op, backend)`` returns the apply closure;
``make_residual(op, backend)`` returns ``(u, f) ↦ K·u − f``.  Further
backends register with :func:`register_matvec_backend`.
"""

from __future__ import annotations

from typing import Callable

from .. import telemetry
from ..kernels.ops import ell_matvec, ell_matvec_stream, ell_residual, ell_residual_stream
from .operator import LinearOperator, MatFreeOperator, ShardedMatFreeOperator
from .sparse import CSR, csr_to_ell

__all__ = [
    "MATVEC_BACKENDS",
    "matvec_backends",
    "register_matvec_backend",
    "make_matvec",
    "make_residual",
]


def _require_csr(op, backend: str) -> CSR:
    if not isinstance(op, CSR):
        raise TypeError(
            f"backend {backend!r} needs an assembled CSR operator, got {type(op).__name__} — "
            "assemble first, or use backend='matfree'"
        )
    return op


def _require_matfree(op, backend: str = "matfree") -> LinearOperator:
    if isinstance(op, CSR):
        raise TypeError(
            f"backend {backend!r} needs a matrix-free operator: build one with "
            "repro_torch.core.matfree_operator(plan, form) instead of assembling"
        )
    if not isinstance(op, LinearOperator):
        raise TypeError(f"backend {backend!r} needs a LinearOperator, got {type(op).__name__}")
    return op


def _csr_matvec(op) -> Callable:
    return op.matvec


def _csr_residual(op) -> Callable:
    return lambda u, f: op.matvec(u) - f


def _ell_matvec(op) -> Callable:
    ell = csr_to_ell(_require_csr(op, "ell"))
    return lambda x: ell_matvec(ell, x)


def _ell_residual(op) -> Callable:
    ell = csr_to_ell(_require_csr(op, "ell"))
    return lambda u, f: ell_residual(ell, u, f)


def _ell_stream_matvec(op) -> Callable:
    ell = csr_to_ell(_require_csr(op, "ell_stream"))
    return lambda x: ell_matvec_stream(ell, x)


def _ell_stream_residual(op) -> Callable:
    ell = csr_to_ell(_require_csr(op, "ell_stream"))
    return lambda u, f: ell_residual_stream(ell, u, f)


def _matfree_matvec(op) -> Callable:
    return _require_matfree(op).matvec


def _matfree_residual(op) -> Callable:
    mv = _require_matfree(op).matvec
    return lambda u, f: mv(u) - f


def _as_sharded(op) -> ShardedMatFreeOperator:
    op = _require_matfree(op, "matfree_sharded")
    if isinstance(op, ShardedMatFreeOperator):
        return op
    if isinstance(op, MatFreeOperator):
        return op.sharded()
    raise TypeError("backend 'matfree_sharded' needs a MatFreeOperator (or an already "
                    f"sharded one), got {type(op).__name__}")


def _matfree_sharded_matvec(op) -> Callable:
    return _as_sharded(op).matvec


def _matfree_sharded_residual(op) -> Callable:
    mv = _as_sharded(op).matvec
    return lambda u, f: mv(u) - f


# name -> (matvec factory, residual factory)
_BACKENDS: dict[str, tuple[Callable, Callable]] = {
    "csr": (_csr_matvec, _csr_residual),
    "ell": (_ell_matvec, _ell_residual),
    "ell_pallas": (_ell_matvec, _ell_residual),
    "ell_stream": (_ell_stream_matvec, _ell_stream_residual),
    "matfree": (_matfree_matvec, _matfree_residual),
    "matfree_sharded": (_matfree_sharded_matvec, _matfree_sharded_residual),
}

# the built-in backend names (custom ones appear in matvec_backends())
MATVEC_BACKENDS = tuple(_BACKENDS)


def matvec_backends() -> tuple[str, ...]:
    """The currently registered backend names (built-ins + custom)."""
    return tuple(_BACKENDS)


def register_matvec_backend(name: str, matvec_factory: Callable,
                            residual_factory: Callable | None = None,
                            *, overwrite: bool = False) -> None:
    """Register a custom backend: ``matvec_factory(op) -> (x ↦ A x)`` and an
    optional fused-residual factory (defaults to ``matvec(u) − f``)."""
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"matvec backend {name!r} already registered")
    if residual_factory is None:
        def residual_factory(op, _mf=matvec_factory):
            mv = _mf(op)
            return lambda u, f: mv(u) - f
    _BACKENDS[name] = (matvec_factory, residual_factory)


def _lookup(backend: str):
    entry = _BACKENDS.get(backend)
    if entry is None:
        raise ValueError(f"unknown matvec backend {backend!r}; use one of {tuple(_BACKENDS)}")
    return entry


def make_matvec(op, backend: str = "csr") -> Callable:
    """``x ↦ A @ x`` for the chosen inner-loop backend (table above)."""
    telemetry.counter_inc("matvec_backend", 1, backend=backend, role="matvec")
    return _lookup(backend)[0](op)


def make_residual(op, backend: str = "csr") -> Callable:
    """``(u, f) ↦ A·u − f``, fused where the backend supports it."""
    telemetry.counter_inc("matvec_backend", 1, backend=backend, role="residual")
    return _lookup(backend)[1](op)
