"""Shared rollout machinery for the transient integrators.

The torch port of ``repro.transient.stepping``:

* :func:`segmented_rollout` — the time loop, in place of ``lax.scan``: a
  Python loop over ``step``, optionally split into segments of
  ``checkpoint_every`` steps, each run under
  ``torch.utils.checkpoint.checkpoint`` so the backward pass recomputes a
  segment's intermediate states instead of storing them (autodiff memory
  O(T/segment + segment) instead of O(T)).
* :func:`axpy_csr` — ``α·A + β·B`` for two operators on one sparsity
  pattern; the θ-method and Newmark effective operators are formed once,
  outside the loop, on the pattern (and so with the ELL layout and the
  streaming plans) of ``A``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.sparse import CSR

__all__ = ["segmented_rollout", "axpy_csr"]


def _index(xs, i: int):
    if xs is None:
        return None
    if isinstance(xs, dict):
        return {k: v[i] for k, v in xs.items()}
    return xs[i]


def _stack(ys: list):
    """Stack per-step outputs: tensors along a new leading axis, tuples
    (and named tuples such as ``SolveInfo``) leaf by leaf, Python scalars
    into a host tensor (float64 for floats)."""
    first = ys[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(ys)
    if isinstance(first, tuple):
        leaves = [_stack(list(col)) for col in zip(*ys)]
        return type(first)(*leaves) if hasattr(first, "_fields") else tuple(leaves)
    return torch.tensor(ys, dtype=torch.float64 if isinstance(first, float) else None)


def _run(step, carry, xs, lo: int, hi: int):
    ys = []
    for i in range(lo, hi):
        carry, y = step(carry, _index(xs, i))
        ys.append(y)
    return carry, ys


def segmented_rollout(step, init, xs, length: int, checkpoint_every: int | None = None):
    """Run ``carry, y = step(carry, xs[i])`` for ``i < length`` and return
    ``(carry, ys)`` with the per-step ``y`` stacked along a leading axis.

    ``xs`` is None, a tensor or a dict of tensors with leading axis
    ``length``.  ``checkpoint_every=None`` (or ``>= length``) is a plain
    loop.  Otherwise ``length`` must be divisible by ``checkpoint_every``,
    and each segment runs under ``torch.utils.checkpoint.checkpoint``
    (non-reentrant): its intermediate states are recomputed, not stored,
    in the backward pass."""
    if checkpoint_every is None or checkpoint_every >= length:
        carry, ys = _run(step, init, xs, 0, length)
        return carry, _stack(ys)
    n_seg, rem = divmod(length, checkpoint_every)
    if rem:
        raise ValueError(f"checkpoint_every={checkpoint_every} must divide length={length}")
    carry, ys = init, []
    for s in range(n_seg):
        lo = s * checkpoint_every
        carry, seg = checkpoint(_run, step, carry, xs, lo, lo + checkpoint_every,
                                use_reentrant=False)
        ys.extend(seg)
    return carry, _stack(ys)


def axpy_csr(alpha, a: CSR, beta, b: CSR) -> CSR:
    """``α·A + β·B`` for two CSR operators on one sparsity pattern; the
    result keeps ``A``'s :class:`~repro_torch.core.CSRPattern` object."""
    if a.pattern is not b.pattern and not (
        a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
        and np.array_equal(a.indices, b.indices)
    ):
        raise ValueError("axpy_csr: the two operators must share one sparsity pattern")
    return a.with_vals(alpha * a.vals + beta * b.vals)
