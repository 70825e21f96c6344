"""ELL SpMV and fused Galerkin residual, on two plans: the wrappers of the
CUDA kernels in ``csrc/spmv_ell.cu`` and ``csrc/spmv_ell_stream.cu`` (the
ports of the Pallas kernels ``repro.kernels.spmv_ell.spmv_ell``,
``galerkin_residual_ell``, ``spmv_ell_stream`` and
``galerkin_residual_ell_stream``).

The column table is int32 and padded slots point back at their own row
with a zero value (:meth:`repro_torch.core.sparse.CSRPattern.ell_layout`
builds it so); the kernels rely on that and do not test slots.

* :func:`spmv_ell` / :func:`galerkin_residual_ell` — the **broadcast**
  plan: every row gathers from the whole of ``x``.
* :func:`spmv_ell_stream` / :func:`galerkin_residual_ell_stream` — the
  **streaming** plan: a :class:`StreamPlan` (host precompute on the static
  column table) rebases the columns of each ``block_n``-row block into the
  block's x-window ``[start_b, start_b + W)``.  On the card each block
  stages its window in shared memory and streams its ``vals``/``cols``
  tiles through an ``nbuf``-deep ``cp.async`` pipeline; the footprint
  (:func:`stream_smem_bytes`) does not depend on N and is checked against
  the card's opt-in shared-memory limit before launch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import telemetry
from . import _cuda
from .ref import (
    galerkin_residual_ell_ref,
    galerkin_residual_ell_stream_ref,
    spmv_ell_ref,
    spmv_ell_stream_ref,
)

__all__ = [
    "spmv_ell",
    "galerkin_residual_ell",
    "StreamPlan",
    "StreamPlans",
    "spmv_ell_stream",
    "galerkin_residual_ell_stream",
    "stream_smem_bytes",
    "check_stream_fits",
    "autotune_stream",
]

# streaming defaults: 269 blocks of 1024 rows at the 3D main path, about two
# waves on the 132 SMs (see the header of csrc/spmv_ell_stream.cu)
BLOCK_N = 1024
N_BUFFERS = 2
MAX_BUFFERS = 4         # pipeline depths the kernel's cp.async waits cover
TILE_ROWS = 128         # rows per pipelined vals/cols/f tile (kTileRows in the .cu)
_LANE = 128             # window length granularity (the JAX plan's, kept for equal plans)


def _check_shapes(name, vals, cols, *vecs):
    if vals.dim() != 2 or tuple(cols.shape) != tuple(vals.shape):
        raise ValueError(f"{name}: vals and cols must both be (N, L), got "
                         f"{tuple(vals.shape)} and {tuple(cols.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be int32, got {cols.dtype}")
    for v in vecs:
        if tuple(v.shape) != (vals.shape[0],):
            raise ValueError(f"{name}: vectors must be ({vals.shape[0]},), got {tuple(v.shape)}")


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """vals/cols (N, L), x (N,) → y = Σ_l vals[:, l]·x[cols[:, l]] (N,).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_shapes("spmv_ell", vals, cols, x)
    if all(t.device.type == "cpu" for t in (vals, cols, x)):
        return spmv_ell_ref(vals, cols, x)
    dtype = _cuda.check_operands("spmv_ell", {"vals": vals, "cols": cols, "x": x})
    n, width = vals.shape
    y = torch.empty(n, dtype=dtype, device=vals.device)
    if n:
        _cuda.launch("spmv_ell", "spmv_ell", _cuda.symbol("tg_spmv_ell", dtype),
                     vals, cols, x, y, n, width)
    return y


def galerkin_residual_ell(vals: torch.Tensor, cols: torch.Tensor, u: torch.Tensor,
                          f: torch.Tensor) -> torch.Tensor:
    """Fused r = K·u − f in one pass over the ELL operator.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_shapes("galerkin_residual_ell", vals, cols, u, f)
    if all(t.device.type == "cpu" for t in (vals, cols, u, f)):
        return galerkin_residual_ell_ref(vals, cols, u, f)
    dtype = _cuda.check_operands("galerkin_residual_ell",
                                 {"vals": vals, "cols": cols, "u": u, "f": f})
    n, width = vals.shape
    r = torch.empty(n, dtype=dtype, device=vals.device)
    if n:
        _cuda.launch("galerkin_residual_ell", "spmv_ell",
                     _cuda.symbol("tg_residual_ell", dtype), vals, cols, u, f, r, n, width)
    return r


# ---------------------------------------------------------------------------
# streaming plan
# ---------------------------------------------------------------------------

class StreamPlan:
    """Static streaming schedule of one column table at one ``block_n``:
    ``cols_local`` (n_pad, L) int32 rebased into ``[0, W)``, the per-block
    window starts ``starts`` (n_blocks,) int32, the uniform window width
    ``window`` (W, a multiple of 128), ``n_pad`` and ``x_len`` (the length x
    is zero-padded to on the TPU).  The arrays equal the JAX
    ``_StreamPlan``'s; :meth:`staged` mirrors them to a device once."""

    def __init__(self, cols: np.ndarray, block_n: int):
        cols = np.asarray(cols)
        if cols.ndim != 2:
            raise ValueError(f"StreamPlan: cols must be (N, L), got {cols.shape}")
        block_n = int(block_n)
        if block_n < 1:
            raise ValueError(f"StreamPlan: block_n must be positive, got {block_n}")
        n, l = cols.shape
        n_blocks = -(-n // block_n)
        n_pad = n_blocks * block_n
        cols_pad = np.empty((n_pad, l), dtype=np.int64)
        cols_pad[:n] = cols
        if n_pad > n:
            # padded rows get in-window dummies (their vals are zero)
            cols_pad[n:] = cols[n - 1, 0]
        blocks = cols_pad.reshape(n_blocks, block_n * l)
        lo = blocks.min(axis=1)
        hi = blocks.max(axis=1)
        width = int((hi - lo + 1).max()) if n_blocks else 1
        self.window = -(-width // _LANE) * _LANE
        self.starts = lo.astype(np.int32)
        local = cols_pad - np.repeat(self.starts.astype(np.int64), block_n)[:, None]
        self.cols_local = local.astype(np.int32)
        self.n_pad = n_pad
        self.x_len = int(max(n, (self.starts.astype(np.int64) + self.window).max()
                             if n_blocks else n))
        self.block_n, self.n_rows, self.width = block_n, n, l
        self._staged: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
        telemetry.gauge_set("ell_stream_window", self.window, block_n=block_n)

    @property
    def n_blocks(self) -> int:
        return self.n_pad // self.block_n

    def staged(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(cols_local, starts)`` on ``device``, uploaded once."""
        device = torch.device(device)
        hit = self._staged.get(device)
        if hit is None:
            hit = self._staged[device] = (torch.from_numpy(self.cols_local).to(device),
                                          torch.from_numpy(self.starts).to(device))
        return hit

    def smem_bytes(self, nbuf: int, itemsize: int) -> int:
        return stream_smem_bytes(self.width, block_n=self.block_n, nbuf=nbuf,
                                 window=self.window, itemsize=itemsize)


class StreamPlans:
    """The streaming plans of one static column table, built once per
    ``block_n`` (calling the object returns one), and ``tuned``: the
    ``(block_n, nbuf)`` :func:`autotune_stream` picked, per dtype."""

    def __init__(self, cols: np.ndarray):
        self.cols = np.asarray(cols)
        self._plans: dict[int, StreamPlan] = {}
        self.tuned: dict[torch.dtype, tuple[int, int]] = {}

    def __call__(self, block_n: int = BLOCK_N) -> StreamPlan:
        plan = self._plans.get(block_n)
        if plan is None:
            plan = self._plans[block_n] = StreamPlan(self.cols, block_n)
        return plan


def stream_smem_bytes(l: int, *, block_n: int = BLOCK_N, nbuf: int = N_BUFFERS,
                      window: int | None = None, itemsize: int = 8) -> int:
    """Shared memory one CUDA block of the streaming kernel takes
    (independent of N): the x-window, single-buffered, plus ``nbuf`` tiles
    of ``min(TILE_ROWS, block_n)`` rows of vals, int32 cols and f."""
    w = window if window is not None else block_n + _LANE
    return w * itemsize + nbuf * min(TILE_ROWS, block_n) * (l * (itemsize + 4) + itemsize)


def check_stream_fits(plan: StreamPlan, nbuf: int, itemsize: int, limit: int) -> int:
    """Raise ``ValueError`` unless the plan at depth ``nbuf`` fits in
    ``limit`` bytes of shared memory per block; returns the footprint."""
    need = plan.smem_bytes(nbuf, itemsize)
    if need > limit:
        raise ValueError(
            f"streaming SpMV plan does not fit: W={plan.window}, block_n={plan.block_n}, "
            f"nbuf={nbuf}, L={plan.width}, itemsize={itemsize} need {need} bytes of shared "
            f"memory per block, the card allows {limit}; use a smaller block_n or nbuf"
        )
    return need


def _smem_limit(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def _as_plan(cols, block_n: int | None, n: int) -> StreamPlan:
    if isinstance(cols, StreamPlan):
        if block_n is not None and block_n != cols.block_n:
            raise ValueError(f"block_n={block_n} given with a plan built for {cols.block_n}")
        plan = cols
    elif isinstance(cols, torch.Tensor) and cols.device.type != "cpu":
        raise TypeError("the streaming plan is a host precompute: pass a StreamPlan or the "
                        "host (N, L) column table, not a tensor on " + str(cols.device))
    else:
        plan = StreamPlan(cols, BLOCK_N if block_n is None else block_n)
    if plan.n_rows != n:
        raise ValueError(f"plan has {plan.n_rows} rows, vals has {n}")
    return plan


def _stream(name, base, vals, cols, vecs, block_n, nbuf, ref):
    """Shared body of the two streaming wrappers (``name`` is also the
    launch counter): ``vecs`` is ``{"x": x}`` or ``{"u": u, "f": f}``."""
    if not isinstance(nbuf, int) or not 1 <= nbuf <= MAX_BUFFERS:
        raise ValueError(f"{name}: nbuf must be an int in [1, {MAX_BUFFERS}], got {nbuf!r}")
    if vals.dim() != 2:
        raise ValueError(f"{name}: vals must be (N, L), got {tuple(vals.shape)}")
    n, width = vals.shape
    plan = _as_plan(cols, block_n, n)
    if plan.width != width:
        raise ValueError(f"{name}: plan has L={plan.width}, vals has L={width}")
    for v in vecs.values():
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name}: vectors must be ({n},), got {tuple(v.shape)}")
    if all(t.device.type == "cpu" for t in (vals, *vecs.values())):
        return ref(vals, *plan.staged("cpu"), *vecs.values(), plan.block_n, plan.x_len)
    dtype = _cuda.check_operands(name, {"vals": vals, **vecs})
    check_stream_fits(plan, nbuf, vals.element_size(), _smem_limit(vals.device))
    cols_local, starts = plan.staged(vals.device)
    y = torch.empty(n, dtype=dtype, device=vals.device)
    if n:
        _cuda.launch(name, "spmv_ell_stream", _cuda.symbol(base, dtype), vals, cols_local,
                     starts, *vecs.values(), y, n, width, plan.block_n, plan.window, nbuf)
    return y


def spmv_ell_stream(vals: torch.Tensor, cols, x: torch.Tensor, *, block_n: int | None = None,
                    nbuf: int = N_BUFFERS) -> torch.Tensor:
    """Streaming SpMV: vals (N, L), x (N,) → y (N,).  ``cols`` is a
    :class:`StreamPlan` or the host (N, L) column table (a plan is then
    built for this call at ``block_n``, default :data:`BLOCK_N`).

    CPU tensors take the plain version, which walks the plan; CUDA tensors
    launch the kernel, after checking that the plan fits shared memory."""
    return _stream("spmv_ell_stream", "tg_spmv_ell_stream", vals, cols, {"x": x}, block_n,
                   nbuf, spmv_ell_stream_ref)


def galerkin_residual_ell_stream(vals: torch.Tensor, cols, u: torch.Tensor, f: torch.Tensor,
                                 *, block_n: int | None = None,
                                 nbuf: int = N_BUFFERS) -> torch.Tensor:
    """Fused streaming residual r = K·u − f (see :func:`spmv_ell_stream`)."""
    return _stream("galerkin_residual_ell_stream", "tg_residual_ell_stream", vals, cols,
                   {"u": u, "f": f}, block_n, nbuf, galerkin_residual_ell_stream_ref)


# ---------------------------------------------------------------------------
# autotune: pick (block_n, nbuf) by measurement, record via telemetry
# ---------------------------------------------------------------------------

def autotune_stream(vals: torch.Tensor, cols, x: torch.Tensor, *,
                    block_candidates=(1024, 4096, 8192), nbuf_candidates=(2, 3),
                    iters: int = 3) -> tuple[int, int]:
    """Time :func:`spmv_ell_stream` over ``block_n × nbuf`` candidates and
    return the fastest pair.  ``cols`` is a :class:`StreamPlans` (the plans
    and the result are cached on it, per dtype) or the host column table.
    On a card, candidates whose shared-memory footprint exceeds the opt-in
    limit are skipped.  Every measurement lands in the telemetry histogram
    ``ell_stream_autotune_us`` (block_n/nbuf labels); the gauges
    ``ell_stream_block_n`` / ``ell_stream_nbuf`` hold the winner."""
    plans = cols if isinstance(cols, StreamPlans) else StreamPlans(cols)
    hit = plans.tuned.get(vals.dtype)
    if hit is not None:
        return hit
    n = vals.shape[0]
    cuda = vals.device.type == "cuda"
    limit = _smem_limit(vals.device) if cuda else None
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    best, best_t = None, float("inf")
    for bn in block_candidates:
        if bn > max(n, _LANE):
            continue
        plan = plans(bn)
        for nb in nbuf_candidates:
            if limit is not None and plan.smem_bytes(nb, vals.element_size()) > limit:
                continue
            spmv_ell_stream(vals, plan, x, nbuf=nb)  # stage the plan outside the timed loop
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                spmv_ell_stream(vals, plan, x, nbuf=nb)
            sync()
            us = (time.perf_counter() - t0) / iters * 1e6
            telemetry.histogram_observe("ell_stream_autotune_us", us, block_n=bn, nbuf=nb)
            if us < best_t:
                best, best_t = (bn, nb), us
    if best is None:
        best = (min(BLOCK_N, max(_LANE, n)), N_BUFFERS)
    telemetry.gauge_set("ell_stream_block_n", best[0])
    telemetry.gauge_set("ell_stream_nbuf", best[1])
    plans.tuned[vals.dtype] = best
    return best
