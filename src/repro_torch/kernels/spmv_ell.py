"""ELL SpMV and fused Galerkin residual, on two plans: the wrappers of the
CUDA kernels in ``csrc/spmv_ell.cu`` and ``csrc/spmv_ell_stream.cu`` (the
ports of the Pallas kernels ``repro.kernels.spmv_ell.spmv_ell``,
``galerkin_residual_ell``, ``spmv_ell_stream`` and
``galerkin_residual_ell_stream``).

The column table is int32 and padded slots point back at their own row
with a zero value (:meth:`repro_torch.core.sparse.CSRPattern.ell_layout`
builds it so); the kernels rely on that and do not test slots.

* :func:`spmv_ell` / :func:`galerkin_residual_ell` — the **broadcast**
  plan: every row gathers from the whole of ``x``.  The kernel makes one
  pass over 32-row warp tiles: each warp bulk-copies its tile's vals and
  cols into shared memory, and lane i sums row i.  Rows past 32 slots
  whose 32-row stage is below 32 KiB take the same design with one warp
  per CTA; still wider rows take a warp per row (header of
  ``csrc/spmv_ell.cu``; the library reports its choice,
  ``tg_ell_variant_f32/f64``).
* :func:`spmv_ell_stream` / :func:`galerkin_residual_ell_stream` — the
  **streaming** plan: a :class:`StreamPlan` (host precompute on the static
  column table) rebases the columns of each ``block_n``-row block into the
  block's x-window ``[start_b, start_b + W)``.

The streaming kernel replaces the TPU kernel's sequential walk over the row
blocks with a persistent CTA per SM that walks a run of ``TILE_ROWS``-row
tiles in order.  What bounds it is memory (vals and cols are read once);
what the design does about it:

1. *No wave tail*: one CTA per SM (as many as fit), the tiles balanced over
   the CTAs within one tile (:func:`stream_runs`); a run may start or end
   inside a plan block.
2. *The window load is hidden*: each CTA keeps x in a ring of
   ``plan.ring`` elements of shared memory (R ≥ W plus the plan's largest
   forward step of ``starts``, up to W), and moving on to the next block
   copies only ``x[load_lo[b], start_b + W)``, issued while the previous
   block's last tiles are still summed.  Where ``starts`` goes down or
   jumps further than the ring allows (``load_lo[b] < 0``), and at the
   start of a run, it waits for the previous block and loads the whole
   window.
3. *A deep, cheap pipeline*: one producer warp feeds an ``nbuf``-stage ring
   of ``TILE_ROWS``-row vals/cols/f tiles with bulk copies (the 1-D TMA
   copy, one per lane), each fill one mbarrier arrival, each hand-back a
   named barrier; the unaligned ends of a copy go word by word.  The
   default depth is the deepest up to :data:`N_BUFFERS` that fits
   (:meth:`StreamPlan.depth`).
4. *Fewer re-read windows*: x is copied about once per CTA run instead of
   once per block, and never past N.

The schedule (``plan.ring``, ``plan.load_lo``, the CTA runs) is host-side
numpy, staged on a device once with the plan; the footprint
(:func:`stream_smem_bytes`: ring + stages + barriers) does not depend on N
and is checked against the card's opt-in shared-memory limit before launch.

Gradients.  The four wrappers are differentiable in ``vals`` and the
vectors on every device, as the reference's jnp ``ell`` is.  Where grad is
enabled and an input requires it, the call goes through an
:class:`torch.autograd.Function` whose forward is the same kernel (or, on
the CPU, the same plain version) and whose backward is plain torch on the
same device, as the JAX package has no backward kernel:
``vals̄[r, l] = ȳ[r]·x[cols[r, l]]``, ``x̄ = Σ vals[r, l]·ȳ[r]`` scattered
onto ``cols[r, l]`` with ``index_add_``, and ``f̄ = −ȳ`` for the residuals;
the streaming pair scatters in global columns (:meth:`StreamPlan.global_cols`).
Padded slots get a nonzero ``vals̄`` (ȳ[r]·x[r]), which
:func:`repro_torch.core.sparse.csr_to_ell` drops on its way back to the CSR
values.  Otherwise the wrappers launch directly, with no autograd node.
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
    "stream_runs",
    "check_stream_fits",
    "autotune_stream",
]

# streaming defaults (see the header of csrc/spmv_ell_stream.cu)
BLOCK_N = 1024          # the plan's window granularity
N_BUFFERS = 4           # default stage depth, or the deepest that fits below it
MAX_BUFFERS = 8         # kMaxBuffers in the .cu
TILE_ROWS = 128         # rows per vals/cols/f stage (kTileRows in the .cu)
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


def _needs_graph(*tensors) -> bool:
    """Whether a call must record an autograd node: grad is enabled and an
    input requires it."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _ell_vjp(vals, cols, x, gy, need_vals, need_x):
    """``(vals̄, x̄)`` of y = Σ_l vals[:, l]·x[cols[:, l]] for the cotangent
    ``gy``, in plain torch on ``gy``'s device; ``None`` where not needed."""
    idx = cols.long()
    g_vals = gy[:, None] * x[idx] if need_vals else None
    g_x = None
    if need_x:
        g_x = torch.zeros_like(x).index_add_(0, idx.reshape(-1),
                                             (vals * gy[:, None]).reshape(-1))
    return g_vals, g_x


def _spmv_ell(vals, cols, x):
    if all(t.device.type == "cpu" for t in (vals, cols, x)):
        return spmv_ell_ref(vals, cols, x)
    dtype = _cuda.check_operands("spmv_ell", {"vals": vals, "cols": cols, "x": x})
    n, width = vals.shape
    y = torch.empty(n, dtype=dtype, device=vals.device)
    if n:
        _cuda.launch("spmv_ell", "spmv_ell", _cuda.symbol("tg_spmv_ell", dtype),
                     vals, cols, x, y, n, width)
    return y


def _residual_ell(vals, cols, u, f):
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


class _Ell(torch.autograd.Function):
    """B3 (``f`` None) or B4 around the kernel, with the backward of
    y = Σ_l vals[:, l]·x[cols[:, l]] (− f)."""

    @staticmethod
    def forward(ctx, vals, cols, x, f):
        ctx.save_for_backward(vals, cols, x)
        return _spmv_ell(vals, cols, x) if f is None else _residual_ell(vals, cols, x, f)

    @staticmethod
    def backward(ctx, gy):
        vals, cols, x = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_vals, g_x = _ell_vjp(vals, cols, x, gy, need[0], need[2])
        return g_vals, None, g_x, -gy if need[3] else None


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """vals/cols (N, L), x (N,) → y = Σ_l vals[:, l]·x[cols[:, l]] (N,).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable in ``vals`` and ``x`` (module docstring)."""
    _check_shapes("spmv_ell", vals, cols, x)
    if _needs_graph(vals, x):
        return _Ell.apply(vals, cols, x, None)
    return _spmv_ell(vals, cols, x)


def galerkin_residual_ell(vals: torch.Tensor, cols: torch.Tensor, u: torch.Tensor,
                          f: torch.Tensor) -> torch.Tensor:
    """Fused r = K·u − f in one pass over the ELL operator.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable in ``vals``, ``u`` and ``f``."""
    _check_shapes("galerkin_residual_ell", vals, cols, u, f)
    if _needs_graph(vals, u, f):
        return _Ell.apply(vals, cols, u, f)
    return _residual_ell(vals, cols, u, f)


# ---------------------------------------------------------------------------
# streaming plan
# ---------------------------------------------------------------------------

class StreamPlan:
    """Static streaming schedule of one column table at one ``block_n``:
    ``cols_local`` (n_pad, L) int32 rebased into ``[0, W)``, the per-block
    window starts ``starts`` (n_blocks,) int32, the uniform window width
    ``window`` (W, a multiple of 128), ``n_pad`` and ``x_len`` (the length x
    is zero-padded to on the TPU).  The arrays equal the JAX
    ``_StreamPlan``'s; :meth:`staged` mirrors them to a device once.

    The CUDA kernel's schedule on top: ``ring`` (R, the x-ring's length:
    W plus the largest forward step of ``starts``, capped at W, rounded up
    to 128) and ``load_lo`` (n_blocks,) int32: where block b follows b − 1
    in a CTA's run, the ring slides and the kernel copies
    ``x[load_lo[b], starts[b] + W)``; ``load_lo[b] = -1`` (``starts`` goes
    down, or steps further than R − W) makes it reload the whole window."""

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

        starts64 = self.starts.astype(np.int64)
        steps = np.diff(starts64)
        slide = min(max(int(steps.max(initial=0)), 0), self.window)
        self.ring = self.window + -(-slide // _LANE) * _LANE
        load_lo = np.full(n_blocks, -1, dtype=np.int64)
        slides = (steps >= 0) & (steps <= self.ring - self.window)
        load_lo[1:][slides] = np.maximum(starts64[:-1] + self.window, starts64[1:])[slides]
        self.load_lo = load_lo.astype(np.int32)

        self._staged: dict[torch.device, tuple[torch.Tensor, ...]] = {}
        self._global: dict[torch.device, torch.Tensor] = {}
        self._runs: dict[tuple, tuple[torch.Tensor, int]] = {}
        telemetry.gauge_set("ell_stream_window", self.window, block_n=block_n)

    @property
    def n_blocks(self) -> int:
        return self.n_pad // self.block_n

    @property
    def tiles_per_block(self) -> int:
        return -(-self.block_n // TILE_ROWS)

    @property
    def n_tiles(self) -> int:
        """Tiles of at most ``TILE_ROWS`` rows, none straddling a block."""
        if self.n_rows == 0:
            return 0
        last = self.n_rows - (self.n_blocks - 1) * self.block_n
        return (self.n_blocks - 1) * self.tiles_per_block + -(-last // TILE_ROWS)

    def _upload(self, device) -> tuple[torch.Tensor, ...]:
        device = torch.device(device)
        hit = self._staged.get(device)
        if hit is None:
            hit = self._staged[device] = tuple(
                torch.from_numpy(a).to(device) for a in (self.cols_local, self.starts,
                                                         self.load_lo))
        return hit

    def staged(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(cols_local, starts)`` on ``device``, uploaded once."""
        return self._upload(device)[:2]

    def global_cols(self, device) -> torch.Tensor:
        """(N, L) int32 global column table on ``device`` (``starts[b] +
        cols_local`` of each row), rebuilt from the plan and uploaded once:
        the columns the backward gathers and scatters in."""
        device = torch.device(device)
        hit = self._global.get(device)
        if hit is None:
            n = self.n_rows
            start = np.repeat(self.starts.astype(np.int64), self.block_n)[:n, None]
            cols = (self.cols_local[:n].astype(np.int64) + start).astype(np.int32)
            hit = self._global[device] = torch.from_numpy(cols).to(device)
        return hit

    def schedule(self, device, nbuf: int, itemsize: int) -> tuple[torch.Tensor, torch.Tensor, int]:
        """``(load_lo, runs, n_ctas)`` of a launch on the CUDA ``device`` at
        depth ``nbuf``: one CTA for each that fits the card's SMs (at most
        one per tile) and its run of tiles; built and uploaded once."""
        device = torch.device(device)
        key = (device, nbuf, itemsize)
        hit = self._runs.get(key)
        if hit is None:
            n_ctas = min(self.n_tiles, _cta_slots(device, self.width,
                                                  self.smem_bytes(nbuf, itemsize), itemsize))
            runs = torch.from_numpy(stream_runs(self.n_tiles, n_ctas)).to(device)
            hit = self._runs[key] = (runs, n_ctas)
        return (self._upload(device)[2], *hit)

    def smem_bytes(self, nbuf: int, itemsize: int) -> int:
        return stream_smem_bytes(self.width, self.ring, nbuf=nbuf, itemsize=itemsize)

    def depth(self, itemsize: int, limit: int) -> int:
        """The default stage depth: :data:`N_BUFFERS`, or the deepest below
        it whose footprint fits ``limit`` bytes (1 if none does, which
        :func:`check_stream_fits` then refuses)."""
        nbuf = N_BUFFERS
        while nbuf > 1 and self.smem_bytes(nbuf, itemsize) > limit:
            nbuf -= 1
        return nbuf


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


def stream_smem_bytes(l: int, ring: int, *, nbuf: int = N_BUFFERS, itemsize: int = 8) -> int:
    """Dynamic shared memory of one CTA of the streaming kernel
    (independent of N): the x-ring of ``ring`` elements, ``nbuf`` stages of
    ``TILE_ROWS`` rows of vals, int32 cols and f (each with 16 bytes of
    room to land at its source's address modulo 16), and the mbarriers
    (one per stage, two window and two block-done barriers)."""
    stage = TILE_ROWS * l * (itemsize + 4) + TILE_ROWS * itemsize + 3 * 16
    return ring * itemsize + nbuf * stage + 8 * (nbuf + 4)


def stream_runs(n_tiles: int, n_ctas: int) -> np.ndarray:
    """(n_ctas + 1,) int32: CTA c walks tiles ``runs[c] .. runs[c + 1]``;
    the runs differ by at most one tile."""
    c = np.arange(n_ctas + 1, dtype=np.int64)
    return (c * n_tiles // max(n_ctas, 1)).astype(np.int32)


def check_stream_fits(plan: StreamPlan, nbuf: int, itemsize: int, limit: int) -> int:
    """Raise ``ValueError`` unless the plan at depth ``nbuf`` fits in
    ``limit`` bytes of shared memory per block; returns the footprint."""
    need = plan.smem_bytes(nbuf, itemsize)
    if need > limit:
        raise ValueError(
            f"streaming SpMV plan does not fit: W={plan.window}, block_n={plan.block_n}, "
            f"nbuf={nbuf}, L={plan.width}, itemsize={itemsize}, ring R={plan.ring} need "
            f"{need} bytes of shared memory per block, the card allows {limit}; use a "
            f"smaller block_n or nbuf"
        )
    return need


def _smem_limit(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def _cta_slots(device: torch.device, width: int, smem: int, itemsize: int) -> int:
    """CTAs of the streaming kernel the card holds at once: SMs × the
    occupancy API's CTAs per SM at this footprint."""
    per_sm = _cuda.query("spmv_ell_stream", f"tg_stream_ctas_per_sm_f{8 * itemsize}", device,
                         width, smem)
    if per_sm < 1:
        raise ValueError(f"the streaming kernel does not fit an SM at {smem} bytes of shared "
                         "memory")
    return torch.cuda.get_device_properties(device).multi_processor_count * per_sm


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
    launch counter): ``vecs`` is ``{"x": x}`` or ``{"u": u, "f": f}``.
    Checks the operands, then launches directly or through
    :class:`_StreamEll` when the call must record an autograd node."""
    if nbuf is not None and (not isinstance(nbuf, int) or not 1 <= nbuf <= MAX_BUFFERS):
        raise ValueError(f"{name}: nbuf must be None or an int in [1, {MAX_BUFFERS}], "
                         f"got {nbuf!r}")
    if vals.dim() != 2:
        raise ValueError(f"{name}: vals must be (N, L), got {tuple(vals.shape)}")
    n, width = vals.shape
    plan = _as_plan(cols, block_n, n)
    if plan.width != width:
        raise ValueError(f"{name}: plan has L={plan.width}, vals has L={width}")
    for v in vecs.values():
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name}: vectors must be ({n},), got {tuple(v.shape)}")
    if _needs_graph(vals, *vecs.values()):
        x, f = (*vecs.values(), None)[:2]
        return _StreamEll.apply((name, base, ref, plan, nbuf, tuple(vecs)), vals, x, f)
    return _stream_forward(name, base, ref, plan, nbuf, vals, vecs)


def _stream_forward(name, base, ref, plan, nbuf, vals, vecs):
    n, width = vals.shape
    if all(t.device.type == "cpu" for t in (vals, *vecs.values())):
        return ref(vals, *plan.staged("cpu"), *vecs.values(), plan.block_n, plan.x_len)
    dtype = _cuda.check_operands(name, {"vals": vals, **vecs})
    itemsize = vals.element_size()
    limit = _smem_limit(vals.device)
    if nbuf is None:
        nbuf = plan.depth(itemsize, limit)
    smem = check_stream_fits(plan, nbuf, itemsize, limit)
    y = torch.empty(n, dtype=dtype, device=vals.device)
    if n:
        cols_local, starts = plan.staged(vals.device)
        load_lo, runs, n_ctas = plan.schedule(vals.device, nbuf, itemsize)
        _cuda.launch(name, "spmv_ell_stream", _cuda.symbol(base, dtype), vals, cols_local,
                     starts, load_lo, runs, *vecs.values(), y, n, width, plan.block_n,
                     plan.window, plan.ring, nbuf, n_ctas, smem)
    return y


class _StreamEll(torch.autograd.Function):
    """The streaming SpMV (``f`` None) or residual around the kernel, with
    its backward in the plan's global columns."""

    @staticmethod
    def forward(ctx, how, vals, x, f):
        name, base, ref, plan, nbuf, keys = how
        ctx.plan = plan
        ctx.save_for_backward(vals, x)
        return _stream_forward(name, base, ref, plan, nbuf, vals, dict(zip(keys, (x, f))))

    @staticmethod
    def backward(ctx, gy):
        vals, x = ctx.saved_tensors
        need = ctx.needs_input_grad  # (how, vals, x or u, f)
        g_vals, g_x = _ell_vjp(vals, ctx.plan.global_cols(gy.device), x, gy, need[1], need[2])
        return None, g_vals, g_x, -gy if need[3] else None


def spmv_ell_stream(vals: torch.Tensor, cols, x: torch.Tensor, *, block_n: int | None = None,
                    nbuf: int | None = None) -> torch.Tensor:
    """Streaming SpMV: vals (N, L), x (N,) → y (N,).  ``cols`` is a
    :class:`StreamPlan` or the host (N, L) column table (a plan is then
    built for this call at ``block_n``, default :data:`BLOCK_N`).  ``nbuf``
    is the stage depth, by default :meth:`StreamPlan.depth`.

    CPU tensors take the plain version, which walks the plan; CUDA tensors
    launch the kernel, after checking that the plan fits shared memory."""
    return _stream("spmv_ell_stream", "tg_spmv_ell_stream", vals, cols, {"x": x}, block_n,
                   nbuf, spmv_ell_stream_ref)


def galerkin_residual_ell_stream(vals: torch.Tensor, cols, u: torch.Tensor, f: torch.Tensor,
                                 *, block_n: int | None = None,
                                 nbuf: int | None = None) -> torch.Tensor:
    """Fused streaming residual r = K·u − f (see :func:`spmv_ell_stream`)."""
    return _stream("galerkin_residual_ell_stream", "tg_residual_ell_stream", vals, cols,
                   {"u": u, "f": f}, block_n, nbuf, galerkin_residual_ell_stream_ref)


# ---------------------------------------------------------------------------
# autotune: pick (block_n, nbuf) by measurement, record via telemetry
# ---------------------------------------------------------------------------

def autotune_stream(vals: torch.Tensor, cols, x: torch.Tensor, *,
                    block_candidates=(1024, 4096, 8192), nbuf_candidates=(2, 4, 8),
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
