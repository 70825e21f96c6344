"""Shared layers + the parameter-spec system (the torch port of
``repro.models.layers``).

A model is described by a tree (nested dicts) of :class:`P` (shape, logical
axes, init); from that single source of truth come real parameters
(:func:`init_params`, or :func:`numpy_params` for draws both packages can
load), ``meta`` stand-ins for the dry-run (:func:`abstract_params`), and the
logical axes the sharded layout reads (:func:`param_axes`,
:func:`repro_torch.sharding.make_shardings`).

Logical axes used across the stack:
  embed   — the model (residual) dimension
  heads   — attention heads × head_dim (fused)
  kv      — kv heads × head_dim
  mlp     — feed-forward hidden
  vocab   — vocabulary
  expert  — MoE expert; expert_mlp its feed-forward hidden
  layers  — stacked-block leading axis (one slice per layer)
  (None)  — replicated
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "P",
    "is_spec",
    "tree_map",
    "tree_leaves",
    "flatten_with_paths",
    "init_params",
    "numpy_params",
    "abstract_params",
    "param_axes",
    "stack_specs",
    "dot_f32",
    "row_parallel",
    "unflatten",
    "merge_heads",
    "pad_dim1",
    "einsum",
    "cumsum",
    "rms_norm",
    "norm_in",
    "rope",
    "mlp_specs",
    "mlp_apply",
]


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter spec: shape + logical axes (+ init style)."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev multiplier (normal → scale/√fan_in)
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, P)


# ---------------------------------------------------------------------------
# trees: nested dicts (and lists/tuples) with tensors, arrays or specs at the
# leaves; dict keys are visited in sorted order, as JAX flattens a dict
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def flatten_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in sorted-key order; a path is the tuple of
    dict keys and list indices from the root."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, t in enumerate(tree) for item in flatten_with_paths(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------

def _std(spec: P) -> float:
    """The reference's law: normal with stddev scale/√fan_in, fan_in the
    second-to-last dimension (the last one for a vector)."""
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    return spec.scale / float(np.sqrt(max(fan_in, 1)))


DRAW_SLICE = 1 << 30      # a leaf with more entries is drawn this many at a time


def init_params(specs, generator: torch.Generator, device=None):
    """Real parameters for a spec tree: zeros, ones, or normal draws at the
    reference's law (``repro.models.layers._leaf_init``), drawn in float32
    from ``generator`` on the generator's device, then cast to each spec's
    dtype on ``device`` (the CUDA card unless the caller names another).
    A leaf of more than ``DRAW_SLICE`` entries (an MoE layer's experts at
    published widths) is drawn and cast a slice of its flat view at a
    time, so the float32 draw never holds the whole leaf.  The draws are
    torch's, not JAX's."""
    from ..core.assembly import resolve_device

    device = resolve_device(device)

    def one(spec: P) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        n = int(np.prod(spec.shape))
        if n <= DRAW_SLICE:
            draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                               device=generator.device)
            return draw.mul_(_std(spec)).to(device=device, dtype=spec.dtype)
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        flat = out.view(-1)
        for start in range(0, n, DRAW_SLICE):
            m = min(DRAW_SLICE, n - start)
            draw = torch.randn(m, generator=generator, dtype=torch.float32,
                               device=generator.device)
            flat[start:start + m] = draw.mul_(_std(spec))
            del draw
        return out

    return tree_map(one, specs)


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.float64: np.float64,
              torch.int64: np.int64}


def numpy_params(specs, seed: int) -> dict:
    """The same law drawn with numpy (``default_rng(seed)``, leaves in
    sorted-key order): a float32/int32 host tree that the JAX package and
    the port can both load, so the two compute on identical parameters."""
    rng = np.random.default_rng(seed)

    def one(spec: P) -> np.ndarray:
        dt = _NP_DTYPES[spec.dtype]
        if spec.init == "zeros":
            return np.zeros(spec.shape, dt)
        if spec.init == "ones":
            return np.ones(spec.shape, dt)
        return (_std(spec) * rng.standard_normal(spec.shape)).astype(dt)

    return tree_map(one, specs)


def abstract_params(specs):
    """``meta`` tensors of each spec's shape and dtype: stand-ins that
    allocate nothing (the reference's ``ShapeDtypeStruct``s)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def param_axes(specs):
    return tree_map(lambda s: s.axes, specs)


def stack_specs(specs, n: int):
    """Prepend a stacked 'layers' axis to every spec in a block."""
    return tree_map(lambda s: P((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale, s.dtype),
                    specs)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result, as the reference's contractions with
    ``preferred_element_type=float32``: bf16 × bf16 products are exact in
    float32, so both operands are widened and multiplied in float32 (the
    installed torch's ``matmul`` takes no output dtype).

    Two DTensors of four or more dims, sharded on batch dims only
    (attention's (batch, heads) products), multiply shard by shard, a
    replicated batch dim of one first cut to the other's shards (a local
    slice): every rank's product is its own, and some torch releases'
    DTensor cannot flatten two sharded batch dims into the one ``bmm``
    takes."""
    if (hasattr(a, "placements") and hasattr(b, "placements") and a.dim() == b.dim() >= 4
            and a.device_mesh == b.device_mesh):
        want = _batch_placements(a, b)
        if want is not None:
            from torch.distributed.tensor import DTensor

            a, b = (t if tuple(t.placements) == want else t.redistribute(t.device_mesh, want)
                    for t in (a, b))
            out = torch.matmul(a.to_local().float(), b.to_local().float())
            shape = tuple(a.shape[:-1]) + (b.shape[-1],)
            return DTensor.from_local(out, a.device_mesh, want, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=torch.empty(shape, device="meta").stride())
    return torch.matmul(a.float(), b.float())


def norm_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A sublayer's input: ``rms_norm`` of the residual stream with the
    sequence whole, as the sublayer's products read it — under sequence
    parallelism its shards are gathered here (Megatron-SP), where XLA
    places the gather itself; otherwise a no-op."""
    from ..sharding.partitioning import annotate

    return annotate(rms_norm(x, w), "batch", None, None)


def row_parallel(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y @ w`` for a product whose contraction tensor parallelism may
    shard (an output projection back to the residual stream), in ``y``'s
    dtype.  On DTensors of (batch, seq, ·) the result is placed as the
    residual stream is (``seq_act``: under sequence parallelism its sum is
    reduce-scattered over the sequence and its gradient all-gathered back,
    as in Megatron-SP, so no sequence-sharded gradient reaches the
    product's backward, which flattens (batch, seq) — a view some torch
    releases' DTensor cannot do with both dims sharded).  Where a mesh dim
    of more than one rank shards the contraction, the partial products
    are taken in float32 and summed across the shards in float32 before
    the cast: the partial sums meet once rounded, as one device's product
    is (in bfloat16 each shard's product and their sum would each round,
    about one ulp from one device's at every such product).  Anywhere else
    the plain product."""
    w = w.to(y.dtype)
    if not (hasattr(y, "placements") and y.dim() == 3):
        return y @ w
    from ..sharding.partitioning import annotate

    out = dot_f32(y, w) if _contraction_sharded(y, w) else y @ w
    return annotate(out, "batch", "seq_act", None).to(y.dtype)


def _contraction_sharded(y, w) -> bool:
    mesh = y.device_mesh
    return any(mesh.size(i) > 1 and p.is_shard() and p.dim == y.dim() - 1
               for i, p in enumerate(y.placements)) or (
        hasattr(w, "placements") and any(mesh.size(i) > 1 and p.is_shard() and p.dim == 0
                                         for i, p in enumerate(w.placements)))


def _batch_placements(a, b):
    """The placements both operands of a batched product can take with
    every shard on a batch dim (each mesh dim: the shard either has, the
    other replicated there), or None."""
    out = []
    for p, q in zip(a.placements, b.placements):
        for r in (p, q):
            if not (r.is_replicate() or (r.is_shard() and r.dim < a.dim() - 2)):
                return None
        if p.is_shard() and q.is_shard() and p != q:
            return None
        out.append(p if p.is_shard() else q)
    return tuple(out)


def unflatten(t: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``: a fused heads dim split into (heads,
    head_dim), or heads into (kv heads, group).  A DTensor keeps its shards
    of that dim only where they fall on whole entries of ``sizes[0]``
    (DTensor cannot shard two dims jointly): a mesh dim whose degree does
    not divide ``sizes[0]`` — 8 kv heads over 16 ranks — is replicated
    first (an all-gather), where XLA would shard the pair jointly."""
    if hasattr(t, "placements"):
        t = _replicate_uneven(t, dim % t.dim(), sizes[0])
    return t.unflatten(dim, sizes)


class _GradUnflattenable(torch.autograd.Function):
    """Identity forward; the backward replicates the gradient's shards of
    ``dim`` on mesh dims whose degree does not divide ``lead`` — so that
    the backward of a merge of (``lead``, ·) into ``dim`` (an unflatten)
    is one DTensor can do."""

    @staticmethod
    def forward(ctx, y, dim, lead):
        ctx.dim, ctx.lead = dim, lead
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _replicate_uneven(g, ctx.dim, ctx.lead), None, None


def _replicate_uneven(t, dim: int, lead: int):
    from torch.distributed.tensor import Replicate, Shard

    mesh, degree, keep = t.device_mesh, 1, []
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim and lead % (degree * mesh.size(i)) == 0:
            degree *= mesh.size(i)
            keep.append(p)
        else:
            keep.append(Replicate() if isinstance(p, Shard) and p.dim == dim else p)
    return t if tuple(keep) == tuple(t.placements) else t.redistribute(mesh, keep)


def merge_heads(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t.flatten(dim, dim + 1)``: (heads, head_dim) — or (kv heads,
    group) — merged into one dim.  On a DTensor the merge's backward is
    an :func:`unflatten` of the gradient, so the gradient is first
    replicated where :func:`unflatten` would replicate."""
    d = dim % t.dim()
    lead = t.shape[d]
    y = t.flatten(d, d + 1)
    if hasattr(y, "placements") and torch.is_grad_enabled() and y.requires_grad:
        y = _GradUnflattenable.apply(y, d, lead)
    return y


def pad_dim1(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` with ``pad`` zero rows appended along dim 1 (a sequence padded
    to whole chunks): ``F.pad`` on a plain tensor; a concatenation with
    zeros on a DTensor, where some torch releases' ``F.pad`` returns a
    DTensor whose placements miss mesh dims."""
    if hasattr(t, "placements"):
        zeros = torch.zeros((t.shape[0], pad) + tuple(t.shape[2:]), dtype=t.dtype,
                            device=t.to_local().device)
        return torch.cat([t, zeros], dim=1)
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _local_part(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of a tensor every rank holds whole (a constant the
    model made): a differentiable slice."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, placements)
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[d]:
            t = t.narrow(d, o, n)
    return t


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``.  With DTensors among the operands, each mesh dim
    that shards one index letter (a batch, head or expert letter) has every
    operand that carries the letter sharded on it (a local slice of a
    replicated one) and the others replicated; the product then runs on the
    local shards, sharded on that letter where it is kept and a partial sum
    over the mesh dim where it is contracted.  Some torch releases' DTensor
    cannot lower such a product (its ``bmm`` would flatten two sharded
    dims); where the placements allow no such plan, DTensor's own einsum
    runs."""
    if not any(hasattr(o, "placements") for o in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lhs, out = eq.replace(" ", "").split("->")
    specs = lhs.split(",")
    mesh = next(o for o in ops if hasattr(o, "placements")).device_mesh
    letters = []
    for m in range(mesh.ndim):
        found = set()
        for spec, o in zip(specs, ops):
            if hasattr(o, "placements"):
                p = o.placements[m]
                if p.is_partial() or o.device_mesh != mesh:
                    return torch.einsum(eq, *ops)
                if p.is_shard():
                    found.add(spec[p.dim])
        if len(found) > 1:
            return torch.einsum(eq, *ops)
        letters.append(found.pop() if found else None)
    used = [c for c in letters if c]
    if len(used) != len(set(used)) or "." in eq:
        return torch.einsum(eq, *ops)
    local = []
    for spec, o in zip(specs, ops):
        want = tuple(Shard(spec.index(c)) if c and c in spec else Replicate() for c in letters)
        if hasattr(o, "placements"):
            # an operand replicated over a mesh dim that shards a letter it
            # lacks gets a partial gradient there: each rank's is its shard's part
            grad = tuple(Partial() if c and c not in spec else w for c, w in zip(letters, want))
            local.append((o if tuple(o.placements) == want
                          else o.redistribute(mesh, want)).to_local(grad_placements=grad))
        else:
            local.append(_local_part(o, mesh, want))
    res = torch.einsum(eq, *local)
    sizes = {c: n for spec, o in zip(specs, ops) for c, n in zip(spec, o.shape)}
    shape = torch.Size(sizes[c] for c in out)
    placements = tuple(Replicate() if not c else Shard(out.index(c)) if c in out else Partial()
                       for c in letters)
    return DTensor.from_local(res, mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` along ``dim``; on a DTensor not sharded along
    ``dim``, on the local shard (some torch releases' DTensor has no
    strategy for the ``flip`` of its backward)."""
    if hasattr(x, "placements"):
        d = dim % x.dim()
        if all(p.is_replicate() or (p.is_shard() and p.dim != d) for p in x.placements):
            from torch.distributed.tensor import DTensor

            return DTensor.from_local(torch.cumsum(x.to_local(), dim=d), x.device_mesh,
                                      x.placements, run_check=False, shape=x.shape,
                                      stride=x.stride())
    return torch.cumsum(x, dim=dim)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq                   # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_specs(d_model: int, d_ff: int, kind: str) -> dict:
    if kind == "swiglu":
        return {
            "wi": P((d_model, d_ff), ("embed", "mlp")),
            "wg": P((d_model, d_ff), ("embed", "mlp")),
            "wo": P((d_ff, d_model), ("mlp", "embed")),
        }
    return {  # squared_relu / gelu: 2-matrix MLP
        "wi": P((d_model, d_ff), ("embed", "mlp")),
        "wo": P((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = x @ params["wi"].to(x.dtype)
        g = x @ params["wg"].to(x.dtype)
        h = F.silu(g) * h
    else:
        h = x @ params["wi"].to(x.dtype)
        if kind == "squared_relu":                      # nemotron-4
            h = torch.square(torch.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")           # jax.nn.gelu's default
    return row_parallel(h, params["wo"])
