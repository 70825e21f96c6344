"""Shared layers + the parameter-spec system (the torch port of
``repro.models.layers``).

A model is described by a tree (nested dicts) of :class:`P` (shape, logical
axes, init); from that single source of truth come real parameters
(:func:`init_params`, or :func:`numpy_params` for draws both packages can
load), and the logical axes a later sharded layout reads (:func:`param_axes`).

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
    "param_axes",
    "stack_specs",
    "dot_f32",
    "rms_norm",
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
    installed torch's ``matmul`` takes no output dtype)."""
    return torch.matmul(a.float(), b.float())


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
    return h @ params["wo"].to(x.dtype)
