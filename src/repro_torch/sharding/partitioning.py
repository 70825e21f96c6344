"""Element-parallel partitioning over ``torch.distributed`` ranks.

The torch port of the FEM half of ``repro.sharding.partitioning``: the
named element axis, the 1-D mesh over which
:func:`repro_torch.core.assemble_sharded` and
:class:`repro_torch.core.ShardedMatFreeOperator` split the element axis of
the Map, and the two collectives that complete their Reduce.

The reference is one controller over a mesh of local devices; the port is
SPMD.  Every rank runs the same program: it builds the same plan from the
same mesh, holds the replicated ``(n,)`` vectors and its own contiguous
block of the elements, reduces that block to a *partial* global result,
and one all-reduce completes the Sparse-Reduce.  Krylov loops then run on
every rank on the same all-reduced vectors, so every rank takes the same
iterations.  The caller starts the process group and picks its backend
(``nccl`` for one card a rank; ``gloo`` on the CPU, or for several ranks
on one card, which NCCL refuses); nothing here switches backend.

The two collectives are Megatron's "f" and "g" as autograd Functions:

* :func:`to_shard` — forward: the rank's block of a replicated tensor (the
  whole tensor for a replicated leaf); backward: all-reduce of the
  zero-padded block gradient, so every rank holds the whole gradient;
* :func:`reduce_from_shards` — forward: all-reduce of a rank's partial;
  backward: the identity (the cotangent of a replicated output is already
  the same on every rank).

``torch.distributed.all_reduce`` is in place and invisible to autograd,
and ``torch.distributed.nn.functional.all_reduce`` all-reduces the
gradient on the way back too, which multiplies a replicated cotangent by
the number of ranks: neither stands in for these two.  :data:`COLLECTIVES`
counts the all-reduces each issues.

The LM half (``ShardingRules``, ``RULES_*``, ``use_rules``, ``annotate``,
``logical_to_spec``, ``make_shardings``) is the reference's logical-axis
layout on DTensor: every parameter spec carries *logical* axis names, a
:class:`ShardingRules` maps them to mesh axes, and :func:`make_shardings`
turns the result into DTensor placements on a ``DeviceMesh`` (the
counterpart of a ``NamedSharding``).  The default layout on
``('data', 'model')``: FSDP of the residual dimension 'embed' over 'data'
(gathered where a weight is used: :func:`gather_for_use`), Megatron tensor
parallelism of 'heads' / 'kv' / 'mlp' / 'vocab' / 'expert' over 'model',
activations' 'batch' over 'data' (and 'pod'), the KV cache's heads over
'model'.  :func:`annotate` is ``redistribute`` under active rules and the
identity otherwise, so the model code stays global-view and runs on plain
tensors unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVES",
    "FEM_MESH_AXIS",
    "FemMesh",
    "NamedSharding",
    "RULES_MULTI_POD",
    "RULES_SINGLE_POD",
    "ShardingRules",
    "annotate",
    "distribute_tree",
    "gather_for_use",
    "fem_mesh",
    "gloo_cuda_collectives",
    "is_dtensor",
    "logical_to_spec",
    "make_shardings",
    "placed_like",
    "replicated",
    "sharded_zeros",
    "spec_to_placements",
    "use_rules",
    "reduce_from_shards",
    "reset_collectives",
    "resolve_fem_mesh",
    "shard_leaves",
    "to_shard",
]

#: the named mesh axis over which the element axis of the Map is split
FEM_MESH_AXIS = "elem"

#: all-reduces issued since the last :func:`reset_collectives`, by the
#: function that issued them (``to_shard``'s only in a backward pass)
COLLECTIVES: dict[str, int] = {"reduce_from_shards": 0, "to_shard": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


@dataclasses.dataclass(frozen=True)
class FemMesh:
    """A 1-D mesh of ranks for element-parallel assembly and applies.

    ``group`` is the process group the collectives run on, ``None`` for
    the one-rank mesh of a process without one (which issues no
    collective: the reference's single-device mesh); ``rank`` is this
    process's rank in it and ``device`` the device the rank computes on."""

    group: object
    size: int
    rank: int
    device: torch.device
    axis_name: str = FEM_MESH_AXIS

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis_name,)

    def block(self, n: int) -> tuple[int, int]:
        """This rank's contiguous block ``[lo, hi)`` of ``n`` elements:
        blocks of ⌈n / size⌉ (the reference's padded split), so the last
        ranks get fewer, possibly none."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n)


def fem_mesh(n_devices: int | None = None, axis_name: str = FEM_MESH_AXIS, *,
             group=None, device=None) -> FemMesh:
    """The 1-D mesh over the ranks of ``group`` (default: the initialised
    default group), this process computing on ``device`` (default: the
    current CUDA device).  Without an initialised process group it is the
    one-rank mesh on ``device``.

    ``n_devices`` asks for that many ranks: more than the group has raises
    ``ValueError``; a mesh over fewer ranks is a smaller group, which every
    rank creates with ``torch.distributed.new_group`` and passes as
    ``group``."""
    from ..core.assembly import resolve_device

    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if rank < 0:
            raise ValueError("fem_mesh: this process is not a member of the given group")
    elif group is not None:
        raise ValueError("fem_mesh: a group was given but torch.distributed is not initialised")
    else:
        size, rank = 1, 0
    if n_devices is not None:
        if n_devices > size:
            raise ValueError(f"fem_mesh: requested {n_devices} ranks but only {size} are "
                             "available")
        if n_devices < size:
            raise ValueError(f"fem_mesh: requested {n_devices} of the group's {size} ranks; "
                             "create that group with torch.distributed.new_group and pass it "
                             "as group=")
    return FemMesh(group, size, rank, dev, axis_name)


def resolve_fem_mesh(mesh: FemMesh | None, axis_name: str | None, device) -> FemMesh:
    """``mesh``, or the default :func:`fem_mesh` on ``device`` (the
    device of the plan it will run); ``axis_name`` must name its axis."""
    if mesh is None:
        return fem_mesh(axis_name=FEM_MESH_AXIS if axis_name is None else axis_name,
                        device=device)
    if axis_name is not None and axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    return mesh


def _all_reduce(t: torch.Tensor, mesh: FemMesh, counter: str) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    COLLECTIVES[counter] += 1
    return t


class _ReduceFromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, mesh):
        return _all_reduce(part.clone(), mesh, "reduce_from_shards")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_shards(part: torch.Tensor, mesh: FemMesh) -> torch.Tensor:
    """The sum over the mesh's ranks of each rank's ``part`` (an all-reduce
    on every mesh with a process group, also of size 1; none on the
    one-rank mesh without one).  Without grad it sums ``part`` in place;
    differentiable, with the identity as its backward."""
    if mesh.group is None:
        return part
    if torch.is_grad_enabled() and part.requires_grad:
        return _ReduceFromShards.apply(part, mesh)
    return _all_reduce(part, mesh, "reduce_from_shards")


class _ToShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, block, mesh):
        ctx.block, ctx.mesh, ctx.n = block, mesh, t.shape[0] if t.dim() else 0
        return t.view_as(t) if block is None else t[block[0]:block[1]]

    @staticmethod
    def backward(ctx, grad):
        if ctx.block is None:
            full = grad.clone()
        else:
            full = grad.new_zeros((ctx.n, *grad.shape[1:]))
            full[ctx.block[0]:ctx.block[1]] = grad
        if ctx.mesh.group is not None:
            _all_reduce(full, ctx.mesh, "to_shard")
        return full, None, None


def to_shard(t: torch.Tensor, mesh: FemMesh, block: tuple[int, int] | None = None):
    """The rows ``block = (lo, hi)`` of a replicated tensor for this rank,
    or the whole tensor with ``block=None`` (a replicated input of the
    rank's computation).  Where ``t`` requires grad, the backward
    all-reduces the rank's zero-padded gradient over the mesh, so that
    every rank holds the gradient of the whole computation."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _ToShard.apply(t, block, mesh)
    return t if block is None else t[block[0]:block[1]]


def shard_leaves(leaves, n_cells: int, mesh: FemMesh, block: tuple[int, int], device):
    """The rank's coefficient leaves, by the reference's rule: an array
    leaf whose leading axis has ``n_cells`` entries (a per-element or
    per-quadrature coefficient) gives the rank its block; every other
    tensor leaf (a scalar, a nodal field, a constant vector or tensor)
    passes whole.  Python scalars pass as they are."""
    out = []
    for lv in leaves:
        if not isinstance(lv, torch.Tensor) and np.ndim(lv) >= 1:
            lv = torch.as_tensor(np.asarray(lv), device=device)
        if isinstance(lv, torch.Tensor):
            lv = to_shard(lv, mesh, block if lv.dim() >= 1 and lv.shape[0] == n_cells else None)
        out.append(lv)
    return tuple(out)


# ---------------------------------------------------------------------------
# LM: logical-axis rules → DTensor placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mapping: dict  # logical axis name -> mesh axis | tuple of mesh axes | None

    def spec_for(self, axes: tuple) -> tuple:
        """One entry per tensor dim: a mesh axis, a tuple of mesh axes or
        ``None``; a mesh axis is used at most once (a later dim that would
        reuse one stays replicated), as in a ``PartitionSpec``."""
        used: set = set()
        out = []
        for ax in axes:
            mesh_ax = self.mapping.get(ax) if ax is not None else None
            if mesh_ax is None:
                out.append(None)
                continue
            key = tuple(mesh_ax) if isinstance(mesh_ax, (tuple, list)) else (mesh_ax,)
            if used & set(key):
                out.append(None)
                continue
            used |= set(key)
            out.append(tuple(mesh_ax) if isinstance(mesh_ax, list) else mesh_ax)
        return tuple(out)


_BASE = {
    "embed": "data",          # FSDP
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "layers": None,
    "batch": "data",
    "seq_act": None,          # flip to 'model' for sequence parallelism
    "seq_cache": None,
    "kv_cache": "model",
    "ssm_heads": "model",
}

RULES_SINGLE_POD = ShardingRules(dict(_BASE))
RULES_MULTI_POD = ShardingRules(
    {**_BASE, "embed": ("pod", "data"), "batch": ("pod", "data")}
)


class _State(threading.local):
    rules: ShardingRules | None = None
    active: bool = False


_state = _State()


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    """Make ``rules`` the active rules of this thread (``None``: none)
    inside the block; nests, and restores the outer rules on exit."""
    prev_r, prev_a = _state.rules, _state.active
    _state.rules, _state.active = rules, rules is not None
    try:
        yield
    finally:
        _state.rules, _state.active = prev_r, prev_a


def logical_to_spec(axes: tuple, rules: ShardingRules | None = None) -> tuple:
    rules = rules or _state.rules
    if rules is None:
        raise ValueError("logical_to_spec: no rules given and none active")
    return rules.spec_for(axes)


def spec_to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` (one entry per tensor dim, as
    :meth:`ShardingRules.spec_for` gives it) on ``mesh``: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    others.  A tuple such as ``("pod", "data")`` on one tensor dim shards
    it over both mesh dims, the first named the outer; a mesh axis the mesh
    lacks raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        for name in group:
            if name not in names:
                raise ValueError(f"mesh axis {name!r} of spec {spec} is not an axis of the "
                                 f"mesh {names}")
            out[names.index(name)] = Shard(d)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):   # DTensor nests mesh dims on one tensor dim in mesh order
            raise ValueError(f"spec {spec}: {ax} must follow the mesh's axis order {names}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the torch counterpart of ``jax.sharding.NamedSharding``,
    with the DTensor placements they give."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return spec_to_placements(self.spec, self.mesh)


def _is_axes(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(a, (str, type(None))) for a in s)


def make_shardings(specs, mesh, rules: ShardingRules):
    """Tree of P-specs (or logical-axes tuples) → the same tree of
    :class:`NamedSharding` on ``mesh``."""
    from ..models.layers import is_spec

    def walk(s):
        if is_spec(s) or _is_axes(s):
            return NamedSharding(mesh, rules.spec_for(s.axes if is_spec(s) else s))
        if isinstance(s, dict):
            return {k: walk(s[k]) for k in sorted(s)}
        if isinstance(s, (list, tuple)):
            return type(s)(walk(v) for v in s)
        raise TypeError(f"make_shardings: leaf {s!r} is neither a spec nor an axes tuple")

    return walk(specs)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def annotate(x, *axes):
    """``redistribute`` to the logical ``axes`` under active rules when ``x``
    is a DTensor (the reference's ``with_sharding_constraint``); ``x``
    itself, untouched, otherwise."""
    if not _state.active or not is_dtensor(x):
        return x
    spec = _state.rules.spec_for(axes)
    return x.redistribute(x.device_mesh, spec_to_placements(spec, x.device_mesh))


def gather_for_use(w):
    """A weight as it is used: a DTensor's shards over the data-parallel
    mesh axes (those the active rules map 'batch' to, else 'pod' and
    'data') all-gathered to ``Replicate``, its tensor-parallel shards kept
    — the FSDP gather that XLA inserts at a use site.  Anything else passes
    as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(w.device_mesh.mesh_dim_names or ())
    bmap = _state.rules.mapping.get("batch") if _state.active else None
    fsdp = set((bmap,) if isinstance(bmap, str) else tuple(bmap or ())) or {"pod", "data"}
    want = tuple(Replicate() if isinstance(p, Shard) and names[i] in fsdp else p
                 for i, p in enumerate(w.placements))
    return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)


def _place(t: torch.Tensor, sh: NamedSharding):
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if isinstance(t, DTensor):
        if t.device_mesh == sh.mesh:
            return t.redistribute(sh.mesh, sh.placements)
        t = t.full_tensor()
    if t.dim() == 0:
        # the step counter: a host tensor, which the step's host arithmetic reads
        return torch.zeros((), dtype=t.dtype) if t.device.type == "meta" else t.cpu()
    if t.device.type == "meta":
        local, _ = compute_local_shape_and_global_offset(t.shape, sh.mesh, sh.placements)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), sh.mesh,
                                  sh.placements, run_check=False, shape=t.shape,
                                  stride=t.stride())
    # every rank holds the same global tensor and keeps its own shard: no collective
    return distribute_tensor(t.to(sh.mesh.device_type), sh.mesh, sh.placements,
                             src_data_rank=None)


def distribute_tree(tree, shardings):
    """Place each tensor leaf of ``tree`` by the :class:`NamedSharding` at
    the same place of ``shardings`` (from :func:`make_shardings`):

    * a global tensor (the same on every rank) → a DTensor holding this
      rank's shard, taken locally, with no collective;
    * a ``meta`` tensor → a ``meta`` DTensor of that global shape (the
      dry-run's stand-in, which allocates nothing);
    * a DTensor → redistributed to the sharding's placements (possibly on
      another mesh of the same world);
    * a 0-d tensor (the step counter) becomes a host tensor, which the
      step's host arithmetic reads (a real zero for a ``meta`` one).
    """
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], shardings[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(t, sh) for t, sh in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        return _place(tree, shardings)
    return tree


def sharded_zeros(shape, dtype, axes: tuple, like: torch.Tensor) -> torch.Tensor:
    """A zero tensor of global ``shape`` made beside ``like``: without a
    DTensor or active rules, ``torch.zeros`` on ``like``'s device; else a
    DTensor on ``like``'s mesh placed by the logical ``axes``, each rank
    allocating only its shard (a cache a prefill fills)."""
    if not (_state.active and is_dtensor(like)):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = like.device_mesh
    placements = spec_to_placements(_state.rules.spec_for(axes), mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=like.to_local().device),
                              mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def replicated(x):
    """A DTensor redistributed to ``Replicate`` on every mesh dim (a loss,
    a norm: the same value on every rank); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def placed_like(g, p):
    """A DTensor gradient ``g`` redistributed to its parameter ``p``'s
    placements (a ``Partial`` FSDP gradient reduce-scattered to the
    parameter's shard); anything else as it is."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


# ---------------------------------------------------------------------------
# gloo on CUDA tensors: the functional collectives through c10d's own
# ---------------------------------------------------------------------------

_GLOO_CUDA_DEPTH = [0]


@contextlib.contextmanager
def gloo_cuda_collectives():
    """Inside the block, route the functional all-gather, reduce-scatter
    and all-to-all that DTensor issues on CUDA tensors through c10d's
    in-place collectives (``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_to_all_single``), which gloo runs on
    CUDA tensors by staging them through host memory.  For a gloo world of
    CUDA ranks (several ranks on one card) only: torch 2.11 crashes in its
    functional all-gather on such a group (a segmentation fault, not an
    error), and the in-place ops give the same values.  The CUDA kernels
    of ``_c10d_functional``'s three ops are replaced for the whole
    process while the block runs (an NCCL group in the same process would
    go through them too) and torch's own are back on exit; nested blocks
    register once.  The ops stay what DTensor, the op counter and a tap of
    ``_functional_collectives`` see."""
    if _GLOO_CUDA_DEPTH[0]:
        _GLOO_CUDA_DEPTH[0] += 1
        try:
            yield
        finally:
            _GLOO_CUDA_DEPTH[0] -= 1
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(), group=_resolve_process_group(group_name))
        return out

    def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
        out = inp.new_empty((inp.shape[0] // group_size,) + tuple(inp.shape[1:]))
        dist.reduce_scatter_tensor(out, inp.contiguous(), op=ops[reduce_op.lower()],
                                   group=_resolve_process_group(group_name))
        return out / group_size if reduce_op.lower() == "avg" else out

    def all_to_all_single(inp, output_split_sizes, input_split_sizes, group_name):
        rows = sum(output_split_sizes) if output_split_sizes else inp.shape[0]
        out = inp.new_empty((rows,) + tuple(inp.shape[1:]))
        dist.all_to_all_single(out, inp.contiguous(), output_split_sizes or None,
                               input_split_sizes or None,
                               group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    _GLOO_CUDA_DEPTH[0] = 1
    try:
        for name, fn in (("all_gather_into_tensor", all_gather_into_tensor),
                         ("reduce_scatter_tensor", reduce_scatter_tensor),
                         ("all_to_all_single", all_to_all_single)):
            lib.impl(name, fn, "CUDA")
        yield
    finally:
        _GLOO_CUDA_DEPTH[0] = 0
        lib._destroy()
