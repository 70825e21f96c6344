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

The LM half of the reference module (``ShardingRules``, ``RULES_*``,
``use_rules``, ``annotate``, ``logical_to_spec``, ``make_shardings``)
serves the language-model harness and comes with its port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVES",
    "FEM_MESH_AXIS",
    "FemMesh",
    "fem_mesh",
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
