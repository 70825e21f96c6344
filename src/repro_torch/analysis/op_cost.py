"""Per-rank op cost of an eager program: the torch counterpart of
``repro.analysis.hlo_cost``.

The reference walks the partitioned HLO of a compiled program; the port
counts the ops one rank runs, as they run, under :class:`count_ops` (a
``TorchDispatchMode``).  An op on DTensors is left to DTensor's dispatch
(the mode answers ``NotImplemented``), so what is counted is the op on the
*local shards* and the functional collectives that DTensor issues — one
rank's work, as the reference's per-device program.  The shape inference
DTensor runs on fake tensors of the global shapes is not counted.  Loops
are counted as they run, so the count is loop-aware by construction
(``dynamic_loops`` is always 0).

The cost model is ``hlo_cost``'s:

* FLOPs: a matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``) is
  2·|result|·K; a reduction |operand|; every other op that computes
  |result|; views, factories and data movement none;
* ``bytes`` (primary): matmul operands and results, collective results
  (the operand of a reduce-scatter), the slab a gather or an embedding
  lookup reads (its result), a sort's operands and results, and the
  update of an in-place write into a view (a cache write);
* ``bytes_upper``: every op's operands and results, views and factories
  excepted;
* collective bytes by kind (all-gather, all-reduce, reduce-scatter,
  all-to-all, collective-permute) with the same sizes as ``bytes``, and
  their counts.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

__all__ = ["OpCost", "count_ops", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

# functional collectives (and the in-place c10d ops) → the reference's kinds
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "shard_dim_alltoall": "all-to-all",          # DTensor's Shard(i) → Shard(j)
}
_MATMULS = {"mm", "addmm", "bmm", "baddbmm"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "norm",
               "linalg_vector_norm", "var", "std", "var_mean", "_softmax", "_log_softmax",
               "cumsum", "any", "all", "argmax", "argmin"}
_FACTORIES = {"empty", "empty_strided", "empty_like", "zeros", "zeros_like", "ones", "ones_like",
              "full", "full_like", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
              "detach", "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd", "alias",
              "_to_copy_meta", "new_empty", "new_empty_strided", "new_zeros", "new_ones",
              "new_full", "set_", "resize_", "is_same_size", "_has_compatible_shallow_copy_type"}
_MOVES = {"copy_", "clone", "contiguous", "cat", "stack", "_to_copy", "index_select",
          "index", "index_put_", "index_put", "index_copy_", "index_copy", "gather",
          "embedding", "constant_pad_nd", "repeat", "repeat_interleave", "split_with_sizes_copy",
          "unbind_copy", "slice_scatter", "select_scatter", "sort", "topk",
          "fill_", "zero_", "roll", "flip"}
_SLAB_READS = {"index_select", "index", "gather", "embedding"}
_INPLACE_WRITES = {"copy_", "index_put_", "index_copy_"}


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0          # primary HBM traffic
    bytes_upper: float = 0.0    # every op's operands + results
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    dynamic_loops: int = 0
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVE_KINDS})

    def add(self, other: "OpCost", mult: float = 1.0):
        self.flops += mult * other.flops
        self.bytes += mult * other.bytes
        self.bytes_upper += mult * other.bytes_upper
        self.collective_bytes += mult * other.collective_bytes
        for k, v in other.collective_by_kind.items():
            self.collective_by_kind[k] = self.collective_by_kind.get(k, 0.0) + mult * v
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0) + int(mult * v)
        self.dynamic_loops += other.dynamic_loops


def _tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            out.extend(_tensors(t))
    elif isinstance(tree, dict):
        for t in tree.values():
            out.extend(_tensors(t))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_fake(ts) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    return (any(isinstance(t, FakeTensor) for t in ts)
            or any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack()))


class count_ops(TorchDispatchMode):
    """``with count_ops() as c: ...`` counts one rank's work into
    ``c.cost`` (an :class:`OpCost`); ``c.ops`` counts the ops by name."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor dispatches; its local ops come back here
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        if _is_fake(ins):                  # DTensor's shape inference on global shapes
            return out
        self._count(func, ins, _tensors(out))
        return out

    def _count(self, func, ins, outs):
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        c = self.cost
        self.ops[name] = self.ops.get(name, 0) + 1
        kind = (_COLLECTIVE_OPS.get(name) if ns in ("_c10d_functional", "c10d", "_dtensor")
                else None)
        if kind is not None:
            size = _nbytes(ins[:1]) if kind == "reduce-scatter" else _nbytes(outs or ins[:1])
            c.collective_bytes += size
            c.collective_by_kind[kind] += size
            c.collective_counts[kind] += 1
            c.bytes += size
            c.bytes_upper += size
            return
        if func.is_view or name in _FACTORIES or ns not in ("aten", "prims"):
            return
        io_bytes = _nbytes(ins) + _nbytes(outs)
        c.bytes_upper += io_bytes
        if name in _MATMULS:
            a, res = ins[-2], outs[0]
            c.flops += 2.0 * res.numel() * a.shape[-1]
            c.bytes += _nbytes(ins[-2:]) + _nbytes(outs)
        elif name in _MOVES:
            if name in _SLAB_READS:
                c.bytes += _nbytes(outs)
            elif name in _INPLACE_WRITES:
                c.bytes += _nbytes(ins[1:2] if name == "copy_" else ins[-1:])
            elif name in ("sort", "topk"):
                c.bytes += io_bytes
        elif name in _REDUCTIONS:
            c.flops += max((t.numel() for t in ins), default=0)
        else:
            c.flops += sum(t.numel() for t in outs)
