"""Training step: grad accumulation, mixed precision, in-place update (the
torch port of ``repro.train.train_step``, on one device).

* **Grad accumulation** — a loop over microbatches bounds activation
  memory; the accumulator dtype is ``cfg.grad_dtype`` (bfloat16 for
  nemotron-4), and the sum is divided by the microbatch count in float32.
* **Mixed precision** — params are stored in ``cfg.param_dtype`` and cast
  to ``cfg.compute_dtype`` inside the forward; logits/loss in float32.
* **In-place update** — the optimizer updates params and state in place
  (the reference donates the state buffers to the same effect).

The state is ``{"params", "opt", "step"}``; ``step`` is a 0-d int32 tensor
on the host, so the step and learning-rate arithmetic never read the
device.

:func:`jit_train_step` is the sharded step on a ``DeviceMesh`` (the 2-D
layout of :mod:`repro_torch.sharding`): the same step on DTensor state, run
eagerly — the name is the reference's, which jits it.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models.layers import P, tree_leaves
from ..models.model_zoo import build_model
from ..models.transformer import torch_dtype
from ..optim import cosine_schedule, make_optimizer
from ..sharding.partitioning import (ShardingRules, is_dtensor, make_shardings, placed_like,
                                     replicated, use_rules)

__all__ = ["TrainState", "make_train_state_specs", "make_train_step", "jit_train_step"]

TrainState = dict  # {"params": tree, "opt": tree, "step": 0-d int32 tensor}


def make_train_state_specs(cfg: ArchConfig):
    model = build_model(cfg)
    pspecs = model.param_specs()
    opt = make_optimizer(cfg.optimizer)
    return {
        "params": pspecs,
        "opt": opt.init_specs(pspecs),
        "step": P((), (), "zeros", dtype=torch.int32),
    }


def _split_microbatches(batch: dict, n: int) -> dict:
    """Each input as ``n`` microbatches along a new leading axis.  A DTensor
    input splits each rank's own rows (microbatch i holds the i-th n-th of
    every rank's rows), so the split moves no data between ranks; the sum
    over the microbatches is the same, the grouping of rows differs from
    the global reshape."""
    def split(x):
        if is_dtensor(x):
            return _split_local(x, n)
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} microbatches")
        return x.reshape((n, b // n) + tuple(x.shape[1:]))

    return {k: split(v) if getattr(v, "ndim", 0) > 0 else v for k, v in batch.items()}


def _split_local(x, n: int) -> list:
    from torch.distributed.tensor import DTensor, Shard

    local = x.to_local()
    b = local.shape[0]
    if b % n:
        raise ValueError(f"a rank's {b} batch rows are not divisible by {n} microbatches")
    parts = local.reshape((n, b // n) + tuple(local.shape[1:]))
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n} microbatches")
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    if any(isinstance(p, Shard) and p.dim != 0 for p in x.placements):
        raise ValueError(f"microbatches split the batch dim; the input is placed {x.placements}")
    return [DTensor.from_local(parts[i], x.device_mesh, x.placements, run_check=False,
                               shape=torch.Size(shape), stride=parts[i].stride())
            for i in range(n)]


def make_train_step(cfg: ArchConfig, shape: ShapeSpec, *, lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    weight_decay: float = 0.01):
    """Returns ``train_step(state, batch) -> (state, metrics)``: one
    optimizer step in place on ``state`` (returned as well), with
    ``metrics = {"loss", "grad_norm"}`` as 0-d float32 tensors on the
    state's device and ``"lr"`` the float32 learning rate as a host float."""
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    schedule = cosine_schedule(lr, warmup, total_steps)
    n_micro = cfg.grad_accum(shape.name)
    gdt = torch_dtype(cfg.grad_dtype)

    def value_and_grad(leaves, params, mb):
        loss = model.loss(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        # a DTensor gradient to its parameter's placements (FSDP: Partial → Shard)
        return loss.detach(), [placed_like(g, p) for g, p in zip(grads, leaves)]

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)

        if n_micro == 1:
            loss, grads = value_and_grad(leaves, params, batch)
        else:
            mbs = _split_microbatches(batch, n_micro)
            acc = [torch.zeros_like(p, dtype=gdt) for p in leaves]
            loss = 0.0
            for i in range(n_micro):
                li, g = value_and_grad(leaves, params, {k: v[i] for k, v in mbs.items()})
                for a, x in zip(acc, g):
                    a.add_(x.to(gdt))
                del g
                loss = loss + li
            loss = loss / n_micro
            grads = [a.float() / n_micro for a in acc]
            del acc

        step = int(state["step"]) + 1
        cur_lr = schedule(step)
        gnorm = replicated(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads)))
        opt.update(params, grads, state["opt"], cur_lr, float(step), wd=weight_decay)
        state["step"] = torch.tensor(step, dtype=torch.int32)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": cur_lr}

    return train_step



def jit_train_step(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: ShardingRules, **kw):
    """The sharded train step on ``mesh`` and everything the launcher needs:
    ``(step, state_specs, state_sh, batch_sh)``, as the reference returns
    them.  The step is eager (the name is the reference's, whose step is
    jitted): ``step(state, batch)`` runs :func:`make_train_step`'s step on
    DTensor state placed by ``state_sh`` and a batch placed by
    ``batch_sh`` (``repro_torch.sharding.distribute_tree``), under
    ``use_rules(rules)`` and ``implicit_replication()`` — the tensors the
    model makes inside join the program replicated — with the model built
    for the mesh's 'model' degree.  The step issues no collective of its
    own: DTensor issues them (FSDP gathers at use, TP reductions, each
    gradient reduce-scattered to its parameter's placements).  The metrics
    come back as plain tensors, the same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    tp = mesh["model"].size() if "model" in (mesh.mesh_dim_names or ()) else 1
    state_specs = make_train_state_specs(cfg)
    model = build_model(cfg, tp_degree=tp)
    step_fn = make_train_step(cfg, shape, **kw)
    state_sh = make_shardings(state_specs, mesh, rules)
    batch_sh = make_shardings(model.batch_axes(shape), mesh, rules)

    def step(state, batch):
        with use_rules(rules), implicit_replication():
            state, metrics = step_fn(state, batch)
        return state, {k: (v.full_tensor() if is_dtensor(v) else v) for k, v in metrics.items()}

    return step, state_specs, state_sh, batch_sh
