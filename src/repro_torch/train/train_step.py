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
device.  The sharded, jitted step of the reference (``jit_train_step``)
comes with the 2-D layout (ROADMAP A17c).
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models.layers import P, tree_leaves
from ..models.model_zoo import build_model
from ..models.transformer import torch_dtype
from ..optim import cosine_schedule, make_optimizer

__all__ = ["TrainState", "make_train_state_specs", "make_train_step"]

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
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} microbatches")
        return x.reshape((n, b // n) + tuple(x.shape[1:]))

    return {k: split(v) if getattr(v, "ndim", 0) > 0 else v for k, v in batch.items()}


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
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)

        if n_micro == 1:
            loss, grads = value_and_grad(leaves, params, batch)
        else:
            mbs = _split_microbatches(batch, n_micro)
            acc = [torch.zeros(p.shape, dtype=gdt, device=p.device) for p in leaves]
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
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        opt.update(params, grads, state["opt"], cur_lr, float(step), wd=weight_decay)
        state["step"] = torch.tensor(step, dtype=torch.int32)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": cur_lr}

    return train_step

