"""End-to-end training driver with fault tolerance (the torch port of
``repro.launch.train``, with its flags and ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \\
        --steps 200 --ckpt-dir ckpt/
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \
        --data-axis 2 --model-axis 2 --device cpu

Features:
  * grad-accum microbatching, mixed precision, cosine schedule
    (:func:`~repro_torch.train.make_train_step`),
  * synthetic token pipeline with checkpointable iterator state + prefetch,
  * **auto-resume**: on start, restores the latest committed checkpoint
    (params + optimizer + data-iterator state) — kill the process mid-run
    and relaunch to resume,
  * async checkpoint cadence + retention,
  * straggler/step-time watchdog: logs steps exceeding ``--slow-factor`` ×
    the rolling median.

One device (the CUDA card unless ``--device`` names another), or the 2-D
layout over ``--data-axis`` × ``--model-axis`` ranks (FSDP over 'data',
tensor parallelism over 'model'): the launcher then starts the process
group from torchrun's environment — ``nccl`` with one card a rank, ``gloo``
on the CPU or for several ranks on one card, whose collectives then run
inside ``gloo_cuda_collectives`` — or joins the one the caller started,
and trains through :func:`~repro_torch.train.jit_train_step`,
:meth:`~repro_torch.data.SyntheticLMData.sharded_iterator` and the sharded
checkpoint (saved gathered, restored onto the current mesh).  Only rank 0
prints.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import statistics
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCHS, smoke_variant
from ..configs.base import ShapeSpec
from ..core.assembly import resolve_device
from ..data import SyntheticLMData
from ..models.layers import init_params
from ..sharding.partitioning import (RULES_SINGLE_POD, ShardingRules, distribute_tree,
                                     gloo_cuda_collectives)
from ..train.train_step import jit_train_step, make_train_state_specs, make_train_step
from .mesh import make_host_mesh


def _start_world(n: int, device) -> bool:
    """Join or start the process group of ``n`` ranks; True when this call
    started it (and so destroys it at the end)."""
    import torch.distributed as dist

    started = False
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != n:
            raise ValueError(f"the 2-D layout needs data × model = {n} ranks, and this process "
                             f"is one of {world}: start it with torchrun --nproc-per-node {n}")
        backend = "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
            backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
        dist.init_process_group(backend)
        started = True
    if dist.get_world_size() != n:
        raise ValueError(f"the 2-D layout needs data × model = {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return started


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--slow-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n_ranks = args.data_axis * args.model_axis
    started = _start_world(n_ranks, device) if n_ranks > 1 else False
    try:
        with contextlib.ExitStack() as stack:
            if n_ranks > 1 and torch.distributed.get_rank() != 0:
                stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
            if (n_ranks > 1 and device.type == "cuda"
                    and torch.distributed.get_backend() == "gloo"):
                stack.enter_context(gloo_cuda_collectives())   # several ranks on one card
            return _train(args, device, n_ranks)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _train(args, device, n_ranks: int):
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_variant(cfg)
    shape = ShapeSpec("custom", "train", args.seq_len, args.batch)

    data = SyntheticLMData(cfg.vocab_size, args.seq_len, args.batch)
    state_sh = None
    if n_ranks > 1:
        mesh = make_host_mesh(args.data_axis, args.model_axis, device_type=device.type)
        rules = ShardingRules({**RULES_SINGLE_POD.mapping})
        step_fn, state_specs, state_sh, batch_sh = jit_train_step(
            cfg, shape, mesh, rules, lr=args.lr, total_steps=args.steps)
    else:
        state_specs = make_train_state_specs(cfg)
        step_fn = make_train_step(cfg, shape, lr=args.lr, total_steps=args.steps)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        s = mgr.latest_step()
        print(f"[resume] restoring step {s} from {args.ckpt_dir}")
        state = mgr.restore(s, state_specs, device, shardings=state_sh)
        state["step"] = state["step"].cpu()
        manifest = mgr.restore_manifest(s)
        data.restore(manifest["extra"].get("data", {"step": 0, "seed": 0}))
        start_step = s
    else:
        print("[init] fresh parameters")
        state = init_params(state_specs, torch.Generator(device).manual_seed(0), device)
        state["step"] = state["step"].cpu()
        if state_sh is not None:
            state = distribute_tree(state, state_sh)

    it = data.sharded_iterator(batch_sh) if n_ranks > 1 else data.device_iterator(device)
    times: list[float] = []
    metrics = None
    try:
        for i in range(start_step, args.steps):
            batch = next(it)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            times.append(dt)
            if len(times) > 20:
                times.pop(0)
            med = statistics.median(times)
            if dt > args.slow_factor * med and len(times) > 5:
                print(f"[straggler-watchdog] step {i}: {dt:.2f}s vs median {med:.2f}s")
            if i % args.log_every == 0:
                print(
                    f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.3f}  {dt*1e3:.0f} ms"
                )
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, state, extra={"data": data.state()})
    finally:
        it.close()
    if mgr:
        mgr.save(args.steps, state, extra={"data": data.state()}, blocking=True)
    if metrics is None:
        print(f"nothing to do: the checkpoint is at step {start_step} >= --steps {args.steps}")
        return float("nan")
    print(f"done at step {args.steps}; final loss {float(metrics['loss']):.4f}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
