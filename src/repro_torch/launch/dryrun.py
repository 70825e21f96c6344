"""Multi-pod dry-run: run every (arch × shape × mesh) cell once on stand-ins
(the torch port of ``repro.launch.dryrun``).

For each cell this:
  1. starts a *fake* world of 256 (16×16) or 512 (2×16×16) ranks in this
     one process (``torch.distributed``'s ``fake`` backend: collectives
     return at once) and builds the production ``DeviceMesh`` on it,
  2. builds ``meta`` DTensor stand-ins for the train/serve step inputs
     (params, optimizer state, batch, KV cache), placed by the rules —
     they allocate nothing: this is the one entry point that runs on no
     device,
  3. runs the train step, the prefill or the decode once under
     :class:`~repro_torch.analysis.op_cost.count_ops`, which counts one
     rank's FLOPs, bytes and collective bytes from the ops on its shards,
  4. records the roofline terms into a JSON row (``report.py`` renders
     them) and destroys the world.

There is no torch counterpart of XLA's ``memory_analysis``: the row's
``memory_analysis`` holds the bytes one rank holds of state (or served
params), batch and cache, from the local shard shapes, and no
temporaries (its ``source`` says so).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]

Skip rules (recorded, not silently dropped):
  * ``long_500k`` needs sub-quadratic attention → only ssm/hybrid run it;
  * every skip lands in the JSON with its reason.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import types

import numpy as np
import torch

from ..analysis.op_cost import count_ops
from ..analysis.roofline import analyze
from ..configs import ARCHS, SHAPES
from ..configs.base import ArchConfig, ShapeSpec
from ..models.layers import abstract_params, tree_leaves
from ..models.model_zoo import build_model
from ..sharding.partitioning import (RULES_MULTI_POD, RULES_SINGLE_POD, ShardingRules,
                                     distribute_tree, make_shardings)
from ..train.serve_step import make_decode_fn, make_prefill_fn
from ..train.train_step import jit_train_step
from .mesh import make_production_mesh

__all__ = ["fake_world", "should_skip", "model_flops_for", "lower_cell", "run_cell", "main"]


@contextlib.contextmanager
def fake_world(count: int = 512):
    """A ``fake`` process group of ``count`` ranks in this process, this
    process rank 0 — the counterpart of the reference's forced host device
    count — destroyed on exit, so that the process is clean after it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=count)
    try:
        yield
    finally:
        dist.destroy_process_group()


def should_skip(cfg: ArchConfig, shape: ShapeSpec) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k requires sub-quadratic attention (full-attn arch)"
    return None


def _local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensor leaves (DTensors: the local shard)."""
    out = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            out += local.numel() * local.element_size()
    return out


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: ShardingRules):
    """Run the cell's step once on ``meta`` DTensor stand-ins under the op
    counter: ``(OpCost of one rank, bytes one rank holds of state, batch
    and cache)``."""
    model = build_model(cfg, tp_degree=mesh["model"].size())
    batch_sh = make_shardings(model.batch_axes(shape), mesh, rules)
    batch = model.input_specs(shape)
    if shape.kind == "train":
        step, state_specs, state_sh, _ = jit_train_step(cfg, shape, mesh, rules)
        state = distribute_tree(abstract_params(state_specs), state_sh)
        batch = distribute_tree(batch, batch_sh)
        held = _local_bytes(state) + _local_bytes(batch)
        with count_ops() as counter:
            step(state, batch)
    elif shape.kind == "prefill":
        prefill, pspecs = make_prefill_fn(cfg, shape, mesh=mesh, rules=rules)
        params = distribute_tree(abstract_params(pspecs), prefill.param_sh)
        batch = distribute_tree(batch, batch_sh)
        with count_ops() as counter:
            _, cache = prefill(params, batch)
        held = _local_bytes(params) + _local_bytes(batch) + _local_bytes(cache)
    else:  # decode: one token against a cache filled but for its last position
        decode, pspecs, cspecs = make_decode_fn(cfg, shape, mesh=mesh, rules=rules)
        params = distribute_tree(abstract_params(pspecs), decode.param_sh)
        cache = distribute_tree(abstract_params(cspecs), decode.cache_sh)
        tokens = distribute_tree(batch["tokens"], batch_sh["tokens"])
        held = _local_bytes(params) + _local_bytes(tokens) + _local_bytes(cache)
        with count_ops() as counter:
            decode(params, {"tokens": tokens, "cache_len": shape.seq_len - 1}, cache)
    return counter.cost, held


def model_flops_for(cfg: ArchConfig, shape: ShapeSpec) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def _effective_rules(rules: ShardingRules, shape: ShapeSpec, mesh) -> ShardingRules:
    """Drop the batch mapping to replicated when the global batch doesn't
    divide the batch mesh axes (e.g. long_500k's batch of 1)."""
    bmap = rules.mapping.get("batch")
    if bmap is not None:
        axes = (bmap,) if isinstance(bmap, str) else tuple(bmap)
        size = int(np.prod([mesh.shape[a] for a in axes]))
        if shape.global_batch % size:
            rules = ShardingRules({**rules.mapping, "batch": None})
    return rules


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             rules: ShardingRules | None = None) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    skip = should_skip(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if skip:
        return {**base, "status": "skip", "reason": skip}
    chips = 512 if multi_pod else 256
    t0 = time.perf_counter()
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            rules = rules or (RULES_MULTI_POD if multi_pod else RULES_SINGLE_POD)
            # _effective_rules reads mesh.shape[name], as a JAX mesh answers it
            sizes = types.SimpleNamespace(shape=dict(zip(mesh.mesh_dim_names, mesh.shape)))
            rules = _effective_rules(rules, shape, sizes)
            cost, held = lower_cell(cfg, shape, mesh, rules)
    except Exception as e:
        return {
            **base, "status": "fail",
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:],
        }
    dt = time.perf_counter() - t0
    report = analyze(
        cost, arch=arch, shape=shape_name, mesh_name=mesh_name,
        chips=chips, model_flops=model_flops_for(cfg, shape), peak_memory_bytes=held,
    )
    row = report.row()
    row.update(
        status="ok",
        run_seconds=dt,
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        memory_analysis={"arg_GiB": held / 2**30, "temp_GiB": 0.0, "output_GiB": 0.0,
                         "alias_GiB": 0.0,
                         "source": "bytes one rank holds of state (or served params), batch "
                                   "and cache, from the local shard shapes; temporaries not "
                                   "counted (torch has no memory_analysis)"},
    )
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results_torch.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    rows = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in rows}
    for a, s, mp in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        if (a, s, mesh_name) in done:
            continue
        row = run_cell(a, s, multi_pod=mp)
        status = row["status"]
        extra = (
            f"run={row.get('run_seconds', 0):.1f}s "
            f"bottleneck={row.get('bottleneck', '-')}"
            if status == "ok"
            else row.get("reason", row.get("error", ""))[:120]
        )
        print(f"[{status:4s}] {a:28s} {s:12s} {mesh_name:8s} {extra}", flush=True)
        rows.append(row)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skip" for r in rows)
    n_fail = sum(r["status"] == "fail" for r in rows)
    print(f"done: {n_ok} ok / {n_skip} skip / {n_fail} fail → {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
