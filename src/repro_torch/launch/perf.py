"""Perf-iteration harness: re-run a dry-run cell under a named optimization
variant and diff the roofline terms against baseline (the torch port of
``repro.launch.perf``).

Variants are *declarative* — a rules patch + a config patch — so each
hypothesis maps to one named entry here:

  seqpar        sequence parallelism: shard the seq dim of activations over
                'model' between blocks (Megatron-SP).
  bigchunk      flash-attention KV chunk 1024 → 4096.
  seqpar+bigchunk  both.
  seqcache      decode: shard the KV-cache *sequence* dim over 'model'
                instead of replicating kv heads to TP.
  dp_attn       attention runs data-parallel (heads replicated), MLP keeps
                TP: removes the per-layer attention boundary collectives.
  gradbf16      bf16 gradient accumulation.
  nomicro       halve grad-accum microbatches (×2 microbatch size).

Each variant runs through :func:`~repro_torch.launch.dryrun.run_cell` in a
fake world, as the dry-run does.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-4b \\
        --shape train_4k --variants baseline,seqpar,dp_attn
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..configs import ARCHS, SHAPES  # noqa: F401
from ..sharding.partitioning import RULES_SINGLE_POD, ShardingRules
from .dryrun import run_cell

__all__ = ["VARIANTS", "run_variant", "main"]


def _patched_rules(base: ShardingRules, patch: dict) -> ShardingRules:
    return ShardingRules({**base.mapping, **patch})


VARIANTS: dict = {
    "baseline": (dict(), dict()),
    "seqpar": ({"seq_act": "model"}, dict()),
    "bigchunk": (dict(), {"attn_chunk": 4096}),
    "seqpar+bigchunk": ({"seq_act": "model"}, {"attn_chunk": 4096}),
    "hugechunk": (dict(), {"attn_chunk": 8192}),
    "seqcache": ({"seq_cache": "model", "kv_cache": None}, dict()),
    "dp_attn": ({"heads": None, "kv": None, "kv_cache": None}, dict()),
    "gradbf16": (dict(), {"grad_dtype": "bfloat16"}),
    "nomicro": (dict(), "HALVE_MICRO"),
    "micro2": (dict(), "MICRO_2"),
    "dp_attn+bigchunk": ({"heads": None, "kv": None, "kv_cache": None},
                         {"attn_chunk": 4096}),
    "ssmchunk512": (dict(), {"ssm_chunk": 512}),
    "remat_dots": (dict(), {"remat_policy": "dots"}),
    "remat_dots+bigchunk": (dict(), {"remat_policy": "dots", "attn_chunk": 4096}),
    "ep_ffshard": ({"embed": None, "expert_mlp": "data"}, dict()),
    "ep_ffshard+micro2": ({"embed": None, "expert_mlp": "data"}, "MICRO_2"),
    "ssmchunk1024": (dict(), {"ssm_chunk": 1024}),
}


def run_variant(arch: str, shape: str, variant: str) -> dict:
    rules_patch, cfg_patch = VARIANTS[variant]
    cfg = ARCHS[arch]
    if cfg_patch == "HALVE_MICRO":
        mb = dict(cfg.microbatches)
        if shape in mb and mb[shape] > 1:
            mb[shape] = mb[shape] // 2
        cfg_patch = {"microbatches": mb}
    elif cfg_patch == "MICRO_2":
        cfg_patch = {"microbatches": {**dict(cfg.microbatches), shape: 2}}
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    rules = _patched_rules(RULES_SINGLE_POD, rules_patch)
    # run through the dry-run's cell runner with the patched config in place
    saved = ARCHS[arch]
    ARCHS[arch] = cfg
    try:
        row = run_cell(arch, shape, multi_pod=False, rules=rules)
    finally:
        ARCHS[arch] = saved
    row["variant"] = variant
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out", default="perf_results_torch.json")
    args = ap.parse_args(argv)

    rows = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    for v in args.variants.split(","):
        row = run_variant(args.arch, args.shape, v)
        ok = row["status"] == "ok"
        print(
            f"[{row['status']}] {args.arch} {args.shape} {v:18s} "
            + (
                f"comp={row['t_compute_s']:.3g} mem={row['t_memory_s']:.3g} "
                f"coll={row['t_collective_s']:.3g} bneck={row['bottleneck']} "
                f"frac={row['roofline_fraction']:.4f}"
                if ok
                else row.get("error", "")[:160]
            ),
            flush=True,
        )
        rows = [
            r for r in rows
            if not (r["arch"] == args.arch and r["shape"] == args.shape
                    and r.get("variant") == v)
        ]
        rows.append(row)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    return 1 if any(r["status"] == "fail" for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
