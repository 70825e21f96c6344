"""Every parameter's gradient of the LM's sharded train step against one rank's, on one card.

Four gloo ranks on the card run ``chip_smoke.py``'s ``lm_layout`` (b) cell
(qwen3-4b's published widths at depth 2, 8 × 128 tokens, AdamW at lr 3e-4
with one warmup step) on a (2, 2) mesh; rank 0 runs the same draw on one
rank.  For each parameter leaf: the step-1 gradient's relative difference
from one rank's, the weights' difference after one update (relative to the
update), and the step-2 gradient's difference and norms.  One rank's own
spread between one and two microbatches (another summation order) is the
measure of rounding to read them against.  With ``--serve``, the sharded
prefill and 8 decode steps in the configuration's bfloat16 compute against
one rank's, as a fraction of the logits' scale.

    python3 tools/lm_layout_grads.py [--float32] [--serve]

Needs one CUDA card; imports no JAX.  Prints one JSON object a compute
dtype.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SHAPE = {"layers": 2, "batch": 8, "seq": 128, "lr": 3e-4, "warmup": 1, "steps": 3}
SERVE = {"batch": 4, "prompt": 128, "decode_steps": 8}
OPTS_ENV = "LM_LAYOUT_GRADS_OPTS"   # the command line's choices, for the spawned ranks


def _grads(model, params, batch):
    """(loss, one gradient a leaf placed as its parameter)."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.sharding.partitioning import placed_like

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = [placed_like(g, p) for g, p in zip(torch.autograd.grad(loss, leaves), leaves)]
    for p in leaves:
        p.requires_grad_(False)
    loss = loss.detach()
    return float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss), grads


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().float()


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _one_rank(cfg, shape, kw, batches, on_card):
    """One rank from the same draw: step-1 gradients, the weights before and
    after one step, step-2 gradients; the losses and norms of the steps with
    one and with two microbatches."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import make_train_state_specs, make_train_step

    model = build_model(cfg)
    st = cs._layout_state(make_train_state_specs(cfg), None, cs.LM_PIN_SEED)
    ref = {"p0": [t.detach().clone() for t in tree_leaves(st["params"])]}
    _, ref["g1"] = _grads(model, st["params"], on_card(batches[0]))
    st, _ = make_train_step(cfg, shape, **kw)(st, on_card(batches[0]))
    ref["p1"] = [t.detach().clone() for t in tree_leaves(st["params"])]
    _, ref["g2"] = _grads(model, st["params"], on_card(batches[1]))
    del st
    runs = {}
    for micro in (1, 2):
        mcfg = dataclasses.replace(cfg, microbatches={shape.name: micro})
        st = cs._layout_state(make_train_state_specs(mcfg), None, cs.LM_PIN_SEED)
        step = make_train_step(mcfg, shape, **kw)
        losses, norms = [], []
        for b in batches:
            st, m = step(st, on_card(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        runs[f"microbatches_{micro}"] = {"losses": losses, "grad_norms": norms}
        del st
    torch.cuda.empty_cache()
    return ref, runs


def _serve(cfg, mesh, rules, params, rank):
    """The sharded prefill and decode on ``params`` cast to bfloat16 against
    one rank's: the largest difference a call, as a fraction of the largest
    logit."""
    import numpy as np

    from repro_torch.configs import ShapeSpec
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_map
    from repro_torch.train.serve_step import make_decode_fn, make_prefill_fn

    b, s, n = SERVE["batch"], SERVE["prompt"], SERVE["decode_steps"]
    served = tree_map(lambda x: x.to(torch.bfloat16), params)
    shape = ShapeSpec("lm_layout_serve", "prefill", s + n, b)
    prefill, _ = make_prefill_fn(cfg, shape, mesh=mesh, rules=rules)
    decode, _, _ = make_decode_fn(cfg, shape, mesh=mesh, rules=rules)
    rng = np.random.default_rng(cs.LM_PIN_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + n)).astype(np.int32))
    step_toks = [{"tokens": toks[:, s + i:s + i + 1].to("cuda"), "cache_len": s + i}
                 for i in range(n)]
    logits, cache = prefill(served, {"tokens": toks[:, :s].to("cuda")})
    got = [_full(logits)]
    for t in step_toks:
        logits, cache = decode(served, t, cache)
        got.append(_full(logits))
    full = tree_map(lambda x: x.full_tensor(), served)
    if rank != 0:
        return None
    model = build_model(cfg, tp_degree=mesh["model"].size())
    with torch.no_grad():
        logits, cache = model.prefill(full, {"tokens": toks[:, :s].to("cuda")}, s + n)
        want = [logits.float()]
        for t in step_toks:
            logits, cache = model.decode(full, t, cache)
            want.append(logits.float())
    v = cfg.vocab_size
    return [float((g[..., :v] - w[..., :v]).abs().max() / w[..., :v].abs().max())
            for g, w in zip(got, want)]


def _job(rank: int, size: int) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import flatten_with_paths, tree_leaves
    from repro_torch.sharding import RULES_SINGLE_POD, distribute_tree, use_rules
    from repro_torch.train import jit_train_step

    opts = json.loads(os.environ[OPTS_ENV])
    mesh = make_host_mesh(2, 2, device_type="cuda")
    out = {}
    for cdt in opts["dtypes"]:
        cfg = cs._layout_cfg(SHAPE["layers"], compute_dtype=cdt)
        shape = ShapeSpec("lm_layout_four", "train", SHAPE["seq"], SHAPE["batch"])
        kw = {"lr": SHAPE["lr"], "warmup": SHAPE["warmup"], "total_steps": SHAPE["steps"]}
        batches = cs._layout_batches(cfg, SHAPE["seq"], SHAPE["batch"], SHAPE["steps"])

        def on_card(b):
            return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}

        step, specs, state_sh, batch_sh = jit_train_step(cfg, shape, mesh, RULES_SINGLE_POD, **kw)
        res = {"compute_dtype": cdt, "leaves": {}}
        ref = None
        if rank == 0:
            ref, res["one_rank"] = _one_rank(cfg, shape, kw, batches, on_card)
        dist.barrier()
        paths = ["/".join(map(str, p)) for p, _ in flatten_with_paths(specs["params"])]
        leaves = res["leaves"]
        state = cs._layout_state(specs, state_sh, cs.LM_PIN_SEED)
        model = build_model(cfg, tp_degree=mesh["model"].size())

        def sharded_grads(batch):
            with use_rules(RULES_SINGLE_POD), implicit_replication():
                return _grads(model, state["params"], distribute_tree(on_card(batch), batch_sh))

        _, grads = sharded_grads(batches[0])
        for i, g in enumerate(grads):
            g = _full(g)
            if ref is not None:
                leaves[paths[i]] = {"step1_grad_rel": _rel(g, ref["g1"][i].float())}
        del grads
        state, _ = step(state, distribute_tree(on_card(batches[0]), batch_sh))
        for i, p in enumerate(tree_leaves(state["params"])):
            p = _full(p)
            if ref is not None:
                p0, p1 = ref["p0"][i].float(), ref["p1"][i].float()
                leaves[paths[i]]["weights_after_1_over_update"] = float(
                    (p - p1).norm() / (p1 - p0).norm().clamp_min(1e-30))
        res["step2_loss"], grads = sharded_grads(batches[1])
        for i, g in enumerate(grads):
            g = _full(g)
            if ref is not None:
                o = ref["g2"][i].float()
                leaves[paths[i]].update(step2_grad_rel=_rel(g, o), step2_norm=float(g.norm()),
                                        step2_norm_one_rank=float(o.norm()))
        del grads, ref
        if opts["serve"] and cdt == "bfloat16":
            res["serve_rel_errs"] = _serve(cfg, mesh, RULES_SINGLE_POD, state["params"], rank)
        del state
        torch.cuda.empty_cache()
        dist.barrier()
        out[cdt] = res
    return out


cs.LAYOUT_JOBS["grads"] = ("gloo", 4, _job)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--float32", action="store_true", help="also in float32 compute")
    ap.add_argument("--serve", action="store_true",
                    help="also the bf16 sharded prefill/decode against one rank's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_layout_grads: no CUDA device", file=sys.stderr)
        return 2
    os.environ[OPTS_ENV] = json.dumps(
        {"dtypes": ["bfloat16", "float32"] if args.float32 else ["bfloat16"],
         "serve": args.serve})
    print(cs.device_line()[0])
    got, errors, _ = cs._layout_world("grads", 900)
    for err in errors:
        print(err, file=sys.stderr)
    for res in (got.get(0) or {}).values():
        print(json.dumps(res))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
