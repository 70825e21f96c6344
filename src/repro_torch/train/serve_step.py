"""Serving steps: prefill (prompt → cache) and decode (one token vs cache),
the torch port of ``repro.train.serve_step``.

Served weights are bfloat16 copies of the training params; the decode
writes each new entry into the preallocated KV cache in place (the
reference donates the cache to the same effect), so a step allocates no
new cache.

Given a ``mesh`` and ``rules``, the steps are sharded (the 2-D layout of
:mod:`repro_torch.sharding`): they place the served params by
:func:`serve_param_specs`, the batch by the model's ``batch_axes`` and the
decode's cache by ``cache_specs`` (``make_shardings`` and
``distribute_tree``: already-placed DTensors are redistributed only where
they differ), and run eagerly under ``use_rules(rules)`` and
``implicit_replication()``, with the model built for the mesh's 'model'
degree unless ``tp_degree`` names another (the KV heads are repeated
toward it; without a mesh it defaults to 16).  The shardings are
attributes of the returned step (``param_sh``, ``batch_sh``, and
``cache_sh`` on the decode).
"""

from __future__ import annotations

import contextlib

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models.layers import P, tree_map
from ..models.model_zoo import build_model
from ..sharding.partitioning import ShardingRules, distribute_tree, make_shardings, use_rules

__all__ = ["serve_param_specs", "make_prefill_fn", "make_decode_fn"]


def serve_param_specs(cfg: ArchConfig):
    """bf16 copies of the parameter specs (weights as served)."""
    return tree_map(lambda s: P(s.shape, s.axes, s.init, s.scale, torch.bfloat16),
                    build_model(cfg).param_specs())


def _layout(mesh, rules, tp_degree):
    """(tp degree, the context a sharded step runs in): the given degree,
    else the mesh's 'model' degree (16 without a mesh)."""
    if mesh is None:
        return 16 if tp_degree is None else tp_degree, contextlib.nullcontext
    from torch.distributed.tensor.experimental import implicit_replication

    if rules is None:
        raise ValueError("a sharded serve step needs rules with its mesh")
    tp = mesh["model"].size() if "model" in (mesh.mesh_dim_names or ()) else 1
    tp = tp if tp_degree is None else tp_degree

    @contextlib.contextmanager
    def ctx():
        with use_rules(rules), implicit_replication():
            yield

    return tp, ctx


def make_prefill_fn(cfg: ArchConfig, shape: ShapeSpec, tp_degree: int | None = None, *, mesh=None,
                    rules: ShardingRules | None = None):
    """``(prefill(params, batch) -> (last logits, cache), param specs)``;
    the cache holds ``shape.seq_len`` positions.  With ``mesh`` and
    ``rules`` the step is sharded (the module's docstring)."""
    tp_degree, ctx = _layout(mesh, rules, tp_degree)
    model = build_model(cfg, tp_degree)
    max_len = shape.seq_len
    pspecs = serve_param_specs(cfg)
    param_sh = batch_sh = None
    if mesh is not None:
        param_sh = make_shardings(pspecs, mesh, rules)
        batch_sh = make_shardings(model.batch_axes(shape), mesh, rules)

    @torch.no_grad()
    def prefill(params, batch):
        with ctx():
            if mesh is not None:
                params = distribute_tree(params, param_sh)
                batch = distribute_tree(batch, {k: batch_sh[k] for k in batch})
            return model.prefill(params, batch, max_len)

    prefill.param_sh, prefill.batch_sh = param_sh, batch_sh
    return prefill, pspecs


def make_decode_fn(cfg: ArchConfig, shape: ShapeSpec, tp_degree: int | None = None, *, mesh=None,
                   rules: ShardingRules | None = None):
    """``(decode(params, batch, cache) -> (logits, cache), param specs,
    cache specs)``; ``batch = {"tokens": (B, 1), "cache_len": int}``.  With
    ``mesh`` and ``rules`` the step is sharded (the module's docstring)."""
    tp_degree, ctx = _layout(mesh, rules, tp_degree)
    model = build_model(cfg, tp_degree)
    pspecs = serve_param_specs(cfg)
    cspecs = model.cache_specs(shape.global_batch, shape.seq_len)
    param_sh = batch_sh = cache_sh = None
    if mesh is not None:
        param_sh = make_shardings(pspecs, mesh, rules)
        batch_sh = make_shardings(model.batch_axes(shape), mesh, rules)
        cache_sh = make_shardings(cspecs, mesh, rules)

    @torch.no_grad()
    def decode(params, batch, cache):
        with ctx():
            if mesh is not None:
                params = distribute_tree(params, param_sh)
                batch = {**batch, "tokens": distribute_tree(batch["tokens"], batch_sh["tokens"])}
                cache = distribute_tree(cache, cache_sh)
            return model.decode(params, batch, cache)

    decode.param_sh, decode.batch_sh, decode.cache_sh = param_sh, batch_sh, cache_sh
    return decode, pspecs, cspecs
