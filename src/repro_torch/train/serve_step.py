"""Serving steps on one device: prefill (prompt → cache) and decode (one
token vs cache), the torch port of ``repro.train.serve_step``.

Served weights are bfloat16 copies of the training params; the decode
writes each new entry into the preallocated KV cache in place (the
reference donates the cache to the same effect), so a step allocates no
new cache.  The sharded forms come with the 2-D layout (ROADMAP A17c).
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models.layers import P, tree_map
from ..models.model_zoo import build_model

__all__ = ["serve_param_specs", "make_prefill_fn", "make_decode_fn"]


def serve_param_specs(cfg: ArchConfig):
    """bf16 copies of the parameter specs (weights as served)."""
    return tree_map(lambda s: P(s.shape, s.axes, s.init, s.scale, torch.bfloat16),
                    build_model(cfg).param_specs())


def make_prefill_fn(cfg: ArchConfig, shape: ShapeSpec, tp_degree: int = 16):
    """``(prefill(params, batch) -> (last logits, cache), param specs)``;
    the cache holds ``shape.seq_len`` positions."""
    model = build_model(cfg, tp_degree)
    max_len = shape.seq_len

    @torch.no_grad()
    def prefill(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill, serve_param_specs(cfg)


def make_decode_fn(cfg: ArchConfig, shape: ShapeSpec, tp_degree: int = 16):
    """``(decode(params, batch, cache) -> (logits, cache), param specs,
    cache specs)``; ``batch = {"tokens": (B, 1), "cache_len": int}``."""
    model = build_model(cfg, tp_degree)

    @torch.no_grad()
    def decode(params, batch, cache):
        return model.decode(params, batch, cache)

    return decode, serve_param_specs(cfg), model.cache_specs(shape.global_batch, shape.seq_len)
