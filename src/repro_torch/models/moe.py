"""Mixture-of-Experts layer (the torch port of ``repro.models.moe``): top-k
routing with capacity-based dispatch, GShard style — one-hot dispatch and
combine tensors contracted densely with the tokens and the expert outputs.

Tokens are grouped per sample (G = batch, T = seq): routing and capacity
are per group, and the capacity follows the call's own sequence length, so
a one-token decode step has capacity k and a long prefill may drop tokens
(prefill + decode is then not a full forward, as in the reference).

Two places where torch's primitives differ from JAX's:

* ties — ``jax.lax.top_k`` keeps the lower expert index first on equal
  gates; ``torch.topk`` promises no order, so the top k are taken from a
  stable descending sort;
* dropped slots — ``jax.nn.one_hot(pos, c)`` is a zero row for pos ≥ c,
  where ``torch.nn.functional.one_hot`` raises, so the slot one-hot is a
  comparison with ``arange(c)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import P, cumsum, einsum

__all__ = ["moe_specs", "moe_apply", "route", "experts", "shared_expert"]


def moe_specs(cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs = {
        "router": P((d, e), ("embed", None)),
        # experts shard over 'model' (EP); their ff dim stays local
        "wi": P((e, d, ff), ("expert", "embed", "expert_mlp")),
        "wg": P((e, d, ff), ("expert", "embed", "expert_mlp")),
        "wo": P((e, ff, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.moe_shared_expert:
        specs["shared"] = {
            "wi": P((d, ff), ("embed", "mlp")),
            "wg": P((d, ff), ("embed", "mlp")),
            "wo": P((ff, d), ("mlp", "embed")),
        }
    return specs


def _capacity(cfg, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.experts_per_token / cfg.num_experts
            * cfg.moe_capacity_factor)
    return max(c, cfg.experts_per_token)


def top_k_lower_index_first(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    broken toward the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, params, x: torch.Tensor):
    """The router of ``moe_apply``: x (G, T, d) → (dispatch, combine, aux),
    the 0/1 dispatch and the gate-weighted combine tensors (G, T, E, C) in
    float32 and the load-balancing loss."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = _capacity(cfg, s)

    router_logits = x.float() @ params["router"].float()               # (G,T,E)
    gates = torch.softmax(router_logits, dim=-1)

    top_vals, top_idx = top_k_lower_index_first(gates, k)              # (G,T,K)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)

    # --- position-in-expert via k-major cumulative count --------------------
    onehot = F.one_hot(top_idx, e).float()                              # (G,T,K,E)
    flat = onehot.permute(0, 2, 1, 3).reshape(b, k * s, e)              # k-major (G,KT,E)
    pos = cumsum(flat, dim=1) - flat
    pos_scalar = torch.sum(pos * flat, dim=-1)                          # (G,KT)
    keep = (pos_scalar < c).float()
    slot_oh = (pos_scalar[..., None] == torch.arange(c, device=x.device)).float()
    # dispatch (G,KT,E,C), then fold the k slots back onto tokens
    dispatch_kt = flat[..., :, None] * slot_oh[..., None, :] * keep[..., None, None]
    dispatch = dispatch_kt.contiguous().reshape(b, k, s, e, c).sum(dim=1)   # (G,T,E,C)

    weights_kt = top_vals.permute(0, 2, 1).reshape(b, k * s)            # k-major weights
    combine_kt = dispatch_kt * weights_kt[..., None, None]
    combine = combine_kt.contiguous().reshape(b, k, s, e, c).sum(dim=1)     # (G,T,E,C)

    # load-balancing auxiliary loss (Switch-style), over the assignments
    # before the capacity drop
    density = torch.mean(onehot.sum(2), dim=1)                          # (G,E) token frac
    prob_mean = torch.mean(gates, dim=1)                                # (G,E)
    aux = e * torch.mean(torch.sum(density * prob_mean, dim=-1))
    return dispatch, combine, aux


def experts(params, expert_in: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their slots: (G, E, C, d) → (G, E, C, d)."""
    cd = expert_in.dtype
    h = einsum("gecd,edf->gecf", expert_in, params["wi"].to(cd))
    g = einsum("gecd,edf->gecf", expert_in, params["wg"].to(cd))
    return einsum("gecf,efd->gecd", F.silu(g) * h, params["wo"].to(cd))


def shared_expert(sh, x: torch.Tensor) -> torch.Tensor:
    cd = x.dtype
    return (F.silu(x @ sh["wg"].to(cd)) * (x @ sh["wi"].to(cd))) @ sh["wo"].to(cd)


def moe_apply(cfg, params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out, aux_loss).  B is the group axis."""
    dispatch, combine, aux = route(cfg, params, x)
    cd = x.dtype
    expert_in = einsum("gtec,gtd->gecd", dispatch.to(cd), x)      # (G,E,C,d)
    out = einsum("gtec,gecd->gtd", combine.to(cd), experts(params, expert_in))
    if cfg.moe_shared_expert:
        out = out + shared_expert(params["shared"], x)
    return out, aux
