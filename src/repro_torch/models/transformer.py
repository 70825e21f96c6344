"""Decoder-only transformer assembly: the dense, MoE, VLM and RWKV6 (``ssm``)
families (the torch port of ``repro.models.transformer``).

Blocks are *stacked* on a leading 'layers' axis, as in the reference, so
parameter trees, checkpoints and :func:`~repro_torch.convert.lm_params_from_numpy`
map key for key.  A forward takes the per-layer views with one
``torch.unbind`` per leaf (its backward is a single ``stack``) and runs the
layers in a Python loop; with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` — nothing saved, or (``remat_policy="dots"``)
the outputs of the non-batched matmuls, the reference's
``dots_with_no_batch_dims_saveable``.

A MoE layer's load-balancing loss is summed over the layers and enters
``lm_loss`` as ``+ 0.01·aux``.  An RWKV6 forward or prefill starts every
layer from a zero state; decode carries the per-layer states in the cache
and updates them in place, as it writes the KV cache.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import moe as moe_mod
from . import rwkv6 as rwkv
from .layers import P, dot_f32, flatten_with_paths, mlp_apply, mlp_specs, rms_norm, stack_specs

__all__ = [
    "decoder_specs",
    "decoder_forward",
    "decoder_prefill",
    "decoder_decode",
    "decoder_cache_specs",
    "kv_repeat_for",
    "lm_loss",
    "nll",
    "vocab_mask",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _block_specs(cfg):
    d = cfg.d_model
    if cfg.family == "ssm":                       # rwkv6
        return rwkv.rwkv6_block_specs(cfg)
    block = {
        "ln1": P((d,), (None,), "ones"),
        "attn": attn.attention_specs(cfg),
        "ln2": P((d,), (None,), "ones"),
    }
    if cfg.num_experts:
        block["moe"] = moe_mod.moe_specs(cfg)
    else:
        block["mlp"] = mlp_specs(d, cfg.d_ff, cfg.mlp)
    return block


def vocab_mask(cfg, device=None):
    """(padded_vocab,) additive float32 mask: 0 on real tokens, −1e30 on
    padding; None when the vocabulary needs no padding."""
    pv = cfg.padded_vocab
    if pv == cfg.vocab_size:
        return None
    return torch.as_tensor(np.where(np.arange(pv) < cfg.vocab_size, 0.0, -1e30),
                           dtype=torch.float32, device=device)


def decoder_specs(cfg) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    specs = {
        "embed": P((v, d), ("vocab", "embed"), scale=1.0),
        "blocks": stack_specs(_block_specs(cfg), cfg.num_layers),
        "final_ln": P((d,), (None,), "ones"),
        "unembed": P((d, v), ("embed", "vocab")),
    }
    if cfg.frontend == "patch_embed":
        # stubbed modality frontend: a single projection of precomputed
        # patch embeddings into the residual stream
        specs["patch_proj"] = P((d, d), ("embed", "heads"))
    return specs


def _embed_inputs(cfg, params, batch, compute_dtype):
    x = F.embedding(batch["tokens"], params["embed"]).to(compute_dtype)
    if cfg.frontend == "patch_embed" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(compute_dtype)
        ve = ve @ params["patch_proj"].to(compute_dtype)
        x = torch.cat([ve, x], dim=1)
    return x


def _layers(tree) -> list[dict]:
    """The per-layer views of a stacked tree: one ``unbind`` per leaf."""
    paths = flatten_with_paths(tree)
    cols = [torch.unbind(leaf, 0) for _, leaf in paths]
    out = []
    for i in range(len(cols[0]) if cols else 0):
        layer: dict = {}
        for (path, _), col in zip(paths, cols):
            node = layer
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = col[i]
        out.append(layer)
    return out


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _ffn(cfg, blk, h):
    """The block's MLP, or its MoE layer: (out, aux loss or None)."""
    if cfg.num_experts:
        return moe_mod.moe_apply(cfg, blk["moe"], h)
    return mlp_apply(blk["mlp"], h, cfg.mlp), None


def _dense_block(cfg, blk, x, positions):
    h = rms_norm(x, blk["ln1"])
    a, _ = attn.attention_train(cfg, blk["attn"], h, positions)
    x = x + a
    h = rms_norm(x, blk["ln2"])
    m, aux = _ffn(cfg, blk, h)
    return x + m, aux


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Save the outputs of 2-D matmuls (a layer's weight products, which
    carry no batch dimension) and recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _run_layer(cfg, fn, x, blk):
    """One layer, under ``cfg.remat``'s activation checkpointing when the
    graph is being recorded."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(x, blk)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, x, blk, use_reentrant=False, **kw)


def _unembed(cfg, params, x, cdt):
    x = rms_norm(x, params["final_ln"])
    logits = dot_f32(x, params["unembed"].to(cdt))
    mask = vocab_mask(cfg, x.device)
    if mask is not None:
        logits = logits + mask
    return logits


def decoder_forward(cfg, params, batch):
    """Full causal forward → (logits (B, S, padded_vocab) in float32, the
    MoE aux loss summed over the layers, a float32 scalar: 0 without
    experts)."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = _embed_inputs(cfg, params, batch, cdt)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)

    def layer(x, blk):
        if cfg.family == "ssm":
            return rwkv.rwkv6_block(cfg, blk, x, rwkv.zero_state(cfg, b, cdt, x.device))[0], None
        return _dense_block(cfg, blk, x, positions)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in _layers(params["blocks"]):
        x, a = _run_layer(cfg, layer, x, blk)
        if a is not None:
            aux = aux + a.float()
    return _unembed(cfg, params, x, cdt), aux


def nll(logits, labels):
    """Mean next-token negative log-likelihood of float32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - true)


def lm_loss(cfg, params, batch):
    logits, aux = decoder_forward(cfg, params, batch)
    if cfg.frontend == "patch_embed" and "vision_embeds" in batch:
        # loss only over text positions (vision prefix predicts nothing)
        logits = logits[:, batch["vision_embeds"].shape[1]:]
    loss = nll(logits, batch["labels"])
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    return loss


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def kv_repeat_for(cfg, tp_degree: int = 16) -> int:
    """Replicate kv heads toward the TP degree, bounded by the GQA group
    size (kv·rep must still divide q heads)."""
    kvh, h = cfg.num_kv_heads, cfg.num_heads
    if not kvh or kvh >= tp_degree:
        return 1
    rep = min(tp_degree // kvh, h // kvh)
    while rep > 1 and (h % (kvh * rep) or tp_degree % (kvh * rep)):
        rep -= 1
    return max(rep, 1)


def decoder_cache_specs(cfg, batch: int, max_len: int, tp_degree: int = 16):
    if cfg.family == "ssm":
        return stack_specs(rwkv.rwkv6_state_specs(cfg, batch), cfg.num_layers)
    rep = kv_repeat_for(cfg, tp_degree)
    per_layer = attn.init_kv_cache_specs(cfg, batch, max_len, rep, tp_degree=tp_degree)
    return stack_specs(per_layer, cfg.num_layers)


def decoder_prefill(cfg, params, batch, max_len: int, tp_degree: int = 16):
    """Run the full prompt, return (last-token logits (B, 1, V) float32,
    cache): {"k", "v"}: (L, B, max_len, KV·rep, D) bfloat16, zero past the
    prompt; for RWKV6 the states after the prompt, {"wkv"} (L, B, H, D, D)
    float32 and {"shift", "shift_c"} (L, B, d) in the compute dtype."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = _embed_inputs(cfg, params, batch, cdt)
    b, s, _ = x.shape
    if cfg.family == "ssm":
        states = []
        for blk in _layers(params["blocks"]):
            x, st = rwkv.rwkv6_block(cfg, blk, x, rwkv.zero_state(cfg, b, cdt, x.device))
            states.append(st)
        cache = {key: torch.stack([st[key] for st in states]) for key in states[0]}
        return _unembed(cfg, params, x[:, -1:], cdt), cache
    positions = _positions(b, s, x.device)
    rep = kv_repeat_for(cfg, tp_degree)
    shape = (cfg.num_layers, b, max_len, cfg.num_kv_heads * rep, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=x.device),
             "v": torch.zeros(shape, dtype=torch.bfloat16, device=x.device)}
    for i, blk in enumerate(_layers(params["blocks"])):
        h = rms_norm(x, blk["ln1"])
        a, (k, v) = attn.attention_train(cfg, blk["attn"], h, positions)
        x = x + a
        h = rms_norm(x, blk["ln2"])
        x = x + _ffn(cfg, blk, h)[0]
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    return _unembed(cfg, params, x[:, -1:], cdt), cache


def decoder_decode(cfg, params, batch, cache, tp_degree: int = 16):
    """One decode step: batch = {tokens (B, 1), cache_len (a host int)} →
    (logits (B, 1, V) float32, cache), the cache updated in place."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = F.embedding(batch["tokens"], params["embed"]).to(cdt)
    if cfg.family == "ssm":
        for blk, st in zip(_layers(params["blocks"]), _layers(cache)):
            x, new = rwkv.rwkv6_decode_step(cfg, blk, x, st)
            for key, t in st.items():
                t.copy_(new[key])
        return _unembed(cfg, params, x, cdt), cache
    cache_len = int(batch["cache_len"])
    rep = kv_repeat_for(cfg, tp_degree)
    for blk, k_l, v_l in zip(_layers(params["blocks"]), torch.unbind(cache["k"], 0),
                             torch.unbind(cache["v"], 0)):
        h = rms_norm(x, blk["ln1"])
        a, _, _ = attn.attention_decode(cfg, blk["attn"], h, k_l, v_l, cache_len, rep)
        x = x + a
        h = rms_norm(x, blk["ln2"])
        x = x + _ffn(cfg, blk, h)[0]
    return _unembed(cfg, params, x, cdt), cache
