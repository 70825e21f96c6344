"""Zamba2-style hybrid (the torch port of ``repro.models.hybrid``): a Mamba2
backbone plus one weight-*shared* attention block invoked every
``shared_attn_every`` layers, with per-invocation LoRA adapters on the
attention projections (arXiv:2411.15242).

Layer layout for L layers, period p: G = L // p groups of p Mamba2 blocks,
each followed by one shared-attention invocation; the remaining L − G·p
Mamba2 blocks form a tail (zamba2-7b: 81 layers are 13 groups of 6 and a
tail of 3).  The parameters keep the reference's nested stacks: ``groups``
leaves are (G, p, …), ``lora`` leaves (G, …), ``tail`` leaves (L − G·p, …);
a KV cache is allocated only for the G invocations.

Two roundings are the reference's and are kept: the LoRA delta is cast to
the *weight* dtype in train and prefill, and to the *compute* dtype in
decode.  With ``cfg.remat`` both each Mamba2 block and each whole group run
under activation checkpointing, as the reference wraps both bodies.
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import mamba2 as m2
from .layers import P, mlp_apply, mlp_specs, norm_in, stack_specs
from ..sharding.partitioning import annotate, sharded_zeros
from .transformer import (_cache_head_axis, _embed_inputs, _layers, _positions, _run_layer,
                          _unembed, _use, kv_repeat_for, nll, torch_dtype)

__all__ = [
    "hybrid_specs",
    "hybrid_forward",
    "hybrid_loss",
    "hybrid_prefill",
    "hybrid_decode",
    "hybrid_cache_specs",
]


def _layout(cfg):
    p = cfg.shared_attn_every
    groups = cfg.num_layers // p
    tail = cfg.num_layers - groups * p
    return groups, p, tail


def _lora_specs(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    r = cfg.shared_attn_lora_rank
    return {
        "qa": P((d, r), ("embed", None), scale=1.0),
        "qb": P((r, h * hd), (None, "heads"), "zeros"),
        "ka": P((d, r), ("embed", None), scale=1.0),
        "kb": P((r, kv * hd), (None, "kv"), "zeros"),
        "va": P((d, r), ("embed", None), scale=1.0),
        "vb": P((r, kv * hd), (None, "kv"), "zeros"),
    }


def hybrid_specs(cfg) -> dict:
    groups, p, tail = _layout(cfg)
    mamba = m2.mamba2_block_specs(cfg)
    d = cfg.d_model
    shared = {
        "ln1": P((d,), (None,), "ones"),
        "attn": attn.attention_specs(cfg),
        "ln2": P((d,), (None,), "ones"),
        "mlp": mlp_specs(d, cfg.d_ff, "swiglu"),
    }
    specs = {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed"), scale=1.0),
        "groups": stack_specs(stack_specs(mamba, p), groups),
        "shared": shared,
        "lora": stack_specs(_lora_specs(cfg), groups),
        "final_ln": P((d,), (None,), "ones"),
        "unembed": P((d, cfg.padded_vocab), ("embed", "vocab")),
    }
    if tail:
        specs["tail"] = stack_specs(mamba, tail)
    return specs


def _lora_attn(shared_attn, lora, dtype_of):
    """The shared attention's weights with each LoRA delta folded in, the
    delta cast by ``dtype_of(weight)``."""
    ap = dict(shared_attn)
    for w, a, b in (("wq", "qa", "qb"), ("wk", "ka", "kb"), ("wv", "va", "vb")):
        ap[w] = shared_attn[w] + (lora[a] @ lora[b]).to(dtype_of(shared_attn[w]))
    return ap


def _shared_attn_train(cfg, shared, lora, x, positions):
    """Shared block with LoRA deltas folded into the projections (cast to the
    weight dtype)."""
    h = norm_in(x, shared["ln1"])
    ap = _lora_attn(shared["attn"], lora, lambda w: w.dtype)
    a, kv = attn.attention_train(cfg, ap, h, positions)
    x = x + a
    h = norm_in(x, shared["ln2"])
    x = x + mlp_apply(shared["mlp"], h, "swiglu")
    return x, kv


def hybrid_forward(cfg, params, batch):
    cdt = torch_dtype(cfg.compute_dtype)
    x = _embed_inputs(cfg, params, {"tokens": batch["tokens"]}, cdt)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    groups, p, tail = _layout(cfg)

    shared = _use(params["shared"])

    def mamba_body(x, blk):
        x = annotate(x, "batch", "seq_act", None)
        return m2.mamba2_block(cfg, blk, x, m2.zero_state(cfg, b, x.device))[0]

    def group_body(x, inp):
        grp, lora = inp
        for blk in _layers(grp):
            x = _run_layer(cfg, mamba_body, x, blk)
        return _shared_attn_train(cfg, shared, lora, x, positions)[0]

    for inp in zip(_layers(params["groups"]), _layers(params["lora"])):
        x = _run_layer(cfg, group_body, x, inp)
    if tail:
        for blk in _layers(params["tail"]):
            x = _run_layer(cfg, mamba_body, x, blk)
    return _unembed(cfg, params, x, cdt)


def hybrid_loss(cfg, params, batch):
    return nll(hybrid_forward(cfg, params, batch), batch["labels"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def hybrid_cache_specs(cfg, batch: int, max_len: int, tp_degree: int = 16):
    groups, p, tail = _layout(cfg)
    m_state = m2.mamba2_state_specs(cfg, batch)
    rep = kv_repeat_for(cfg, tp_degree)
    kv = attn.init_kv_cache_specs(cfg, batch, max_len, rep, tp_degree=tp_degree)
    specs = {
        "mamba": stack_specs(stack_specs(m_state, p), groups),
        "kv": stack_specs(kv, groups),
    }
    if tail:
        specs["mamba_tail"] = stack_specs(m_state, tail)
    return specs


def _stack_states(states: list[dict]) -> dict:
    return {key: torch.stack([st[key] for st in states]) for key in states[0]}


def hybrid_prefill(cfg, params, batch, max_len: int, tp_degree: int = 16):
    """Prompt → (last-token logits (B, 1, V) float32, cache): the Mamba2
    states of every block (float32) and the bfloat16 KV cache of each
    shared-attention invocation, zero past the prompt."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = _embed_inputs(cfg, params, {"tokens": batch["tokens"]}, cdt)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    groups, p, tail = _layout(cfg)
    rep = kv_repeat_for(cfg, tp_degree)
    shape = (groups, b, max_len, cfg.num_kv_heads * rep, cfg.head_dim)
    axes = ("layers", "batch", "seq_cache", _cache_head_axis(cfg, rep, tp_degree), None)
    kv = {"k": sharded_zeros(shape, torch.bfloat16, axes, x),
          "v": sharded_zeros(shape, torch.bfloat16, axes, x)}
    shared = _use(params["shared"])

    def mamba_run(x, blocks):
        states = []
        for blk in _layers(blocks):
            x = annotate(x, "batch", "seq_act", None)
            x, st = m2.mamba2_block(cfg, _use(blk), x, m2.zero_state(cfg, b, x.device))
            states.append(st)
        return x, _stack_states(states)

    group_states = []
    for g, (grp, lora) in enumerate(zip(_layers(params["groups"]), _layers(params["lora"]))):
        x, states = mamba_run(x, grp)
        group_states.append(states)
        x, (k, v) = _shared_attn_train(cfg, shared, _use(lora), x, positions)
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        kv["k"][g, :, :s] = k
        kv["v"][g, :, :s] = v
    cache = {"mamba": _stack_states(group_states), "kv": kv}
    if tail:
        x, cache["mamba_tail"] = mamba_run(x, params["tail"])
    return _unembed(cfg, params, x[:, -1:], cdt), cache


def hybrid_decode(cfg, params, batch, cache, tp_degree: int = 16):
    """One decode step: batch = {tokens (B, 1), cache_len (a host int)} →
    (logits (B, 1, V) float32, cache), the cache updated in place."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = _embed_inputs(cfg, params, {"tokens": batch["tokens"]}, cdt)
    cache_len = int(batch["cache_len"])
    rep = kv_repeat_for(cfg, tp_degree)
    shared = _use(params["shared"])

    def mamba_run(x, blocks, states):
        for blk, st in zip(_layers(blocks), _layers(states)):
            x, new = m2.mamba2_decode_step(cfg, _use(blk), x, st)
            for key, t in st.items():
                t.copy_(new[key])
        return x

    for grp, lora, mstates, k_l, v_l in zip(
            _layers(params["groups"]), _layers(params["lora"]), _layers(cache["mamba"]),
            torch.unbind(cache["kv"]["k"], 0), torch.unbind(cache["kv"]["v"], 0)):
        x = mamba_run(x, grp, mstates)
        h = norm_in(x, shared["ln1"])
        ap = _lora_attn(shared["attn"], _use(lora), lambda w: cdt)
        a, _, _ = attn.attention_decode(cfg, ap, h, k_l, v_l, cache_len, rep)
        x = x + a
        h = norm_in(x, shared["ln2"])
        x = x + mlp_apply(shared["mlp"], h, "swiglu")
    if "tail" in params:
        x = mamba_run(x, params["tail"], cache["mamba_tail"])
    return _unembed(cfg, params, x, cdt), cache
