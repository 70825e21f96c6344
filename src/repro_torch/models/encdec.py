"""Whisper-style encoder–decoder, the audio family (the torch port of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the batch supplies
precomputed encoder frame embeddings ``audio_embeds`` (B, T_enc, d).  The
encoder is bidirectional self-attention with fixed sinusoidal positions
(and no activation checkpointing); the decoder is causal self-attention
with RoPE plus cross-attention to the encoder output (checkpointed per
layer under ``cfg.remat``).  Decode caches the self-attention KV and the
cross KV computed once at prefill.

The cross cache's *specs* are sized at ``ENC_FRAMES`` = 1,500 frames, but
prefill stores the frames it was given and decode attends over the whole
cross cache with no mask — so a cache preallocated at 1,500 frames and
filled with fewer would attend to zeros.  The port, like the reference,
returns the cross cache at the encoder's own length.
"""

from __future__ import annotations

import numpy as np
import torch

from . import attention as attn
from .layers import (P, merge_heads, mlp_apply, mlp_specs, norm_in, row_parallel, stack_specs,
                     unflatten)
from ..sharding.partitioning import sharded_zeros
from .transformer import (_cache_head_axis, _embed_inputs, _layers, _positions, _run_layer,
                          _unembed, _use, kv_repeat_for, nll, torch_dtype)

__all__ = [
    "encdec_specs",
    "encode",
    "encdec_loss",
    "encdec_prefill",
    "encdec_decode",
    "encdec_cache_specs",
    "ENC_FRAMES",
]

ENC_FRAMES = 1500  # whisper 30 s @ 50 Hz


def _cross_specs(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": P((d, h * hd), ("embed", "heads")),
        "wk": P((d, kv * hd), ("embed", "kv")),
        "wv": P((d, kv * hd), ("embed", "kv")),
        "wo": P((h * hd, d), ("heads", "embed")),
    }


def encdec_specs(cfg) -> dict:
    d = cfg.d_model
    enc_block = {
        "ln1": P((d,), (None,), "ones"),
        "attn": attn.attention_specs(cfg),
        "ln2": P((d,), (None,), "ones"),
        "mlp": mlp_specs(d, cfg.d_ff, "gelu"),
    }
    dec_block = {
        "ln1": P((d,), (None,), "ones"),
        "attn": attn.attention_specs(cfg),
        "lnx": P((d,), (None,), "ones"),
        "cross": _cross_specs(cfg),
        "ln2": P((d,), (None,), "ones"),
        "mlp": mlp_specs(d, cfg.d_ff, "gelu"),
    }
    return {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed"), scale=1.0),
        "enc_blocks": stack_specs(enc_block, cfg.encoder_layers),
        "enc_ln": P((d,), (None,), "ones"),
        "dec_blocks": stack_specs(dec_block, cfg.num_layers),
        "final_ln": P((d,), (None,), "ones"),
        "unembed": P((d, cfg.padded_vocab), ("embed", "vocab")),
    }


def _sinusoidal(s, d, dtype, device):
    """The fixed (s, d) position table, computed on the host in float64."""
    pos = np.arange(s)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(table, device=device).to(dtype)


def encode(cfg, params, frames):
    """frames: (B, T_enc, d) precomputed embeddings (frontend stub)."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = frames.to(cdt) + _sinusoidal(frames.shape[1], cfg.d_model, cdt, frames.device)[None]
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for blk in _layers(params["enc_blocks"]):
        blk = _use(blk)
        h = norm_in(x, blk["ln1"])
        q, k, v = attn._project_qkv(cfg, blk["attn"], h, positions)
        o = attn.flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        o = merge_heads(o, 2)
        x = x + row_parallel(o, blk["attn"]["wo"])
        h = norm_in(x, blk["ln2"])
        x = x + mlp_apply(blk["mlp"], h, "gelu")
    return norm_in(x, params["enc_ln"])


def _cross_attend(cfg, cp, x, enc_k, enc_v):
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = unflatten(x @ cp["wq"].to(x.dtype), -1, (h, hd))
    o = attn.flash_attention(q, enc_k, enc_v, causal=False, chunk=cfg.attn_chunk)
    return row_parallel(merge_heads(o, 2), cp["wo"])


def _cross_kv(cfg, cp, enc_out):
    b, t, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    k = enc_out @ cp["wk"].to(enc_out.dtype)
    v = enc_out @ cp["wv"].to(enc_out.dtype)
    return unflatten(k, -1, (kv, hd)), unflatten(v, -1, (kv, hd))


def decode_stack_train(cfg, params, tokens, enc_out):
    cdt = torch_dtype(cfg.compute_dtype)
    x = _embed_inputs(cfg, params, {"tokens": tokens}, cdt)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)

    def body(x, blk):
        h = norm_in(x, blk["ln1"])
        a, _ = attn.attention_train(cfg, blk["attn"], h, positions)
        x = x + a
        h = norm_in(x, blk["lnx"])
        enc_k, enc_v = _cross_kv(cfg, blk["cross"], enc_out)
        x = x + _cross_attend(cfg, blk["cross"], h, enc_k, enc_v)
        h = norm_in(x, blk["ln2"])
        return x + mlp_apply(blk["mlp"], h, "gelu")

    for blk in _layers(params["dec_blocks"]):
        x = _run_layer(cfg, body, x, blk)
    return _unembed(cfg, params, x, cdt)


def encdec_loss(cfg, params, batch):
    enc_out = encode(cfg, params, batch["audio_embeds"])
    return nll(decode_stack_train(cfg, params, batch["tokens"], enc_out), batch["labels"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def encdec_cache_specs(cfg, batch: int, max_len: int, tp_degree: int = 16):
    rep = kv_repeat_for(cfg, tp_degree)
    self_kv = attn.init_kv_cache_specs(cfg, batch, max_len, rep, tp_degree=tp_degree)
    kvh = cfg.num_kv_heads * rep
    head_ax = "kv_cache" if kvh % tp_degree == 0 else None
    cross = {
        "k": P((batch, ENC_FRAMES, kvh, cfg.head_dim),
               ("batch", None, head_ax, None), "zeros", dtype=torch.bfloat16),
        "v": P((batch, ENC_FRAMES, kvh, cfg.head_dim),
               ("batch", None, head_ax, None), "zeros", dtype=torch.bfloat16),
    }
    return stack_specs({"self": self_kv, "cross": cross}, cfg.num_layers)


def encdec_prefill(cfg, params, batch, max_len: int, tp_degree: int = 16):
    """Encode the audio and run the decoder prompt → (last-token logits
    (B, 1, V) float32, cache {"self": {k, v} (L, B, max_len, KV·rep, D),
    "cross": {k, v} (L, B, T_enc, KV·rep, D)}, both bfloat16)."""
    cdt = torch_dtype(cfg.compute_dtype)
    enc_out = encode(cfg, params, batch["audio_embeds"])
    x = _embed_inputs(cfg, params, {"tokens": batch["tokens"]}, cdt)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    rep = kv_repeat_for(cfg, tp_degree)
    kvh = cfg.num_kv_heads * rep
    shape = (cfg.num_layers, b, max_len, kvh, cfg.head_dim)
    cross_shape = (cfg.num_layers, b, enc_out.shape[1], kvh, cfg.head_dim)
    axes = ("layers", "batch", "seq_cache", _cache_head_axis(cfg, rep, tp_degree), None)
    cross_axes = ("layers", "batch", None, axes[3], None)
    cache = {"self": {"k": sharded_zeros(shape, torch.bfloat16, axes, x),
                      "v": sharded_zeros(shape, torch.bfloat16, axes, x)},
             "cross": {"k": sharded_zeros(cross_shape, torch.bfloat16, cross_axes, x),
                       "v": sharded_zeros(cross_shape, torch.bfloat16, cross_axes, x)}}
    for i, blk in enumerate(_layers(params["dec_blocks"])):
        blk = _use(blk)
        h = norm_in(x, blk["ln1"])
        a, (k, v) = attn.attention_train(cfg, blk["attn"], h, positions)
        x = x + a
        h = norm_in(x, blk["lnx"])
        ck, cv = _cross_kv(cfg, blk["cross"], enc_out)
        x = x + _cross_attend(cfg, blk["cross"], h, ck, cv)
        h = norm_in(x, blk["ln2"])
        x = x + mlp_apply(blk["mlp"], h, "gelu")
        if rep > 1:
            k, v, ck, cv = (torch.repeat_interleave(t, rep, dim=2) for t in (k, v, ck, cv))
        cache["self"]["k"][i, :, :s] = k
        cache["self"]["v"][i, :, :s] = v
        cache["cross"]["k"][i] = ck
        cache["cross"]["v"][i] = cv
    return _unembed(cfg, params, x[:, -1:], cdt), cache


def encdec_decode(cfg, params, batch, cache, tp_degree: int = 16):
    """One decode step against the self cache (written in place) and the
    whole cross cache (read, unmasked)."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = _embed_inputs(cfg, params, {"tokens": batch["tokens"]}, cdt)
    cache_len = int(batch["cache_len"])
    b = x.shape[0]
    rep = kv_repeat_for(cfg, tp_degree)
    h_heads, hd = cfg.num_heads, cfg.head_dim
    for blk, k_l, v_l, ck, cv in zip(
            _layers(params["dec_blocks"]), torch.unbind(cache["self"]["k"], 0),
            torch.unbind(cache["self"]["v"], 0), torch.unbind(cache["cross"]["k"], 0),
            torch.unbind(cache["cross"]["v"], 0)):
        blk = _use(blk)
        h = norm_in(x, blk["ln1"])
        a, _, _ = attn.attention_decode(cfg, blk["attn"], h, k_l, v_l, cache_len, rep)
        x = x + a
        h = norm_in(x, blk["lnx"])
        # cross attention against the fixed encoder KV (already repeated)
        q = unflatten(h @ blk["cross"]["wq"].to(cdt), -1, (h_heads, hd))
        o = attn.flash_attention(q, ck.to(cdt), cv.to(cdt), causal=False,
                                 chunk=cfg.attn_chunk)
        o = merge_heads(o, 2)
        x = x + row_parallel(o, blk["cross"]["wo"])
        h = norm_in(x, blk["ln2"])
        x = x + mlp_apply(blk["mlp"], h, "gelu")
    return _unembed(cfg, params, x, cdt), cache
