"""Attention: GQA + RoPE + optional qk-norm (the torch port of
``repro.models.attention``), with two execution paths:

* :func:`flash_attention`  — blockwise online softmax over KV chunks (a
  Python loop where the reference scans): O(S·C) live memory instead of
  O(S²); used for train and prefill.
* :func:`attention_decode` — one new token against a preallocated KV cache
  with a length mask; logits in float32.  The new entry is written into
  the cache in place (the reference donates the cache to the same effect).
* KV-head replication: when the TP degree exceeds ``num_kv_heads`` the cache
  stores kv heads repeated toward the TP degree, so the layout matches the
  reference's serving cache.

Both paths are plain torch: the reference computes attention with ``jnp``
contractions, not a Pallas kernel, and a library attention would change
the numerics and the memory behaviour.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import P, dot_f32, merge_heads, pad_dim1, rms_norm, rope, row_parallel, unflatten

__all__ = ["attention_specs", "flash_attention", "attention_train", "attention_decode",
           "init_kv_cache_specs"]

NEG_INF = -1e30


def _scale(d: int) -> float:
    """1/√d rounded as the reference rounds it (float32)."""
    return float(np.float32(1.0) / np.float32(np.sqrt(d)))


def attention_specs(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": P((d, h * hd), ("embed", "heads")),
        "wk": P((d, kv * hd), ("embed", "kv")),
        "wv": P((d, kv * hd), ("embed", "kv")),
        "wo": P((h * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = P((hd,), (None,), init="ones")
        specs["k_norm"] = P((hd,), (None,), init="ones")
    return specs


def _project_qkv(cfg, params, x, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = unflatten(x @ params["wq"].to(x.dtype), -1, (h, hd))
    k = unflatten(x @ params["wk"].to(x.dtype), -1, (kv, hd))
    v = unflatten(x @ params["wv"].to(x.dtype), -1, (kv, hd))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(q, k, v, *, causal: bool, chunk: int, q_offset: int = 0):
    """Online-softmax attention.  q (B,Sq,H,D); k/v (B,Skv,KV,D) with
    H % KV == 0 (GQA).  Visits KV in chunks of ``chunk``; float32
    accumulators; logits and P·V contract to float32 whatever the operand
    dtype."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = _scale(d)
    # (B, KV, Sq·G, D): one batched product per chunk for every (b, kv) pair
    qg = unflatten(q, 2, (kvh, g)).permute(0, 2, 1, 3, 4).reshape(b, kvh, sq * g, d)

    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k, v = pad_dim1(k, pad), pad_dim1(v, pad)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    offs = torch.arange(chunk, device=q.device)

    acc = torch.zeros((b, kvh, sq * g, d), dtype=torch.float32, device=q.device)
    m_i = torch.full((b, kvh, sq * g), NEG_INF, dtype=torch.float32, device=q.device)
    l_i = torch.zeros((b, kvh, sq * g), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        k_c = k[:, idx * chunk:(idx + 1) * chunk].permute(0, 2, 3, 1)    # (B, KV, D, C)
        v_c = v[:, idx * chunk:(idx + 1) * chunk].permute(0, 2, 1, 3)    # (B, KV, C, D)
        logits = dot_f32(qg, k_c) * scale                                # (B, KV, Sq·G, C)
        kv_pos = idx * chunk + offs
        mask = (kv_pos[None, :] <= q_pos[:, None]) if causal else torch.ones(
            (sq, chunk), dtype=torch.bool, device=q.device)
        mask = mask & (kv_pos < skv)[None, :]
        mask = mask[:, None, :].expand(sq, g, chunk).reshape(sq * g, chunk)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m_i, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m_i - m_new)
        l_i = l_i * alpha + p.sum(dim=-1)
        pv = dot_f32(p.to(v_c.dtype), v_c)
        acc = acc * alpha[..., None] + pv
        m_i = m_new
    out = acc / torch.clamp(l_i, min=1e-30)[..., None]
    out = merge_heads(out.reshape(b, kvh, sq, g, d).permute(0, 2, 1, 3, 4), 2)
    return out.to(q.dtype)


def attention_train(cfg, params, x, positions):
    """Full training/prefill attention; returns (out, (k, v)) so prefill can
    populate the cache."""
    q, k, v = _project_qkv(cfg, params, x, positions)
    out = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    b, s, _, _ = out.shape
    out = merge_heads(out, 2)
    return row_parallel(out, params["wo"]), (k, v)


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------

def init_kv_cache_specs(cfg, batch: int, max_len: int, kv_repeat: int = 1,
                        dtype=torch.bfloat16, tp_degree: int = 16):
    """Cache layout (B, S_max, KV·repeat, D), logical axes
    (batch, seq_cache, kv_cache, None); the head axis is left replicated
    when the (repeated) head count does not divide the TP degree."""
    kvh = cfg.num_kv_heads * kv_repeat
    head_ax = "kv_cache" if kvh % tp_degree == 0 else None
    shape = (batch, max_len, kvh, cfg.head_dim)
    return {
        "k": P(shape, ("batch", "seq_cache", head_ax, None), "zeros", dtype=dtype),
        "v": P(shape, ("batch", "seq_cache", head_ax, None), "zeros", dtype=dtype),
    }


def attention_decode(cfg, params, x, cache_k, cache_v, cache_len: int, kv_repeat: int = 1):
    """x: (B, 1, d); cache: (B, S, KV·rep, D) already holding ``cache_len``
    valid positions (a host integer, so a step never reads the device).
    Writes the new entry at ``cache_len`` in place and returns
    (out, cache_k, cache_v)."""
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, params, x, positions)
    if kv_repeat > 1:
        k_new = torch.repeat_interleave(k_new, kv_repeat, dim=2)
        v_new = torch.repeat_interleave(v_new, kv_repeat, dim=2)
    cache_k[:, cache_len] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v_new[:, 0].to(cache_v.dtype)
    kvh_eff = kvh * kv_repeat
    g = h // kvh_eff
    s_max = cache_k.shape[1]
    qg = unflatten(q[:, 0], 1, (kvh_eff, g))                            # Sq = 1
    logits = dot_f32(qg, cache_k.to(q.dtype).permute(0, 2, 3, 1)) * _scale(hd)  # (B,KV,G,S)
    mask = torch.arange(s_max, device=x.device) <= cache_len
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = dot_f32(p.to(cache_v.dtype), cache_v.permute(0, 2, 1, 3))    # (B, KV, G, D)
    out = merge_heads(merge_heads(out, 1), 1)[:, None].to(x.dtype)
    return row_parallel(out, params["wo"]), cache_k, cache_v
