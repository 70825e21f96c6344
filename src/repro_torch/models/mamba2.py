"""Mamba2 (SSD — state-space duality) block, chunked (the torch port of
``repro.models.mamba2``).

Per-head scalar decay a_t = exp(Δt·A) makes the chunked form simpler than
RWKV6: the intra-chunk kernel exp(Λ_t − Λ_s) is materialized directly.
As in the reference, it is formed for every (t, s) of the chunk and then
masked to s ≤ t by multiplying with 0; for s > t the exponent is the decay
summed over (t, s], which overflows float32 once it passes about 88, and
inf·0 makes those rows NaN (ROADMAP C5): at zamba2-7b's published widths,
freshly drawn, a chunk of 16 sits at the limit, 32 or more (the published
256) overflow every layer, and a chunk of 8 holds.

Recurrence (head h, state S ∈ R^{P×N}):
    S_t = a_t S_{t−1} + (Δt_t x_t) ⊗ B_t ,   y_t = S_t · C_t + D x_t
Decode is the block at chunk 1 and carries (conv_state, ssm_state) exactly;
the conv state is the last K−1 rows of [state, x], so a one-token step
keeps the older rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (P, cumsum, einsum, merge_heads, norm_in, pad_dim1, rms_norm, row_parallel,
                     unflatten)

__all__ = ["mamba2_block_specs", "mamba2_block", "mamba2_decode_step", "mamba2_state_specs"]


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_block_specs(cfg) -> dict:
    d = cfg.d_model
    d_in, h, p, n = _dims(cfg)
    conv_ch = d_in + 2 * n
    return {
        "ln": P((d,), (None,), "ones"),
        "in_proj": P((d, 2 * d_in + 2 * n + h), ("embed", "mlp")),
        "conv_w": P((cfg.ssm_conv, conv_ch), (None, "mlp"), scale=1.0),
        "conv_b": P((conv_ch,), ("mlp",), "zeros"),
        "a_log": P((h,), (None,), "ones"),
        "dt_bias": P((h,), (None,), "zeros"),
        "d_skip": P((h,), (None,), "ones"),
        "out_norm": P((d_in,), ("mlp",), "ones"),
        "out_proj": P((d_in, d), ("mlp", "embed")),
    }


def mamba2_state_specs(cfg, batch: int, dtype=torch.float32) -> dict:
    d_in, h, p, n = _dims(cfg)
    conv_ch = d_in + 2 * n
    return {
        "conv": P((batch, cfg.ssm_conv - 1, conv_ch), ("batch", None, "mlp"),
                  "zeros", dtype=dtype),
        "ssm": P((batch, h, p, n), ("batch", None, None, None), "zeros", dtype=dtype),
    }


def zero_state(cfg, b: int, device) -> dict:
    """The float32 state a forward or prefill starts each block from."""
    d_in, h, p, n = _dims(cfg)
    return {
        "conv": torch.zeros((b, cfg.ssm_conv - 1, d_in + 2 * n), dtype=torch.float32,
                            device=device),
        "ssm": torch.zeros((b, h, p, n), dtype=torch.float32, device=device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv; x (B,S,C), w (K,C).  state (B,K-1,C) holds the
    previous tail for decode/prefill continuity."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :].to(x.dtype) for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):, :]
    return F.silu(out + b.to(x.dtype)), new_state


def _softplus(x):
    """``jax.nn.softplus``: log(1 + eˣ) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_chunked(x, dt, a_log, b_in, c_in, state, chunk: int):
    """x (B,S,H,P); dt (B,S,H) (post-softplus); b_in/c_in (B,S,N);
    state (B,H,P,N) float32.  Returns (y float32, new_state)."""
    bsz, s, h, p = x.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x, dt, b_in, c_in = (pad_dim1(a, pad) for a in (x, dt, b_in, c_in))

    a = -torch.exp(a_log.float())                                       # (H,) negative
    la = dt.float() * a[None, None, :]                                  # log decay (B,S,H)
    x, dt, b_in, c_in = x.float(), dt.float(), b_in.float(), c_in.float()
    idx = torch.arange(chunk, device=x.device)
    mask = (idx[:, None] >= idx[None, :]).float()
    s_in = state.float()
    ys = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        xk, dtk, lak, bk, ck = x[:, sl], dt[:, sl], la[:, sl], b_in[:, sl], c_in[:, sl]
        lam = cumsum(lak, dim=1)                                  # (B,C,H) inclusive
        lam_last = lam[:, -1]                                           # (B,H)
        # inter-chunk: y_t += exp(Λ_t) C_t · S_in
        inter = einsum("bch,bcn,bhpn->bchp", torch.exp(lam), ck, s_in)
        # intra-chunk: kernel L_{t,s} = exp(Λ_t − Λ_s) for s ≤ t
        diff = lam[:, :, None, :] - lam[:, None, :, :]                  # (B,C,C,H)
        kern = torch.exp(diff) * mask[None, :, :, None]
        cb = einsum("bcn,bsn->bcs", ck, bk)                       # (B,C,C)
        w_s = dtk[:, :, :, None] * xk                                   # Δt·x (B,C,H,P)
        intra = einsum("bcsh,bshp->bchp", cb[..., None] * kern, w_s)
        ys.append(inter + intra)
        # state update: S_out = exp(Λ_last) S_in + Σ_s exp(Λ_last − Λ_s) w_s ⊗ B_s
        decay_out = torch.exp(lam_last[:, None, :] - lam)               # (B,C,H)
        s_in = torch.exp(lam_last)[..., None, None] * s_in + einsum(
            "bch,bchp,bcn->bhpn", decay_out, w_s, bk)
    y = torch.cat(ys, dim=1)[:, :s]
    return y, s_in


def mamba2_block(cfg, params, x, state, chunk=None):
    """x (B,S,d); state {conv, ssm}.  Returns (x, new_state)."""
    chunk = chunk or cfg.ssm_chunk
    d_in, h, p, n = _dims(cfg)
    bsz, s, _ = x.shape
    res = x
    xh = norm_in(x, params["ln"])
    proj = xh @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"], state["conv"])
    xs, b_in, c_in = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())
    xs = unflatten(xs, -1, (h, p))
    y, ssm_state = _ssd_chunked(xs, dt, params["a_log"], b_in, c_in, state["ssm"], chunk)
    y = y + params["d_skip"].float()[None, None, :, None] * xs.float()
    y = merge_heads(y, 2).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"])
    out = row_parallel(y, params["out_proj"])
    return res + out, {"conv": conv_state.to(state["conv"].dtype), "ssm": ssm_state}


def mamba2_decode_step(cfg, params, x, state):
    """Single-token exact recurrence; x (B,1,d)."""
    return mamba2_block(cfg, params, x, state, chunk=1)
