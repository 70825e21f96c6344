"""RWKV6 ("Finch") — attention-free time mix with *data-dependent decay*
(the torch port of ``repro.models.rwkv6``).

Training and prefill use the chunk-parallel linear-attention form
(intra-chunk products plus an inter-chunk loop over the float32 matrix
state); decode is the O(1) recurrence  S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ,
o_t = r_t·(S_{t-1} + diag(u)·k_t v_tᵀ).

As in the reference: token-shift mixing coefficients are learned per
channel (RWKV5 style), the decay keeps the RWKV6 data-dependent low-rank
form w_t = exp(−exp(w0 + tanh(x A) B)), and the head norm is RMS.

The chunked intra term splits the decay as q·exp(Λ_excl) and k·exp(−Λ_incl)
in float32, and masks the scores by multiplying with 0 — the reference's
formulation, kept so that the two packages compute the same numbers.  It
overflows once a chunk's cumulated decay passes about −88 (exp(−Λ) is inf
and inf·0 is NaN), so the chunk must stay short for strong decays
(ROADMAP C4): at rwkv6-1.6b's published widths and depth, freshly drawn, a
chunk of 16 sits at the limit and the published 256 is far past it; a
chunk of 8 holds, until training grows the decays.  The decode step runs
the exact recurrence and is not affected.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import P, cumsum, einsum, merge_heads, pad_dim1, rms_norm, unflatten

__all__ = ["rwkv6_block_specs", "rwkv6_block", "rwkv6_decode_step", "rwkv6_state_specs"]

DECAY_LORA = 64


def rwkv6_block_specs(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln1": P((d,), (None,), "ones"),
        "ln2": P((d,), (None,), "ones"),
        "time": {
            "mu": P((5, d), (None, "embed"), "zeros"),       # r,k,v,w,g shift mixes
            "wr": P((d, d), ("embed", "heads")),
            "wk": P((d, d), ("embed", "heads")),
            "wv": P((d, d), ("embed", "heads")),
            "wg": P((d, d), ("embed", "heads")),
            "wo": P((d, d), ("heads", "embed")),
            "w0": P((d,), (None,), "zeros"),                 # base decay
            "wa": P((d, DECAY_LORA), ("embed", None)),       # decay lora in
            "wb": P((DECAY_LORA, d), (None, "embed")),       # decay lora out
            "u": P((d,), (None,), "zeros"),                  # per-channel bonus
            "head_ln": P((d,), (None,), "ones"),
        },
        "channel": {
            "mu": P((2, d), (None, "embed"), "zeros"),
            "wk": P((d, ff), ("embed", "mlp")),
            "wv": P((ff, d), ("mlp", "embed")),
            "wr": P((d, d), ("embed", "heads")),
        },
    }


def rwkv6_state_specs(cfg, batch: int, dtype=torch.float32) -> dict:
    h = cfg.d_model // cfg.ssm_head_dim
    hd = cfg.ssm_head_dim
    return {
        "wkv": P((batch, h, hd, hd), ("batch", None, None, None), "zeros", dtype=dtype),
        "shift": P((batch, cfg.d_model), ("batch", "embed"), "zeros", dtype=dtype),
        "shift_c": P((batch, cfg.d_model), ("batch", "embed"), "zeros", dtype=dtype),
    }


def zero_state(cfg, b: int, dtype, device) -> dict:
    """The state a forward or prefill starts each layer from: a float32
    matrix state and token shifts in the compute dtype."""
    h = cfg.d_model // cfg.ssm_head_dim
    hd = cfg.ssm_head_dim
    return {
        "wkv": torch.zeros((b, h, hd, hd), dtype=torch.float32, device=device),
        "shift": torch.zeros((b, cfg.d_model), dtype=dtype, device=device),
        "shift_c": torch.zeros((b, cfg.d_model), dtype=dtype, device=device),
    }


def _decay(params, xw):
    inner = torch.tanh(xw @ params["wa"].to(xw.dtype))
    lora = inner @ params["wb"].to(xw.dtype)
    return -torch.exp(params["w0"].float() + lora.float())              # ≤ 0


def _shift(x, prev):
    """Token shift: x_{t-1} with ``prev`` filling t=0; returns shifted, last."""
    shifted = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    return shifted, x[:, -1, :]


def _wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """r/k/v/logw: (B, S, H, D); u: (H, D); state: (B, H, D, D) float32.
    Returns (out (B, S, H, D) float32, new_state)."""
    b, s, h, dd = r.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        r, k, v = (pad_dim1(a, pad) for a in (r, k, v))
        logw = pad_dim1(logw, pad)                                        # pad decay 0 → w=1
    idx = torch.arange(chunk, device=r.device)
    mask = (idx[:, None] > idx[None, :]).float()
    u = u[None, None].float()
    s_in = state.float()
    outs = []
    for i in range(n):
        rc, kc, vc, lw = (a[:, i * chunk:(i + 1) * chunk].float() for a in (r, k, v, logw))
        lam_incl = cumsum(lw, dim=1)                               # (B,C,H,D)
        lam_excl = lam_incl - lw
        lam_last = lam_incl[:, -1:]                                      # (B,1,H,D)

        q_d = rc * torch.exp(lam_excl)
        k_in = kc * torch.exp(-lam_incl)
        k_out = kc * torch.exp(lam_last - lam_incl)

        inter = einsum("bchd,bhde->bche", q_d, s_in)
        scores = einsum("bchd,bshd->bhcs", q_d, k_in)
        scores = scores * mask
        intra = einsum("bhcs,bshe->bche", scores, vc)
        # the bonus sums r·u·k over d and scales v by it
        bonus = torch.sum(rc * u * kc, dim=-1, keepdim=True) * vc
        outs.append(inter + intra + bonus)
        s_in = torch.exp(lam_last[:, 0])[..., None] * s_in + einsum(
            "bshd,bshe->bhde", k_out, vc)
    out = torch.cat(outs, dim=1)[:, :s]
    return out, s_in


def rwkv6_time_mix(cfg, tp, x, shift_prev, state, chunk):
    b, s, d = x.shape
    h = d // cfg.ssm_head_dim
    hd = cfg.ssm_head_dim
    xs, last = _shift(x, shift_prev)
    mu = tp["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i][None, None, :] for i in range(5))
    r = unflatten(xr @ tp["wr"].to(x.dtype), -1, (h, hd))
    k = unflatten(xk @ tp["wk"].to(x.dtype), -1, (h, hd))
    v = unflatten(xv @ tp["wv"].to(x.dtype), -1, (h, hd))
    g = F.silu(xg @ tp["wg"].to(x.dtype))
    logw = unflatten(_decay(tp, xw), -1, (h, hd))
    u = tp["u"].float().reshape(h, hd)
    out, state = _wkv_chunked(r, k, v, logw, u, state, chunk)
    out = rms_norm(merge_heads(out, 2).to(x.dtype), tp["head_ln"])
    out = out * g
    return out @ tp["wo"].to(x.dtype), last, state


def rwkv6_channel_mix(cfg, cp, x, shift_prev):
    xs, last = _shift(x, shift_prev)
    mu = cp["mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0][None, None, :]
    xr = x + (xs - x) * mu[1][None, None, :]
    k = torch.square(torch.relu(xk @ cp["wk"].to(x.dtype)))
    r = torch.sigmoid(xr @ cp["wr"].to(x.dtype))
    return r * (k @ cp["wv"].to(x.dtype)), last


def rwkv6_block(cfg, params, x, state, chunk=None):
    """One RWKV6 layer. state: dict(wkv, shift, shift_c). Returns (x, state)."""
    chunk = chunk or cfg.ssm_chunk
    h1 = rms_norm(x, params["ln1"])
    tm, shift_last, wkv = rwkv6_time_mix(
        cfg, params["time"], h1, state["shift"].to(x.dtype), state["wkv"], chunk)
    x = x + tm
    h2 = rms_norm(x, params["ln2"])
    cm, shift_c_last = rwkv6_channel_mix(cfg, params["channel"], h2,
                                         state["shift_c"].to(x.dtype))
    x = x + cm
    new_state = {
        "wkv": wkv,
        "shift": shift_last.to(state["shift"].dtype),
        "shift_c": shift_c_last.to(state["shift_c"].dtype),
    }
    return x, new_state


def rwkv6_decode_step(cfg, params, x, state):
    """x: (B, 1, d) — exact single-token recurrence (no chunking)."""
    b, _, d = x.shape
    h = d // cfg.ssm_head_dim
    hd = cfg.ssm_head_dim
    tp = params["time"]
    h1 = rms_norm(x, params["ln1"])[:, 0]                                # (B, d)
    prev = state["shift"].to(x.dtype)
    mu = tp["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (h1 + (prev - h1) * mu[i][None, :] for i in range(5))
    r = unflatten(xr @ tp["wr"].to(x.dtype), -1, (h, hd)).float()
    k = unflatten(xk @ tp["wk"].to(x.dtype), -1, (h, hd)).float()
    v = unflatten(xv @ tp["wv"].to(x.dtype), -1, (h, hd)).float()
    g = F.silu(xg @ tp["wg"].to(x.dtype))
    lora = torch.tanh(xw @ tp["wa"].to(x.dtype)) @ tp["wb"].to(x.dtype)
    logw = -torch.exp(tp["w0"].float() + lora.float())
    w = unflatten(torch.exp(logw), -1, (h, hd))
    u = tp["u"].float().reshape(h, hd)
    s_prev = state["wkv"]
    kv = k[..., :, None] * v[..., None, :]                               # (B,H,D,D)
    o = einsum("bhd,bhde->bhe", r, s_prev + u[None, :, :, None] * kv)
    s_new = w[..., None] * s_prev + kv
    o = rms_norm(merge_heads(o, 1)[:, None].to(x.dtype), tp["head_ln"]) * g[:, None, :]
    x = x + o @ tp["wo"].to(x.dtype)

    h2 = rms_norm(x, params["ln2"])[:, 0]
    cp = params["channel"]
    prev_c = state["shift_c"].to(x.dtype)
    mu_c = cp["mu"].to(x.dtype)
    xk2 = h2 + (prev_c - h2) * mu_c[0][None, :]
    xr2 = h2 + (prev_c - h2) * mu_c[1][None, :]
    kk = torch.square(torch.relu(xk2 @ cp["wk"].to(x.dtype)))
    rr = torch.sigmoid(xr2 @ cp["wr"].to(x.dtype))
    x = x + (rr * (kk @ cp["wv"].to(x.dtype)))[:, None, :]
    new_state = {
        "wkv": s_new,
        "shift": h1.to(state["shift"].dtype),
        "shift_c": h2.to(state["shift_c"].dtype),
    }
    return x, new_state
