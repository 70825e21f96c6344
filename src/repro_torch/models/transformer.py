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
``lm_loss`` as ``+ 0.01·aux``.

On DTensors (the 2-D layout, :mod:`repro_torch.sharding`) the same code runs
global-view under the sharded steps' ``implicit_replication()``: the tensors
made inside the model (positions, masks, zero states, ``aux``) join the
program replicated.  Sites with a rule of their own: the embedding lookup
(:func:`_lookup`), the vocab-parallel loss (:func:`nll`), the products and
scans of ``layers`` (``dot_f32``, ``einsum``, ``cumsum``, ``unflatten``,
``merge_heads``, ``pad_dim1``); the prefill caches are allocated shard by
shard (``sharded_zeros``).  On plain
tensors nothing of this runs, and the numbers are those of one device.  An RWKV6 forward or prefill starts every
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

from ..sharding.partitioning import (annotate, gather_for_use, is_dtensor, replicated,
                                     sharded_zeros)
from . import attention as attn
from . import moe as moe_mod
from . import rwkv6 as rwkv
from .layers import (P, dot_f32, flatten_with_paths, mlp_apply, mlp_specs, norm_in, stack_specs,
                     tree_map)

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


def _lookup(tokens, table):
    """``F.embedding``.  On a DTensor table the table is gathered whole at
    its use (its FSDP and vocabulary shards) and each rank looks up its
    own ids: DTensor's vocab-parallel lookup leaves a masked partial whose
    one mask buffer a second use overwrites, and whose gradient some
    torch releases cannot reduce."""
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    return F.embedding(tokens, replicated(table))


def _embed_inputs(cfg, params, batch, compute_dtype):
    x = _lookup(batch["tokens"], params["embed"]).to(compute_dtype)
    if cfg.frontend == "patch_embed" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(compute_dtype)
        ve = ve @ gather_for_use(params["patch_proj"]).to(compute_dtype)
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


def _use(tree):
    """A layer's weights as they are used: on DTensors each leaf's FSDP
    shards gathered (``gather_for_use``), which :func:`_run_layer` does
    inside the checkpointed layer, so that remat gathers again in the
    backward instead of keeping every layer's gathered weights; a tree of
    plain tensors as it is."""
    first = next((leaf for _, leaf in flatten_with_paths(tree)), None)
    return tree_map(gather_for_use, tree) if is_dtensor(first) else tree


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _ffn(cfg, blk, h):
    """The block's MLP, or its MoE layer: (out, aux loss or None)."""
    if cfg.num_experts:
        return moe_mod.moe_apply(cfg, blk["moe"], h)
    return mlp_apply(blk["mlp"], h, cfg.mlp), None


def _dense_block(cfg, blk, x, positions):
    x = annotate(x, "batch", "seq_act", None)
    h = norm_in(x, blk["ln1"])
    a, _ = attn.attention_train(cfg, blk["attn"], h, positions)
    x = x + a
    x = annotate(x, "batch", "seq_act", None)
    h = norm_in(x, blk["ln2"])
    m, aux = _ffn(cfg, blk, h)
    return x + _to_residual(m), aux


def _to_residual(y):
    """A feed-forward sublayer's output placed as the residual stream is
    (``seq_act``) before it is added: ``layers.row_parallel``'s placement,
    for MoE's output, which does not come from it (left to the add, a
    sequence-sharded gradient would reach the experts' backward).  A
    no-op off DTensor and where the output is placed already."""
    return annotate(y, "batch", "seq_act", None)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Save the outputs of 2-D matmuls (a layer's weight products, which
    carry no batch dimension) and recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _run_layer(cfg, fn, x, blk):
    """One layer, under ``cfg.remat``'s activation checkpointing when the
    graph is being recorded; its weights gathered for use (:func:`_use`)."""
    def body(x, blk):
        return fn(x, _use(blk))

    if not (cfg.remat and torch.is_grad_enabled()):
        return body(x, blk)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(body, x, blk, use_reentrant=False, **kw)


def _unembed(cfg, params, x, cdt):
    x = norm_in(x, params["final_ln"])
    logits = dot_f32(x, gather_for_use(params["unembed"]).to(cdt))
    # vocab-parallel logits (DTensor may leave the product Partial over
    # 'model'): the layout the loss and the served logits are read in
    logits = annotate(logits, "batch", "seq_act", "vocab")
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
    if is_dtensor(logits) and _vocab_sharded(logits):
        return _nll_vocab_parallel(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return replicated(torch.mean(lse - true))


def _vocab_sharded(logits) -> bool:
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) and p.dim == logits.dim() - 1 and logits.device_mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def _nll_vocab_parallel(logits, labels):
    """``nll`` of vocab-sharded DTensor logits (with the vocabulary whole
    on every rank, a (1, 1) mesh, ``nll``'s own ops run, so the numbers
    are one device's), Megatron's vocab-parallel
    cross entropy in global view: the max and the sum of exponentials
    reduce over the vocabulary shards, and the true logit is picked shard
    by shard (:func:`_pick_vocab_parallel`), so the logits are never
    all-gathered.  Each partial result is reduced explicitly
    (:func:`_reduce_partial`) before a nonlinear op reads it: left to the
    reduction DTensor makes inside ``log``, torch 2.11 (the card's
    release) gave a wrong gradient (a few percent at random weights,
    1e7 in norm after one AdamW step) with a right loss.  The loss is
    replicated."""
    m = _reduce_partial(logits.detach().amax(dim=-1, keepdim=True))
    lse = torch.log(_reduce_partial(torch.exp(logits - m).sum(dim=-1))) + m[..., 0]
    true = _reduce_partial(_pick_vocab_parallel(logits, labels))
    return replicated(torch.mean(lse - true))


def _reduce_partial(t):
    """A DTensor's ``Partial`` placements reduced (to ``Replicate``), its
    shards kept, by a ``redistribute`` that autograd records; anything
    else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    return t if want == tuple(t.placements) else t.redistribute(t.device_mesh, want)


def _pick_vocab_parallel(logits, labels):
    """``logits[..., labels]`` of vocab-sharded DTensor logits, each rank on
    its own shards: it gathers the labels that fall in its slice of the
    vocabulary and gives 0 for the others, and the sum over the vocabulary
    shards (a ``Partial``) is the pick — no (batch, seq, vocab) one-hot.
    The labels are placed as the logits' other dims are (a local slice)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, vdim = logits.device_mesh, logits.dim() - 1
    vocab = [isinstance(p, Shard) and p.dim == vdim for p in logits.placements]
    rest = tuple(Replicate() if v else p for v, p in zip(vocab, logits.placements))
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    labels = labels.redistribute(mesh, rest)
    local = logits.to_local()
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh, logits.placements)
    n = local.shape[-1]
    idx = labels.to_local().long() - offset[vdim]
    inside = (idx >= 0) & (idx < n)
    picked = torch.gather(local, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    picked = torch.where(inside, picked, torch.zeros_like(picked))
    shape = tuple(logits.shape[:-1])
    return DTensor.from_local(picked, mesh, tuple(Partial() if v else p for v, p in
                                                  zip(vocab, logits.placements)),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def lm_loss(cfg, params, batch):
    logits, aux = decoder_forward(cfg, params, batch)
    if cfg.frontend == "patch_embed" and "vision_embeds" in batch:
        # loss only over text positions (vision prefix predicts nothing)
        logits = logits[:, batch["vision_embeds"].shape[1]:]
    loss = nll(logits, batch["labels"])
    if cfg.num_experts:
        loss = replicated(loss + 0.01 * aux)
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


def _cache_head_axis(cfg, rep: int, tp_degree: int):
    """The logical axis of a KV cache's head dim (``init_kv_cache_specs``'s rule)."""
    return "kv_cache" if (cfg.num_kv_heads * rep) % tp_degree == 0 else None


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
            x, st = rwkv.rwkv6_block(cfg, _use(blk), x, rwkv.zero_state(cfg, b, cdt, x.device))
            states.append(st)
        cache = {key: torch.stack([st[key] for st in states]) for key in states[0]}
        return _unembed(cfg, params, x[:, -1:], cdt), cache
    positions = _positions(b, s, x.device)
    rep = kv_repeat_for(cfg, tp_degree)
    shape = (cfg.num_layers, b, max_len, cfg.num_kv_heads * rep, cfg.head_dim)
    axes = ("layers", "batch", "seq_cache", _cache_head_axis(cfg, rep, tp_degree), None)
    cache = {"k": sharded_zeros(shape, torch.bfloat16, axes, x),
             "v": sharded_zeros(shape, torch.bfloat16, axes, x)}
    for i, blk in enumerate(_layers(params["blocks"])):
        blk = _use(blk)
        x = annotate(x, "batch", "seq_act", None)
        h = norm_in(x, blk["ln1"])
        a, (k, v) = attn.attention_train(cfg, blk["attn"], h, positions)
        x = x + a
        h = norm_in(x, blk["ln2"])
        x = x + _to_residual(_ffn(cfg, blk, h)[0])
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        k = annotate(k, "batch", "seq_cache", axes[3], None)
        v = annotate(v, "batch", "seq_cache", axes[3], None)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    return _unembed(cfg, params, x[:, -1:], cdt), cache


def decoder_decode(cfg, params, batch, cache, tp_degree: int = 16):
    """One decode step: batch = {tokens (B, 1), cache_len (a host int)} →
    (logits (B, 1, V) float32, cache), the cache updated in place."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = _lookup(batch["tokens"], params["embed"]).to(cdt)
    if cfg.family == "ssm":
        for blk, st in zip(_layers(params["blocks"]), _layers(cache)):
            x, new = rwkv.rwkv6_decode_step(cfg, _use(blk), x, st)
            for key, t in st.items():
                t.copy_(new[key])
        return _unembed(cfg, params, x, cdt), cache
    cache_len = int(batch["cache_len"])
    rep = kv_repeat_for(cfg, tp_degree)
    for blk, k_l, v_l in zip(_layers(params["blocks"]), torch.unbind(cache["k"], 0),
                             torch.unbind(cache["v"], 0)):
        blk = _use(blk)
        h = norm_in(x, blk["ln1"])
        a, _, _ = attn.attention_decode(cfg, blk["attn"], h, k_l, v_l, cache_len, rep)
        x = x + a
        h = norm_in(x, blk["ln2"])
        x = x + _to_residual(_ffn(cfg, blk, h)[0])
    return _unembed(cfg, params, x, cdt), cache
