"""Torch port parity for the LM harness's dense and VLM models (A17a):
``repro_torch.models`` against ``repro.models`` on the CPU.

Parameters are drawn once with numpy (``numpy_params``, the reference's
law) and loaded by both packages (JAX through ``jnp.asarray``, the port
through ``lm_params_from_numpy``); inputs are numpy int32/float32 arrays, so
the comparisons hold whichever state JAX's x64 flag is in.  Tolerances,
each as the largest absolute difference over the largest magnitude of the
JAX result ("of scale"): rms_norm, rope and the MLPs 1e-6; flash attention
2e-5; ``decoder_forward`` logits, ``lm_loss`` and every gradient leaf 1e-4
(float32 compute); prefill/decode caches within one bfloat16 ulp of JAX's
and their logits 1e-3; prefill + decode against the full forward 2e-2 (the
reference test's bar); a bfloat16 train step's loss 2e-2."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.model_zoo import build_model as j_build  # noqa: E402

from repro_torch.configs import ARCHS, ShapeSpec, smoke_variant  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.layers import flatten_with_paths, numpy_params  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

DENSE = ("deepseek-67b", "internvl2-26b", "nemotron-4-340b", "qwen3-32b", "qwen3-4b")


def _err(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _cfgs(name, **kw):
    """The same smoke config in both packages (float32 compute unless
    overridden)."""
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(smoke_variant(J_ARCHS[name]), **kw),
            dataclasses.replace(smoke_variant(ARCHS[name]), **kw))


def _params(tcfg, seed=0):
    """One numpy draw, loaded by both packages."""
    host = numpy_params(build_model(tcfg).param_specs(), seed)
    return jax.tree.map(jnp.asarray, host), lm_params_from_numpy(host, "cpu")


def _batch(cfg, b=2, s=24, seed=1, labels=True):
    rng = np.random.default_rng(seed)
    n_img = cfg.num_frontend_tokens if cfg.frontend == "patch_embed" else 0
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s - n_img + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1]}
    if labels:
        batch["labels"] = tokens[:, 1:]
    if n_img:
        batch["vision_embeds"] = rng.standard_normal((b, n_img, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    assert _err(_np(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
                jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))) <= 1e-6
    for theta in (1e4, 1e6):
        got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos) + 30, theta)
        want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos) + 30, theta)
        assert _err(_np(got), want) <= 1e-6
    # bfloat16 in, bfloat16 out, float32 inside
    xb = torch.from_numpy(x).bfloat16()
    assert tlayers.rms_norm(xb, torch.from_numpy(w)).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_jax(kind):
    specs = tlayers.mlp_specs(16, 40, kind)
    host = numpy_params(specs, 3)
    x = np.random.default_rng(4).standard_normal((2, 5, 16)).astype(np.float32)
    got = tlayers.mlp_apply(lm_params_from_numpy(host, "cpu"), torch.from_numpy(x), kind)
    want = jlayers.mlp_apply(jax.tree.map(jnp.asarray, host), jnp.asarray(x), kind)
    assert sorted(host) == sorted(jlayers.mlp_specs(16, 40, kind))
    assert _err(_np(got), want) <= 1e-6


def test_numpy_params_follow_the_reference_law():
    """Spec trees are key for key the reference's; normal leaves have the
    reference's stddev scale/√fan_in, ones and zeros are exact."""
    jcfg, tcfg = _cfgs("qwen3-4b")
    jspecs = j_build(jcfg).param_specs()
    tspecs = build_model(tcfg).param_specs()
    jflat = dict(jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=jlayers.is_spec)[0])
    tflat = flatten_with_paths(tspecs)
    assert len(jflat) == len(tflat)
    for (jpath, js), (tpath, ts) in zip(jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=jlayers.is_spec)[0], tflat):
        assert tuple(k.key for k in jpath) == tpath
        assert (js.shape, js.axes, js.init, js.scale) == (ts.shape, ts.axes, ts.init, ts.scale)
    host = numpy_params(tspecs, 0)
    emb = host["embed"]
    assert emb.dtype == np.float32 and abs(emb.std() * 16 - 1.0) < 0.02   # fan_in 256
    wq = host["blocks"]["attn"]["wq"]
    assert abs(wq.std() * np.sqrt(64) - 1.0) < 0.05
    assert np.all(host["blocks"]["ln1"] == 1) and np.all(host["final_ln"] == 1)
    t = tlayers.init_params(tspecs, torch.Generator().manual_seed(0), "cpu")
    assert abs(float(t["unembed"].std()) * 8 - 1.0) < 0.05


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 37])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(chunk, causal):
    rng = np.random.default_rng(0)
    b, s, h, kv, d = 2, 37, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, kv, kv))
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                causal=causal, chunk=chunk)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, chunk=chunk)
    assert got.shape == (b, s, h, d)
    assert _err(_np(got), want) <= 2e-5


def test_flash_attention_bf16_operands_accumulate_in_float32():
    """bfloat16 q/k/v: float32 logits and accumulators, bfloat16 out —
    within the bfloat16 rounding of the output of the reference."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 19, 4, 16)).astype(np.float32) for _ in range(3))
    got = tattn.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                causal=True, chunk=8)
    want = jattn.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                 causal=True, chunk=8)
    assert got.dtype == torch.bfloat16
    assert _err(_np(got), np.asarray(want, np.float32)) <= 2 ** -7


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward_and_grads(name, vocab=None):
    kw = {"vocab_size": vocab} if vocab else {}
    jcfg, tcfg = _cfgs(name, **kw)
    jp, _ = _params(tcfg)
    jb, _ = _both(_batch(tcfg))
    logits, _ = jax.jit(functools.partial(jtr.decoder_forward, jcfg))(jp, jb)
    loss, grads = jax.jit(jax.value_and_grad(j_build(jcfg).loss))(jp, jb)
    return np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", DENSE)
def test_decoder_forward_matches_jax(name, remat):
    want, _, _ = _jax_forward_and_grads(name)
    _, tcfg = _cfgs(name, remat=remat)
    _, tp = _params(tcfg)
    _, tb = _both(_batch(tcfg))
    logits, aux = ttr.decoder_forward(tcfg, tp, tb)
    assert logits.dtype == torch.float32 and logits.shape == want.shape
    assert _err(_np(logits), want) <= 1e-4 and float(aux) == 0.0


def test_padded_vocab_mask_matches_jax():
    """vocab 250 pads to 256: the six padding logits sit at −1e30 (added in
    float32) and the real ones match JAX."""
    want, _, _ = _jax_forward_and_grads("qwen3-4b", 250)
    _, tcfg = _cfgs("qwen3-4b", vocab_size=250)
    assert tcfg.padded_vocab == 256
    _, tp = _params(tcfg)
    _, tb = _both(_batch(tcfg))
    logits = _np(ttr.decoder_forward(tcfg, tp, tb)[0])
    assert np.all(logits[..., 250:] < -9e29) and np.all(want[..., 250:] < -9e29)
    assert _err(logits[..., :250], want[..., :250]) <= 1e-4


@pytest.mark.parametrize("policy", ["nothing", "dots", "off"])
@pytest.mark.parametrize("name", DENSE)
def test_lm_loss_and_gradients_match_jax(name, policy):
    """``lm_loss`` and every gradient leaf against ``jax.grad`` (1e-4 of the
    leaf's scale), under each activation-checkpointing policy."""
    _, jloss, jgrads = _jax_forward_and_grads(name)
    kw = {"remat": False} if policy == "off" else {"remat": True, "remat_policy": policy}
    _, tcfg = _cfgs(name, **kw)
    _, tp = _params(tcfg)
    _, tb = _both(_batch(tcfg))
    leaves = [leaf.requires_grad_(True) for _, leaf in flatten_with_paths(tp)]
    loss = build_model(tcfg).loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) / jloss - 1) <= 1e-4
    jflat = {tuple(k.key for k in path): g
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for (path, _), g in zip(flatten_with_paths(tp), grads):
        assert _err(_np(g), jflat[path]) <= 1e-4, path


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("tp_degree", [16, 1])
@pytest.mark.parametrize("name", ["qwen3-4b", "internvl2-26b"])
def test_prefill_and_decode_match_jax(name, tp_degree):
    """The cache layout (kv heads repeated toward the TP degree), its
    entries within one bfloat16 ulp of JAX's, the logits 1e-3."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(tcfg)
    batch = _batch(tcfg, labels=False)
    jb, tb = _both(batch)
    n_img = tcfg.num_frontend_tokens if tcfg.frontend == "patch_embed" else 0
    prompt = batch["tokens"].shape[1] + n_img
    max_len = prompt + 3
    jm, tm = j_build(jcfg, tp_degree), build_model(tcfg, tp_degree)
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(jp, jb, max_len)
    tlog, tcache = tm.prefill(tp, tb, max_len)
    rep = ttr.kv_repeat_for(tcfg, tp_degree)
    assert rep == (2 if tp_degree == 16 else 1)
    assert tuple(tcache["k"].shape) == jcache["k"].shape == (
        tcfg.num_layers, 2, max_len, tcfg.num_kv_heads * rep, tcfg.head_dim)
    assert tcache["k"].dtype == torch.bfloat16
    for key in ("k", "v"):
        got, want = _np(tcache[key]), np.asarray(jcache[key], np.float32)
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), key
    assert _err(_np(tlog), jlog) <= 1e-3
    step = np.array([[5], [7]], np.int32)
    jd = jax.jit(jm.decode)
    for i in range(3):
        jlog, jcache = jd(jp, {"tokens": jnp.asarray(step), "cache_len": jnp.int32(prompt + i)},
                          jcache)
        tlog, tcache = tm.decode(tp, {"tokens": torch.from_numpy(step), "cache_len": prompt + i},
                                 tcache)
        assert _err(_np(tlog), jlog) <= 1e-3, i
        step = (step + 11) % tcfg.vocab_size
    got, want = _np(tcache["k"]), np.asarray(jcache["k"], np.float32)
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))


def test_dense_decode_matches_full_forward():
    """Greedy continuation via (prefill + decode) equals a full forward pass
    over the same tokens (the port's copy of the reference test)."""
    _, cfg = _cfgs("qwen3-4b")
    model = build_model(cfg, tp_degree=1)
    params = tlayers.init_params(model.param_specs(), torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 32
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (b, s)))
    full_logits, _ = ttr.decoder_forward(cfg, params, {"tokens": tokens})
    logits_p, cache = model.prefill(params, {"tokens": tokens[:, : s - 1]}, s)
    np.testing.assert_allclose(_np(logits_p[:, 0]), _np(full_logits[:, s - 2]),
                               rtol=2e-2, atol=2e-2)
    logits_d, cache2 = model.decode(params, {"tokens": tokens[:, s - 1:], "cache_len": s - 1},
                                    cache)
    assert cache2 is cache                              # written in place
    np.testing.assert_allclose(_np(logits_d[:, 0]), _np(full_logits[:, s - 1]),
                               rtol=2e-2, atol=2e-2)


def test_bf16_smoke_train_step_matches_jax():
    """One optimizer step of the smoke qwen3-4b in bfloat16 compute (its
    default) from the same state and batch: the loss within 2e-2."""
    from repro.train.train_step import make_train_step as j_make_train_step

    jcfg, tcfg = _cfgs("qwen3-4b", compute_dtype="bfloat16")
    shape = ShapeSpec("t", "train", 24, 2)
    jp, tp = _params(tcfg)
    jb, tb = _both(_batch(tcfg))
    jopt = jax.tree.map(lambda p: {"m": jnp.zeros_like(p), "v": jnp.zeros_like(p)}, jp)
    jstate = {"params": jp, "opt": jopt, "step": jnp.int32(0)}
    _, jm = jax.jit(j_make_train_step(jcfg, shape, lr=1e-3, warmup=1))(jstate, jb)
    tstate = {"params": tp, "opt": tlayers.tree_map(
        lambda p: {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}, tp),
        "step": torch.tensor(0, dtype=torch.int32)}
    _, tmet = make_train_step(tcfg, shape, lr=1e-3, warmup=1)(tstate, tb)
    assert abs(float(tmet["loss"]) / float(jm["loss"]) - 1) <= 2e-2
    assert abs(float(tmet["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 2e-2
    assert int(tstate["step"]) == 1
