"""Shared inputs for the LM parity tests of the MoE, RWKV6, Mamba2, hybrid
and audio families (``tests/test_torch_lm_*.py``): one numpy draw of the
parameters at the reference's law, loaded by both packages, and numpy
batches.  Not a test module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models.model_zoo import build_model as j_build

from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.layers import flatten_with_paths, numpy_params, tree_map

FRAMES = 100          # encoder frames of the audio batches (the reference tests' count)


def err(got, want) -> float:
    """max |got − want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def to_np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def cfgs(name, **kw):
    """The same smoke config in both packages (float32 compute unless
    overridden)."""
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(smoke_variant(J_ARCHS[name]), **kw),
            dataclasses.replace(smoke_variant(ARCHS[name]), **kw))


def both_params(host):
    return jax.tree.map(jnp.asarray, host), lm_params_from_numpy(host, "cpu")


def model_params(tcfg, seed=0):
    """One numpy draw of a model's parameters, loaded by both packages."""
    return both_params(numpy_params(build_model(tcfg).param_specs(), seed))


def perturbed(host, seed, scale=0.3):
    """``host`` with normal noise of stddev ``scale`` on the zero- and
    one-initialised leaves (decays, mixes, bonuses, norms), so that they
    take generic values; the drawn leaves stay as they are."""
    rng = np.random.default_rng(seed)

    def one(a):
        if np.all(a == a.flat[0]):
            return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return tree_map(one, host)


def jax_init_params(jcfg, key=0):
    """The reference tests' parameters: ``repro``'s ``init_params`` at
    ``PRNGKey(key)``, as a numpy tree — drawn with JAX's x64 flag off, so
    that they do not depend on whether an earlier import (``repro.core``)
    turned it on in this process."""
    from repro.models.layers import init_params

    with jax.enable_x64(False):
        return jax.tree.map(np.asarray, init_params(j_build(jcfg).param_specs(),
                                                    jax.random.PRNGKey(key)))


def batch(cfg, b=2, s=24, seed=1, labels=True, frames=FRAMES):
    rng = np.random.default_rng(seed)
    n_img = cfg.num_frontend_tokens if cfg.frontend == "patch_embed" else 0
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s - n_img + 1)).astype(np.int32)
    out = {"tokens": tokens[:, :-1]}
    if labels:
        out["labels"] = tokens[:, 1:]
    if n_img:
        out["vision_embeds"] = rng.standard_normal((b, n_img, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_frames":
        out["audio_embeds"] = rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32)
    return out


def both(batch_):
    return ({k: jnp.asarray(v) for k, v in batch_.items()},
            {k: torch.from_numpy(v) for k, v in batch_.items()})


def jflat(tree) -> dict:
    """A JAX tree's leaves by key path."""
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_loss_and_grads(jcfg, jp, jb):
    loss, grads = jax.jit(jax.value_and_grad(j_build(jcfg).loss))(jp, jb)
    return float(loss), jax.tree.map(np.asarray, grads)


def check_loss_and_grads(tcfg, tp, tb, jloss, jgrads, tol=1e-4):
    """The port's loss and every gradient leaf against JAX's (``tol`` of
    each leaf's scale)."""
    leaves = [leaf.requires_grad_(True) for _, leaf in flatten_with_paths(tp)]
    loss = build_model(tcfg).loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) / jloss - 1) <= tol
    want = jflat(jgrads)
    assert len(want) == len(grads)
    for (path, _), g in zip(flatten_with_paths(tp), grads):
        assert err(to_np(g), want[path]) <= tol, path


def check_cache(tcache, jcache, what=""):
    """Every cache leaf against JAX's: the same shape and dtype, bfloat16
    leaves within one bfloat16 ulp, float32 leaves 1e-4 of scale."""
    want = jflat(jcache)
    got = flatten_with_paths(tcache)
    assert sorted(want) == sorted(p for p, _ in got), what
    for path, t in got:
        w = np.asarray(want[path], np.float32)
        assert tuple(t.shape) == w.shape, (what, path)
        assert str(t.dtype).split(".")[-1] == str(want[path].dtype), (what, path, t.dtype)
        g = to_np(t)
        if t.dtype == torch.bfloat16:
            assert np.all(np.abs(g - w) <= bf16_ulp(w)), (what, path)
        else:
            assert err(g, w) <= 1e-4, (what, path)


# ---------------------------------------------------------------------------
# the reference tests' own inputs (tests/test_models.py)
# ---------------------------------------------------------------------------

def smoke_batch(cfg, b=2, s=64, with_labels=True):
    """``tests/test_models.py::_smoke_batch`` at ``PRNGKey(0)``, as numpy
    arrays (drawn with JAX's x64 flag off, as ``jax_init_params``)."""
    with jax.enable_x64(False):
        return _smoke_batch(cfg, b, s, with_labels)


def _smoke_batch(cfg, b, s, with_labels):
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    tokens = jax.random.randint(ks[0], (b, s + 1), 0, cfg.vocab_size)
    out = {"tokens": tokens[:, :-1]}
    if with_labels:
        out["labels"] = tokens[:, 1:]
    if cfg.frontend == "patch_embed":
        n = cfg.num_frontend_tokens
        out["tokens"] = out["tokens"][:, : s - n]
        if with_labels:
            out["labels"] = out["labels"][:, : s - n]
        out["vision_embeds"] = jax.random.normal(ks[1], (b, n, cfg.d_model))
    elif cfg.frontend == "audio_frames":
        out["audio_embeds"] = jax.random.normal(ks[2], (b, FRAMES, cfg.d_model))
    return {k: np.array(v, np.float32 if v.dtype.kind == "f" else np.int32)
            for k, v in out.items()}


def smoke_case(name):
    """(JAX config, port config, numpy parameters) of the reference tests:
    the smoke variant (bfloat16 compute) and ``init_params`` at
    ``PRNGKey(0)``."""
    from repro.configs import smoke_variant as j_smoke

    jcfg = j_smoke(J_ARCHS[name])
    return jcfg, smoke_variant(ARCHS[name]), jax_init_params(jcfg)
