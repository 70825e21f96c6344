"""The port's copies of ``tests/test_models.py``'s per-architecture smoke
tests over all ten ``ARCHS`` — the serve round trip — with the reference
tests' parameters (``repro``'s ``init_params`` at ``PRNGKey(0)``) and
batches.

Each runs the reference test's checks on the port at the reference's config
(smoke width, bfloat16 compute: finite prefill and decode logits of the
padded vocabulary's width), and holds the port's prefill and decode logits
to the JAX package's on the same inputs in float32 compute within 1e-3 of
scale (A17a's bar for logits read through the bfloat16 cache).  In
bfloat16 the two packages round differently (XLA keeps float32 inside its
fusions), so their bfloat16 logits part by as much as each parts from
float32 (up to 8e-2 of scale on these inputs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.models.model_zoo import build_model as j_build  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

from torch_lm_cases import both_params, err, smoke_batch, smoke_case, to_np  # noqa: E402

S = 64


def _jax_serve(jcfg, jp, batch, prompt_len):
    jm = j_build(jcfg, tp_degree=1)

    @jax.jit
    def run(params):
        logits, cache = jm.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, S + 1)
        dlogits, _ = jm.decode(params, {"tokens": jnp.zeros((2, 1), jnp.int32),
                                        "cache_len": jnp.int32(prompt_len)}, cache)
        return logits, dlogits

    return [np.asarray(x) for x in run(jp)]


def _port_serve(cfg, tp, batch, prompt_len):
    tm = build_model(cfg, tp_degree=1)
    with torch.no_grad():
        logits, cache = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, S + 1)
        dlogits, _ = tm.decode(tp, {"tokens": torch.zeros((2, 1), dtype=torch.int32),
                                    "cache_len": prompt_len}, cache)
    return logits, dlogits


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_smoke_serve_roundtrip(name):
    """Prefill of 64 positions, then one decode step at the prompt length
    the reference test reads (``tokens.shape[1]``).  The cache holds 65
    positions: the reference test's 64 leave the decode step writing past
    the end, which ``lax.dynamic_update_slice`` clamps onto the last
    entry and the port refuses."""
    jcfg, tcfg, host = smoke_case(name)
    jp, tp = both_params(host)
    batch = smoke_batch(tcfg, s=S, with_labels=False)
    prompt_len = batch["tokens"].shape[1]
    logits, dlogits = _port_serve(tcfg, tp, batch, prompt_len)
    assert torch.isfinite(logits).all() and torch.isfinite(dlogits).all(), name
    assert dlogits.shape == (2, 1, tcfg.vocab_size)

    got = _port_serve(dataclasses.replace(tcfg, compute_dtype="float32"), tp, batch, prompt_len)
    want = _jax_serve(dataclasses.replace(jcfg, compute_dtype="float32"), jp, batch, prompt_len)
    for g, w in zip(got, want):
        assert err(to_np(g), w) <= 1e-3
