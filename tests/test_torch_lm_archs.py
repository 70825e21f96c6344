"""The port's copies of ``tests/test_models.py``'s per-architecture smoke
tests over all ten ``ARCHS`` — the train step — with the reference tests'
parameters (``repro``'s ``init_params`` at ``PRNGKey(0)``) and batches.

Each runs the reference test's checks on the port at the reference's config
(smoke width, bfloat16 compute: a finite positive loss, finite gradients
with some signal), and holds the port to the JAX package's numbers on the
same inputs in float32 compute: the loss and the gradient norm within
1e-4 (relative).  In bfloat16 the two packages round differently (XLA keeps
float32 inside its fusions), so their bfloat16 results part by as much as
each parts from float32 (up to 8e-2 of scale on these inputs)."""

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
from repro_torch.models.layers import flatten_with_paths  # noqa: E402

from torch_lm_cases import both_params, smoke_batch, smoke_case  # noqa: E402


def _port_loss_and_grads(cfg, tp, batch):
    leaves = [p.requires_grad_(True) for _, p in flatten_with_paths(tp)]
    loss = build_model(cfg, tp_degree=1).loss(tp, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_smoke_train_step(name):
    jcfg, tcfg, host = smoke_case(name)
    batch = smoke_batch(tcfg)
    loss, grads = _port_loss_and_grads(tcfg, both_params(host)[1], batch)
    assert np.isfinite(loss) and loss > 0, name
    assert all(torch.isfinite(g).all() for g in grads), name
    assert sum(float(g.abs().sum()) for g in grads) > 0, name

    jcfg32 = dataclasses.replace(jcfg, compute_dtype="float32")
    tcfg32 = dataclasses.replace(tcfg, compute_dtype="float32")
    jp, tp = both_params(host)
    jloss, jgrads = jax.jit(jax.value_and_grad(j_build(jcfg32, tp_degree=1).loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss32, grads32 = _port_loss_and_grads(tcfg32, tp, batch)
    assert abs(loss32 / float(jloss) - 1) <= 1e-4
    norm = float(torch.sqrt(sum(torch.sum(g ** 2) for g in grads32)))
    jnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(jgrads))))
    assert abs(norm / jnorm - 1) <= 1e-4
