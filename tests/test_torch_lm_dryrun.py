"""The port's dry-run machinery on a host-sized mesh (the 256/512-rank
production sweep runs with ``python -m repro_torch.launch.dryrun``): every
architecture's train, prefill and decode step run once on ``meta`` DTensor
stand-ins in a fake world of 8 ranks, a (4, 2) mesh, under the per-rank op
counter, as ``tests/test_dryrun.py`` lowers and compiles them; and the
counter's units (``tests/test_infra.py``'s HLO-cost tests restated).

The cells run in fake worlds spawned as subprocesses
(``tests/torch_lm_layout_worker.py``); the counter's units use a fake
world in a module fixture that always destroys it, so no process group
outlives this module (A16's one-rank meshes read
``dist.is_initialized()``)."""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from repro.analysis.hlo_cost import analyze_hlo_text  # noqa: E402

import torch_lm_layout_worker as worker  # noqa: E402
from repro_torch.analysis.op_cost import count_ops  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

KINDS = ("train", "prefill", "decode")
# the 30 cells in three fake worlds run side by side, the costliest spread
GROUPS = 3


@pytest.fixture(scope="module")
def cells():
    """Every (arch, kind) cell's roofline row: ``lower_cell`` at
    ``tests/test_dryrun.py``'s shapes, remat off, in fake worlds of 8 ranks
    (a (4, 2) mesh) spawned side by side (each destroys its world)."""
    order = [(a, k) for k in KINDS for a in sorted(ARCHS)]
    procs = worker.Procs(worker._dryrun_main, [(order[i::GROUPS],) for i in range(GROUPS)])
    out = {}
    for (part,) in procs.results(timeout=900):
        out.update(part)
    return out


@pytest.fixture(scope="module")
def mesh():
    with fake_world(8):
        yield make_host_mesh(4, 2, device_type="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("kind", KINDS)
def test_lower_smoke_cell(cells, arch, kind):
    row = cells[(arch, kind)]
    assert row["error"] is None, row["error"]
    assert row["flops_per_rank"] > 0
    assert row["bytes_per_rank"] > 0
    assert row["bottleneck"] in ("compute", "memory", "collective")
    # the sharded program must issue at least one cross-rank collective
    assert row["collectives"]["total"] > 0, (arch, kind)
    assert row["held"] > 0


def _dt(mesh, local_shape, placements, global_shape):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.empty(local_shape, device="meta"), mesh, placements,
                              run_check=False, shape=torch.Size(global_shape),
                              stride=torch.empty(global_shape, device="meta").stride())


def test_op_cost_dot_flops_exact():
    """A 64×32 @ 32×128 product counts 2·64·32·128, as JAX's HLO walker."""
    a, b = torch.randn(64, 32), torch.randn(32, 128)
    with count_ops() as c:
        a @ b
    f = jax.jit(lambda x, y: x @ y)
    want = analyze_hlo_text(f.lower(jax.ShapeDtypeStruct((64, 32), jnp.float32),
                                    jax.ShapeDtypeStruct((32, 128), jnp.float32))
                            .compile().as_text()).flops
    assert c.cost.flops == 2 * 64 * 32 * 128 == want
    assert c.cost.bytes == 4 * (64 * 32 + 32 * 128 + 64 * 128)


def test_op_cost_counts_one_ranks_share(mesh):
    """A product sharded over both mesh axes (rows over 'data', the
    contraction over 'model') counts exactly 1/8 of the global FLOPs."""
    from torch.distributed.tensor import Replicate, Shard

    a = _dt(mesh, (16, 16), (Shard(0), Shard(1)), (64, 32))
    b = _dt(mesh, (16, 128), (Replicate(), Shard(0)), (32, 128))
    with count_ops() as c:
        out = a @ b
    assert c.cost.flops * 8 == 2 * 64 * 32 * 128
    assert c.cost.collective_bytes == 0 and out.placements[1].is_partial()


def test_op_cost_scales_with_loop_length():
    x = torch.randn(128, 128)
    flops = {}
    for k in (1, 8):
        with count_ops() as c:
            y = x
            for _ in range(k):
                y = y @ y
        flops[k] = c.cost.flops
    assert flops[8] == 8 * flops[1] == 8 * 2 * 128 ** 3
    assert c.cost.dynamic_loops == 0


def test_op_cost_counts_a_cross_shard_sum(mesh):
    """A sum over a dim sharded on 'data' and replicated after: an all-reduce."""
    from torch.distributed.tensor import Replicate, Shard

    x = _dt(mesh, (2, 16), (Shard(0), Replicate()), (8, 16))
    with count_ops() as c:
        s = x.sum(dim=0, keepdim=True)
        s.redistribute(mesh, (Replicate(), Replicate()))
    assert c.cost.collective_bytes > 0
    assert c.cost.collective_by_kind["all-reduce"] == c.cost.collective_bytes
    assert c.cost.collective_counts["all-reduce"] >= 1
