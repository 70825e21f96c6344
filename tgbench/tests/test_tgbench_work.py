"""The yardstick's counts: PERF.md's bounds of B1 and B2 at their shapes,
the sizes of the n = 64 and n = 96 meshes, and a Krylov iteration never
counted below one read of its operator."""

import pytest

from tgbench.plugins import load
from tgbench.work.counts import Work, action_work, krylov_work, least_s, map_work, reduce_work
from tgbench.work.peaks import peaks
from tgbench.work.sizes import p1_sizes

H100 = peaks("NVIDIA H100 80GB HBM3")


def test_h100_peaks():
    assert H100 == (3.35e12, 34e12)


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H200", "cpu", ""])
def test_a_card_without_peaks_is_refused(name):
    with pytest.raises(LookupError):
        peaks(name)


def test_b1_bound_at_n64():
    # PERF.md: B1 at E = 1,572,864 is bound by bytes at 0.1089 ms
    w = map_work("p1_diffusion", 1_572_864)
    assert w.nbytes == 232 * 1_572_864
    assert 1e3 * least_s(w, *H100) == pytest.approx(0.1089, abs=5e-5)


def test_b2_bound_at_n64():
    # PERF.md: B2 at rows 4,018,753, src 25,165,824 is bound at 0.1045 ms
    w = reduce_work(25_165_824, 4_018_753)
    assert 1e3 * least_s(w, *H100) == pytest.approx(0.1045, abs=5e-5)


@pytest.mark.parametrize("gen,n,dofs,cells,nnz", [
    ("unit_cube_tet", 64, 274_625, 1_572_864, 4_018_753),
    ("unit_cube_tet", 96, 912_673, 5_308_416, 13_465_441),
    ("hollow_cube_tet", 48, 105_482, 580_608, None),
])
def test_sizes(gen, n, dofs, cells, nnz):
    points, c = load("reference/meshes", gen).generate(n)
    s = p1_sizes(c, points.shape[0], 1)
    assert (s.dofs, s.cells) == (dofs, cells)
    if nnz is not None:
        assert s.nnz == nnz


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
@pytest.mark.parametrize("iters", [0, 1, 300])
def test_krylov_counts_at_least_one_operator_read_an_iteration(method, iters):
    nnz, n = 13_465_441, 912_673
    w = krylov_work(method, nnz, n, iters)
    operator = 12 * nnz
    assert w.nbytes >= operator * (iters + 1)
    assert w.flops >= 2 * nnz * (iters + 1)


def test_work_adds_and_scales():
    a = Work(10, 1) + Work(5, 2) * 2
    assert (a.nbytes, a.flops) == (20, 5)
    assert action_work(1).nbytes == 8 * (12 + 2 + 8)


def test_a_pool_gives_every_seed_the_same_inputs_in_another_order():
    import torch

    from tgbench.generator import Draws
    points, cells = load("reference/meshes", "unit_cube_tet").generate(3)
    spec = {"kind": "log_fourier", "k_max": 3, "log_std": 1.0, "pool": 4}
    a, b = (Draws(spec, seed, points, cells, "cpu") for seed in (2**31 + 5, 11))
    sums_a = [float(a.input(i).sum()) for i in range(5)]
    sums_b = [float(b.input(i).sum()) for i in range(4)]
    assert sorted(sums_a[:4]) == sorted(sums_b) and sums_a[4] == sums_a[0]
    fresh = Draws({k: v for k, v in spec.items() if k != "pool"}, 11, points, cells, "cpu")
    x = fresh.input(0)
    assert torch.equal(x, fresh.input(0)) and not torch.equal(x, fresh.input(1))
    assert float(x.log().std()) == pytest.approx(1.0, abs=0.3)
