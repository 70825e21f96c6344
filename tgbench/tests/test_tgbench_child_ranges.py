"""The readers of the program's child ranges (``tg.sync``,
``tg.solve.matvec``, ``tg.map.context``, ``tg.condense``, ``tg.ell.values``,
``tg.solve.residual``) on the hand-made trace of ``test_tgbench_tracing``
with child ranges added inside its parents: their values, ``None`` on a
trace without the children (a program that opens none), every reader of
every cell reading, and the parents' readers unmoved by the nesting."""

import pytest
import test_tgbench_tracing as tracing_tests
from test_tgbench_tracing import EVENTS, X

from tgbench.readout import Run, reader
from tgbench.run import ROOT, load_cell
from tgbench.tracing import Trace
from tgbench.work.sizes import Sizes

# Inside the one traced operation (150-800) of EVENTS.  The children wrap
# the launches EVENTS already has inside its parents and launch nothing new
# there, so the parents' readers read the same; new device work lies
# outside them.
CHILD_EVENTS = [
    X("user_annotation", "tg.ell.values", 160, 30),     # 160-190: the loop's values
    X("cuda_runtime", "cudaLaunchKernel", 170, 3, 11),
    X("kernel", "index_put", 175, 5, 11),               # 175-180
    X("user_annotation", "tg.solve.matvec", 205, 13),   # 205-218: around launch 1 (spmv)
    X("user_annotation", "tg.sync", 360, 40),           # 360-400
    X("user_annotation", "tg.sync", 500, 90),           # 500-590
    X("user_annotation", "tg.solve.bicgstab", 602, 46),  # 602-648
    X("user_annotation", "tg.sync", 610, 20),           # 610-630
    X("user_annotation", "tg.solve.matvec", 633, 7),    # 633-640
    X("cuda_runtime", "cudaLaunchKernel", 635, 2, 12),
    X("kernel", "spmv_wide", 640, 6, 12),               # 640-646
    X("user_annotation", "tg.map.context", 652, 16),    # 652-668: around launch 3 (map)
    X("user_annotation", "tg.condense", 755, 20),       # 755-775
    X("cuda_runtime", "cudaLaunchKernel", 760, 3, 13),
    X("kernel", "mask", 765, 10, 13),                   # 765-775
    X("user_annotation", "tg.solve.residual", 780, 18),  # 780-798
    X("user_annotation", "tg.ell.values", 782, 8),      # 782-790: the residual's values
    X("cuda_runtime", "cudaLaunchKernel", 785, 3, 14),
    X("kernel", "index_put", 790, 5, 14),               # 790-795
    X("user_annotation", "tg.sync", 792, 5),            # 792-797
    X("cuda_runtime", "cudaMemcpyAsync", 793, 2, 15),
    X("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 795, 1, 15),
]

CELLS = ["poisson96.assembled", "poisson96.matfree", "elasticity48.assembled",
         "poisson96.heat_cn"]


def _run(workload, events):
    cell = load_cell(ROOT, workload)
    steps = cell.traffic.get("rollout", {}).get("steps", 1)
    run = Run(cell.config, cell.traffic, Sizes(1000, 300, 1, 300, 4000), (3.35e12, 34e12),
              setup_s=20.0, plan_build_s=15.0,
              walls_s=[0.5, 0.5], iters=[[10] * steps, [12] * steps], steps_per_op=steps,
              peak_bytes=2**31, trace=Trace(events), traced=range(1, 2))
    return cell, run


@pytest.mark.parametrize("workload,name,value", [
    # 4 syncs in the operation over its 12 iterations
    ("poisson96.assembled", "krylov_syncs_per_iter.solve", 4 / 12),
    ("poisson96.matfree", "krylov_syncs_per_iter.matfree", 4 / 12),
    ("poisson96.heat_cn", "krylov_syncs_per_iter.step", 4 / (12 * 20)),
    # the CG range (400 µs) less its two syncs (40 + 90), over 12 iterations
    ("poisson96.assembled", "krylov_issue_us_per_iter.solve", (400 - 130) / 12),
    ("poisson96.matfree", "krylov_issue_us_per_iter.matfree", (400 - 130) / 12),
    ("poisson96.heat_cn", "krylov_issue_us_per_iter.step", (400 - 130) / (12 * 20)),
    # the BiCGSTAB range (46 µs) less its sync (20)
    ("elasticity48.assembled", "krylov_issue_us_per_iter.solve", (46 - 20) / 12),
    ("poisson96.assembled", "map_context_ms.solve", 0.020),     # the map kernel
    ("elasticity48.assembled", "condense_ms.solve", 0.010),     # the mask kernel
    ("poisson96.assembled", "ell_values_ms.solve", 0.010),      # both fills
    ("elasticity48.assembled", "ell_builds_per_solve.solve", 2.0),
])
def test_the_child_readers_read(workload, name, value):
    _, run = _run(workload, EVENTS + CHILD_EVENTS)
    assert reader("metrics", name)(run) == pytest.approx(value)
    _, parent = _run(workload, EVENTS)
    assert reader("metrics", name)(parent) is None


def test_a_copy_to_the_host_outside_the_helper_counts_as_a_sync():
    """A device-to-host copy launched inside the traced operation but in no
    ``tg.sync`` range (an ``.item()`` the program does not name) is one
    more sync; the one inside a ``tg.sync`` range is not counted twice."""
    unnamed = [X("cuda_runtime", "cudaMemcpyAsync", 450, 2, 16),
               X("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 452, 1, 16)]
    _, run = _run("poisson96.assembled", EVENTS + CHILD_EVENTS + unnamed)
    assert reader("metrics", "krylov_syncs_per_iter.solve")(run) == pytest.approx(5 / 12)


@pytest.mark.parametrize("workload", CELLS)
def test_every_reader_of_a_cell_reads_the_nested_trace(workload, monkeypatch):
    """``test_every_reader_of_a_cell_reads`` itself, its input grown to
    ``EVENTS + CHILD_EVENTS``: on ``EVENTS`` alone the child readers find
    no range, as on a program that opens none."""
    monkeypatch.setattr(tracing_tests, "EVENTS", EVENTS + CHILD_EVENTS)
    tracing_tests.test_every_reader_of_a_cell_reads(workload)


@pytest.mark.parametrize("name", ["krylov_host_us_per_iter.solve", "krylov_roofline.solve",
                                  "map_roofline.solve"])
def test_nesting_leaves_the_parents_readers_alone(name):
    _, flat = _run("poisson96.assembled", EVENTS)
    _, nested = _run("poisson96.assembled", EVENTS + CHILD_EVENTS)
    before = reader("metrics", name)(flat)
    assert before is not None and reader("metrics", name)(nested) == pytest.approx(before)


def test_the_breakdown_names_the_children():
    """Idle time inside a child goes to the child, not to its parent."""
    gaps = dict(Trace(EVENTS + CHILD_EVENTS).breakdown()["idle_gaps"])
    assert gaps["tg.sync"] == pytest.approx((40 + 90 + 20 + 1) * 1e-6)   # 796-797
    assert gaps["tg.solve.matvec"] == pytest.approx((13 + 7) * 1e-6)     # 205-218, 633-640
    assert gaps["tg.solve.cg"] == pytest.approx((5 + 2 + 250 - 130) * 1e-6)
    assert gaps["tg.condense"] == pytest.approx(10e-6)                   # 755-765
