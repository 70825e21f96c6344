"""The trace reduction and the per-layer readers on a hand-made Chrome
trace: unions, launches attributed to ranges, host time net of device time,
the breakdown, and every reader of every cell."""

import pytest

from tgbench.readout import Run, reader
from tgbench.run import ROOT, load_cell
from tgbench.tracing import OP, STRETCH, Trace, union_s
from tgbench.work.sizes import Sizes


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X("user_annotation", STRETCH, 100, 1000),
    X("user_annotation", OP, 150, 650),                 # 150-800: one traced operation
    X("user_annotation", "tg.solve.cg", 200, 400),      # 200-600
    X("user_annotation", "tg.map", 650, 50),            # 650-700
    X("user_annotation", "tg.reduce", 700, 50),         # 700-750
    X("user_annotation", "tg.matfree.action", 250, 20),  # 250-270, inside the loop
    X("cuda_runtime", "cudaLaunchKernel", 210, 5, 1),
    X("kernel", "spmv", 220, 80, 1),                    # 220-300
    X("cuda_runtime", "cudaLaunchKernel", 255, 5, 2),
    X("kernel", "action", 300, 50, 2),                  # 300-350
    X("cuda_runtime", "cudaLaunchKernel", 660, 5, 3),
    X("kernel", "map", 670, 20, 3),                     # 670-690
    X("cuda_runtime", "cudaLaunchKernel", 710, 5, 4),
    X("gpu_memset", "Memset", 705, 10, 4),              # 705-715
    X("kernel", "spin_kernel", 10, 5, 9),               # before the stretch
    X("user_annotation", "tg.map", 20, 5),              # before the stretch
]


def test_union_counts_an_overlap_once():
    assert union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)


def test_trace_reduction():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s() == pytest.approx((80 + 50 + 20 + 10) * 1e-6)
    assert t.count("tg.map") == 1
    assert t.busy_s(t.launched_in("tg.solve.cg")) == pytest.approx(130e-6)
    assert t.busy_s(t.launched_in("tg.matfree.action")) == pytest.approx(50e-6)
    assert t.busy_s(t.launched_in("tg.map")) == pytest.approx(20e-6)
    assert t.host_minus_device_s("tg.solve.cg") == pytest.approx((400 - 130) * 1e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["spmv", pytest.approx(80e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["tg.solve.cg"] == pytest.approx((20 + 250) * 1e-6)   # 200-220, 350-600
    assert gaps["tg.map"] == pytest.approx((20 + 10) * 1e-6)         # 650-670, 690-700
    assert gaps["tg.reduce"] == pytest.approx(40e-6)                 # 700-705, 715-750
    assert gaps["outside tg ranges"] == pytest.approx((100 + 50 + 350) * 1e-6)


def test_an_operation_whose_range_lost_its_records_is_left_out():
    t = Trace(EVENTS)
    assert t.complete_ops_s("tg.reduce") == [pytest.approx(10e-6)]
    assert t.complete_ops_s("tg.map") == [pytest.approx(20e-6)]
    # a second operation whose Reduce launched a kernel the trace did not record
    lost = Trace(EVENTS + [X("user_annotation", OP, 850, 100),
                           X("user_annotation", "tg.reduce", 860, 20),
                           X("cuda_runtime", "cudaLaunchKernel", 865, 5, 7)])
    assert lost.complete_ops_s("tg.reduce") == [pytest.approx(10e-6)]
    assert lost.complete_ops_s("tg.solve.gmres") == []


def test_a_trace_without_its_stretch_is_refused():
    with pytest.raises(RuntimeError):
        Trace(EVENTS[1:])


@pytest.mark.parametrize("workload", ["poisson96.assembled", "poisson96.matfree",
                                      "elasticity48.assembled", "poisson96.heat_cn"])
def test_every_reader_of_a_cell_reads(workload):
    cell = load_cell(ROOT, workload)
    steps = cell.traffic.get("rollout", {}).get("steps", 1)
    run = Run(cell.config, cell.traffic, Sizes(1000, 300, 1, 300, 4000), (3.35e12, 34e12),
              setup_s=20.0, plan_build_s=15.0,
              walls_s=[0.5, 0.5], iters=[[10] * steps, [12] * steps], steps_per_op=steps,
              peak_bytes=2**31, trace=Trace(EVENTS), traced=range(1, 2))
    for m in cell.end_to_end:
        value = reader("e2e", m["name"])(run)
        assert value is not None and value > 0, m["name"]
    for m in cell.per_layer:
        value = reader("metrics", m["name"])(run)
        if m["name"].startswith(("map_", "reduce_", "krylov_roofline", "krylov_host",
                                 "action_")):
            ranges = {"map": "tg.map", "reduce": "tg.reduce", "action": "tg.matfree.action"}
            name = ranges.get(m["name"].split("_")[0], f"tg.solve.{run.method}")
            assert (value is None) == (not run.trace.count(name)), m["name"]
        else:
            assert value is not None, m["name"]
        assert value is None or value > 0, m["name"]
