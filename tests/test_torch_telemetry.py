"""Torch port parity for the telemetry (A2, A14): ``repro_torch.telemetry``
against ``repro.telemetry`` on the same call sequences — metric rows and
their JSONL export key for key, span trees, trace-id propagation and the
``span_us`` fold, SLO attainment and burn rate, the flight recorder, the
report rendering rows exported by the JAX package, ``capture``, and the
eager meaning of a "trace" (``count_trace``, ``jit_trace_total``,
``n_core_traces``, ``n_matfree_traces``, ``clear_assembly_caches``,
``clear_device_mirrors``); and that the port's telemetry, serve and launch
modules load with JAX and the JAX package blocked."""

import json
import math
import os
import subprocess
import sys
import threading
import time
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
from repro import telemetry as jt  # noqa: E402
from repro.core import weakform as jwf  # noqa: E402
from repro.telemetry import metrics as jmetrics  # noqa: E402
from repro.telemetry import report as jreport  # noqa: E402
from repro.telemetry import spans as jspans  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import telemetry as tt  # noqa: E402
from repro_torch.core import weakform as twf  # noqa: E402
from repro_torch.telemetry import metrics as tmetrics  # noqa: E402
from repro_torch.telemetry import report as treport  # noqa: E402
from repro_torch.telemetry import spans as tspans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
Info = namedtuple("Info", "iters residual converged")
PAIRS = ((jt, jmetrics, jspans), (tt, tmetrics, tspans))


def _reset():
    for tel, met, sp in PAIRS:
        tel.disable()
        tel.reset()
        tel.clear_events()
        tel.clear_slos()
        tel.clear_flight()
        sp._FLIGHT_PATH = None
        met._STATE.jsonl = None  # enable() keeps a stale stream otherwise
        met._STATE.on_nonconverged = "warn"


@pytest.fixture(autouse=True)
def _clean_telemetry():
    _reset()
    yield
    _reset()


def _strip_ids(row: dict) -> dict:
    """A row without the values that differ between two sessions by
    construction: ids, clocks and walls."""
    drop = {"trace_id", "span_id", "parent_id", "start_ns", "end_ns", "t", "us_per_call",
            "derived", "wall_us"}
    return {k: v for k, v in row.items() if k not in drop}


# ---------------------------------------------------------------------------
# names and imports
# ---------------------------------------------------------------------------

def test_public_names_match_the_reference():
    import repro.serve as js

    import repro_torch.serve as ts

    assert sorted(tt.__all__) == sorted(jt.__all__)
    assert all(hasattr(tt, name) for name in tt.__all__)
    assert sorted(ts.__all__) == sorted(js.__all__)
    assert all(hasattr(ts, name) for name in ts.__all__)
    assert sorted(tmetrics.__all__) == sorted(jmetrics.__all__)
    assert sorted(tspans.__all__) == sorted(jspans.__all__)
    for name in ("n_core_traces", "n_matfree_traces", "clear_assembly_caches",
                 "clear_device_mirrors"):
        assert callable(getattr(tc, name))


def test_modules_load_with_jax_blocked():
    """The telemetry, serve and launch modules import with ``jax``,
    ``jaxlib`` and ``repro`` made unimportable, and hold the names."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.telemetry as t, repro_torch.telemetry.report\n"
        "import repro_torch.serve as s, repro_torch.launch.serve, repro_torch.core as c\n"
        "names = [getattr(t, n) for n in t.__all__] + [getattr(s, n) for n in s.__all__]\n"
        "names += [c.n_core_traces, c.n_matfree_traces, c.clear_assembly_caches,\n"
        "          c.clear_device_mirrors]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('loaded:', ','.join(bad), len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.stdout.strip().splitlines()[-1] == f"loaded:  {len(tt.__all__) + 13 + 4}"


# ---------------------------------------------------------------------------
# metrics registry: rows and export, key for key
# ---------------------------------------------------------------------------

def _record_metrics(tel, wf):
    tel.enable()
    spec, _ = wf.lower(wf.diffusion(2.0) + wf.mass(1.0), wf.MATRIX)
    tel.counter_inc("solves", 3, solver="cg")
    tel.gauge_set("csr_bytes", 1234)
    for v in (5.0, 1.0, 3.0, 9.0):
        tel.histogram_observe("solve_wall_us", v, solver="cg")
    tel.count_trace("serve", None, spec, backend="csr")
    tel.count_cache("serve_exec", False)
    tel.count_cache("serve_exec", True)
    tel.count_cache("serve_exec", True)
    tel.define_slo("csr", p99_us=4.0, solver="cg", histogram="solve_wall_us")


def test_metric_rows_and_export_match_the_reference(tmp_path):
    _record_metrics(jt, jwf)
    _record_metrics(tt, twf)
    rows_j, rows_t = jt.metric_rows(), tt.metric_rows()
    assert rows_t == rows_j
    assert [sorted(r) for r in rows_t] == [sorted(r) for r in rows_j]
    assert tt.jit_trace_total("serve") == jt.jit_trace_total("serve") == 1
    assert tt.snapshot() == jt.snapshot()
    fj, ft = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jt.export_jsonl(str(fj))
    tt.export_jsonl(str(ft))
    assert fj.read_text() == ft.read_text()
    assert tmetrics.histogram_values("solve_wall_us") == jmetrics.histogram_values(
        "solve_wall_us")


def test_events_stream_the_reference_rows(tmp_path):
    for tel, name in ((jt, "j"), (tt, "t")):
        tel.enable(jsonl=str(tmp_path / f"{name}.jsonl"))
        tel.record_solve("serve.dispatch", Info(np.array([4, 6]), np.array([1e-11, 2e-11]),
                                                np.array([True, True])),
                         method="cg", backend="csr", precond="jacobi", wall_us=12.5,
                         batch=2, padded=2, cache_hit=True)
        tel.record_assembly("assemble", num_dofs=9, nnz=49, num_cells=8, form="diffusion",
                            wall_us=3.0)
        tel.record_event("custom", "thing", value=np.float64(2.5), items=np.arange(3))
        tel.disable()
    rows = {name: [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
            for name in ("j", "t")}
    assert [_strip_ids(r) for r in rows["t"]] == [_strip_ids(r) for r in rows["j"]]
    assert [r["derived"] for r in rows["t"]] == [r["derived"] for r in rows["j"]]
    assert [r["us_per_call"] for r in rows["t"]] == [r["us_per_call"] for r in rows["j"]]
    assert [_strip_ids(e) for e in tt.event_log()] == [_strip_ids(e) for e in jt.event_log()]
    assert tt.snapshot() == jt.snapshot()


def test_check_convergence_returns_the_reference_summary():
    info = Info(np.array([3, 10]), np.array([1e-3, 1e-12]), np.array([False, True]))
    with pytest.warns(tt.ConvergenceWarning, match="2 solves"):
        st = tt.check_convergence(info, where="x")
    with pytest.warns(jt.ConvergenceWarning, match="2 solves"):
        sj = jt.check_convergence(info, where="x")
    assert st == sj
    with pytest.raises(tt.NonConvergedError):
        tt.check_convergence(info, on_fail="raise")


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _tree(tel, stream):
    tel.enable(jsonl=stream)
    root = tel.span_root("request", backend="csr", request_id=7)
    a = root.child("queue_wait")
    a.finish()
    b = root.child("dispatch", batch=2, padded=2)
    b.child("cache_lookup").finish()
    b.finish()
    root.child("dangling")
    with tel.span("driver", where="outer") as drv:
        with tel.span("inner"):
            tel.record_event("solve", "inner", wall_us=1.0, iterations=2)
    root.finish(outcome="ok", iters=3)
    return root, drv


def test_span_trees_and_rows_match_the_reference(tmp_path):
    rj, dj = _tree(jt, str(tmp_path / "j.jsonl"))
    rt, dt = _tree(tt, str(tmp_path / "t.jsonl"))

    def shape(d):
        return (d["name"], d["tags"], [shape(c) for c in d["children"]])

    assert shape(rt.to_dict()) == shape(rj.to_dict())
    # one trace id threads each tree; parents point at their parent's span
    for root in (rt, rj):
        d = root.to_dict()
        assert {c["trace_id"] for c in d["children"]} == {d["trace_id"]}
        assert all(c["parent_id"] == d["span_id"] for c in d["children"])
        assert root.children[-1].end_ns == root.end_ns  # open children closed
    rows = {n: [json.loads(line) for line in open(tmp_path / f"{n}.jsonl")] for n in "jt"}
    assert [_strip_ids(r) for r in rows["t"]] == [_strip_ids(r) for r in rows["j"]]
    ev_t, ev_j = tt.event_log()[-1], jt.event_log()[-1]
    assert ev_t["trace_id"] == dt.trace_id and ev_j["trace_id"] == dj.trace_id
    assert ev_t["span_id"] == dt.children[0].span_id
    span_keys = sorted(k for k in tt.snapshot()["histograms"] if k.startswith("span_us"))
    assert span_keys == sorted(k for k in jt.snapshot()["histograms"] if k.startswith("span_us"))
    counts = {k: tt.snapshot()["histograms"][k]["count"] for k in span_keys}
    assert counts == {k: jt.snapshot()["histograms"][k]["count"] for k in span_keys}


def test_disabled_spans_are_null_and_tags_drop_tensors():
    assert tt.span_root("r") is tt.NULL_SPAN and not tt.span_root("r")
    with tt.span("x") as sp:
        assert sp is tt.NULL_SPAN
    assert tt.flight_record(tt.NULL_SPAN, outcome="ok") is None
    tt.enable()
    root = tt.span_root("r", kept=np.int64(3), rho=torch.ones(3), scalar=torch.tensor(1.0))
    root.finish(extra=torch.zeros(()), label="x")
    assert root.tags == {"kept": 3, "label": "x"}
    rec = tt.flight_record(root, outcome="ok", u=torch.ones(2), iters=4)
    assert "u" not in rec and rec["iters"] == 4


def test_solver_spans_record_as_the_reference():
    """The port's solvers open the reference's spans (``sparse_solve``,
    ``matfree_solve``), which now record."""
    mj, mt = jc.unit_square_tri(4), tc.unit_square_tri(4)
    pj = jc.build_plan(jc.FunctionSpace(mj, jc.mesh.element_for_mesh(mj)))
    pt = tc.build_plan(tc.FunctionSpace(mt, tc.element_for_mesh(mt)), device="cpu")
    for tel, core, wf, plan in ((jt, jc, jwf, pj), (tt, tc, twf, pt)):
        tel.enable()
        k = core.assemble(plan, wf.diffusion(1.0) + wf.mass(1.0))
        f = core.assemble_rhs(plan, wf.source(1.0))
        core.sparse_solve(k, f, core.SolverSpec(method="cg"))
        core.matfree_solve(core.matfree_operator(plan, wf.diffusion(1.0) + wf.mass(1.0)), f)
        tel.disable()
    keys = {k for k in tt.snapshot()["histograms"] if k.startswith("span_us")}
    assert keys == {"span_us{span=sparse_solve}", "span_us{span=matfree_solve}"}
    assert keys == {k for k in jt.snapshot()["histograms"] if k.startswith("span_us")}


def test_concurrent_record_and_export_valid_jsonl(tmp_path):
    stream = str(tmp_path / "cc.jsonl")
    tt.enable(jsonl=stream)
    stop, errors = threading.Event(), []

    def recorder(k):
        i = 0
        while not stop.is_set():
            try:
                tt.record_event("solve", f"t{k}", wall_us=1.0, i=i)
                tt.histogram_observe("cc_us", float(i), thread=k)
                root = tt.span_root("cc")
                root.child("c").finish()
                root.finish()
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return
            i += 1

    def exporter():
        while not stop.is_set():
            try:
                tt.export_jsonl()
                tt.event_log()
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=recorder, args=(k,)) for k in range(3)]
    threads.append(threading.Thread(target=exporter))
    for t in threads:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join()
    assert not errors
    lines = open(stream).read().splitlines()
    assert lines and all("name" in json.loads(line) for line in lines)


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

def _observe_slo(tel):
    tel.enable()
    for v in [50.0] * 97 + [500.0] * 3:
        tel.histogram_observe("serve_e2e_us", v, backend="csr")
    for v in [500.0] * 50 + [50.0] * 50:
        tel.histogram_observe("serve_e2e_us", v, backend="matfree")
    tel.define_slo("csr", p99_us=100.0, backend="csr")
    tel.define_slo("recent", p99_us=100.0, window=50, backend="matfree")
    tel.define_slo("empty", p99_us=100.0, backend="none")
    tel.define_slo("all", p99_us=1000.0)


def _nan_safe(d):
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v) for k, v in d.items()}


def test_slo_attainment_and_burn_rate_match_the_reference():
    _observe_slo(jt)
    _observe_slo(tt)
    st, sj = tt.slo_status(), jt.slo_status()
    assert {k: _nan_safe(v) for k, v in st.items()} == {k: _nan_safe(v) for k, v in sj.items()}
    assert st["csr"]["attainment"] == pytest.approx(0.97)
    assert st["csr"]["burn_rate"] == pytest.approx(3.0) and not st["csr"]["met"]
    assert st["recent"]["met"] and st["empty"]["count"] == 0
    from repro.telemetry import slo as jslo

    from repro_torch.telemetry import slo as tslo

    assert [_nan_safe(r) for r in tslo.slo_rows()] == [_nan_safe(r) for r in jslo.slo_rows()]
    assert "slo" in tt.snapshot() and tt.defined_slos().keys() == jt.defined_slos().keys()


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_ring_bounded_ordered_and_dumped_as_the_reference(tmp_path):
    dumps = {}
    for tel, name in ((jt, "j"), (tt, "t")):
        tel.enable()
        path = str(tmp_path / f"{name}.jsonl")
        tel.configure_flight(capacity=4, path=path)
        root = tel.span_root("r")
        root.finish()
        for i in range(10):
            tel.flight_record(root, outcome="ok", seq=i)
        assert [r["seq"] for r in tel.flight_records()] == [6, 7, 8, 9]
        assert tel.flight_autodump("nonconverged") == 4
        assert tel.flight_dump(path, reason="manual") == 4
        dumps[name] = [json.loads(line) for line in open(path)]
        tel.configure_flight(capacity=256)
    def flat(row):
        row = _strip_ids(row)
        if row.get("trace"):
            row["trace"] = (row["trace"]["name"], row["trace"]["tags"], row["trace"]["children"])
        return row

    assert [flat(r) for r in dumps["t"]] == [flat(r) for r in dumps["j"]]
    assert [r.get("derived") for r in dumps["t"]] == [r.get("derived") for r in dumps["j"]]
    assert tt.snapshot()["counters"]["flight_dumps{reason=manual}"] == 1


def test_flight_autodump_needs_a_path():
    tt.enable()
    root = tt.span_root("r")
    root.finish()
    tt.flight_record(root, outcome="shed")
    assert tt.flight_autodump("shed") == 0 and len(tt.flight_records()) == 1


# ---------------------------------------------------------------------------
# report, capture
# ---------------------------------------------------------------------------

def test_report_renders_jax_rows_as_the_jax_report(tmp_path, capsys):
    stream = str(tmp_path / "run.jsonl")
    jt.enable(jsonl=stream)
    jt.record_solve("sparse_solve", Info(np.int64(12), np.float64(1e-11), np.bool_(True)),
                    method="cg", backend="csr", wall_us=40.0)
    jt.record_assembly("assemble", num_dofs=9, nnz=49, num_cells=8, form="diffusion")
    root = jt.span_root("serve.request")
    root.child("solve").finish()
    root.finish()
    jt.record_event("profile", "trace_captured", path="x")
    _observe_slo(jt)
    jt.export_jsonl(stream)
    rows = jreport.load_rows(stream)
    assert treport.load_rows(stream) == rows
    assert treport.render(rows) == jreport.render(rows)
    assert treport.slo_table(rows) == jreport.slo_table(rows)
    for argv in ([stream], [stream, "--slo"], [str(tmp_path / "missing.jsonl")]):
        rc_t = treport.main(argv)
        out_t = capsys.readouterr()
        rc_j = jreport.main(argv)
        out_j = capsys.readouterr()
        assert (rc_t, out_t.out) == (rc_j, out_j.out)


def test_capture_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with tt.enabled():
        with tt.capture(d):
            with tt.annotate("tg.test"):
                torch.ones(64) @ torch.ones((64, 8))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(os.path.join(d, files[0])))["traceEvents"]
    assert any(ev.get("name") == "tg.test" for ev in events)
    assert any(e["kind"] == "profile" and e["path"] == d for e in tt.event_log())


# ---------------------------------------------------------------------------
# the eager meaning of a trace
# ---------------------------------------------------------------------------

def test_entry_builds_count_as_traces_and_release_with_the_caches():
    """``n_core_traces`` / ``n_matfree_traces`` count the first assembly or
    operator build of each (plan, form signature), as the reference's
    counters count jit traces: value-only updates do not grow them, and
    ``jit_trace_total`` agrees.  ``clear_assembly_caches`` drops the
    records (the next build counts again) and the device mirrors."""
    tt.enable()
    mesh = tc.unit_square_tri(7)
    plan = tc.build_plan(tc.FunctionSpace(mesh, tc.element_for_mesh(mesh)), device="cpu")
    rho = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 2.0, mesh.num_cells))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(plan.num_dofs))
    core0, mf0 = tc.n_core_traces(), tc.n_matfree_traces()
    t_core0, t_mf0 = tt.jit_trace_total("assembly"), tt.jit_trace_total("matfree")
    k = tc.assemble(plan, twf.diffusion(rho))
    k.matvec(x)
    tc.matfree_operator(plan, twf.diffusion(rho)).matvec(x)
    assert (tc.n_core_traces() - core0, tc.n_matfree_traces() - mf0) == (1, 1)
    # value-only updates build nothing
    tc.assemble(plan, twf.diffusion(2.0 * rho))
    tc.matfree_operator(plan, twf.diffusion(3.0 * rho))
    tc.assemble_batched(plan, twf.diffusion(rho), leaves_batch=(torch.stack([rho, rho]), None))
    tc.assemble_batched(plan, twf.diffusion(rho), leaves_batch=(torch.stack([rho, rho]), None))
    assert (tc.n_core_traces() - core0, tc.n_matfree_traces() - mf0) == (2, 1)
    assert tt.jit_trace_total("assembly") - t_core0 == 2
    assert tt.jit_trace_total("matfree") - t_mf0 == 1
    cache = {k_: v for k_, v in tt.snapshot()["counters"].items()
             if k_.startswith("cache_lookups")}
    assert cache["cache_lookups{kind=assembly_signature,outcome=miss}"] == 2
    assert cache["cache_lookups{kind=assembly_signature,outcome=hit}"] == 2
    assert k.pattern._staged and plan.vec_reduce._rows is not None
    tc.clear_assembly_caches()
    assert not k.pattern._staged and k.pattern._ell is None
    assert plan.vec_reduce._rows is None and not plan.signatures
    tc.assemble(plan, twf.diffusion(rho))
    assert tc.n_core_traces() - core0 == 3
    k.matvec(x)
    tc.clear_device_mirrors()
    assert not k.pattern._staged
    # the reference's counters keep the same zero-retrace property
    mj = jc.unit_square_tri(7)
    pj = jc.build_plan(jc.FunctionSpace(mj, jc.mesh.element_for_mesh(mj)))
    before = jc.assembly.n_core_traces()
    jc.assemble(pj, jwf.diffusion(rho.numpy()))
    mid = jc.assembly.n_core_traces()
    jc.assemble(pj, jwf.diffusion(2.0 * rho.numpy()))
    assert mid - before >= 1 and jc.assembly.n_core_traces() == mid


def test_builds_record_nothing_with_telemetry_off():
    """With telemetry off an assembly, a batched assembly and a matrix-free
    build record no signature and count no trace; the same calls once it
    is on count one each, as the first builds."""
    mesh = tc.unit_square_tri(5)
    plan = tc.build_plan(tc.FunctionSpace(mesh, tc.element_for_mesh(mesh)), device="cpu")
    rho = torch.as_tensor(np.random.default_rng(2).uniform(0.5, 2.0, mesh.num_cells))

    def build():
        tc.assemble(plan, twf.diffusion(rho))
        tc.assemble_batched(plan, twf.diffusion(rho), leaves_batch=(torch.stack([rho, rho]), None))
        tc.matfree_operator(plan, twf.diffusion(rho))

    core0, mf0 = tc.n_core_traces(), tc.n_matfree_traces()
    build()
    assert (tc.n_core_traces() - core0, tc.n_matfree_traces() - mf0) == (0, 0)
    assert not plan.signatures and tt.snapshot()["counters"] == {}
    tt.enable()
    build()
    build()
    assert (tc.n_core_traces() - core0, tc.n_matfree_traces() - mf0) == (2, 1)
    assert tt.jit_trace_total() == 3 and len(plan.signatures) == 3
