"""Torch port parity for the solve service (A15): the properties of
``tests/test_serve.py`` on ``device="cpu"`` — buckets, admission keys,
expiry, shedding, the non-converged policies, eviction and pinning, the
worker thread, ``stop`` draining, span segments summing to e2e, no trace
with telemetry off, the error paths' flight dumps — plus the padding rule
(the bucket assembled, only the real rows solved); the slice as a whole
against ``repro.serve`` (the same seeded wave through both services'
``drain``, u per request 1e-10, iterations ±1, the same segment names);
the JAX numbers that ``chip_smoke.py``'s ``serve`` phase pins; and
``python -m repro_torch.launch.serve --smoke --device cpu``."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro import serve as js  # noqa: E402
from repro import telemetry as jt  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import serve, telemetry  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DeadlineExpired,
    ExecutableCache,
    NonConverged,
    Overloaded,
    SolveService,
    admission_key,
    pad_bucket,
)
from repro_torch.serve import cache as serve_cache  # noqa: E402
from repro_torch.telemetry import ConvergenceWarning  # noqa: E402
from repro_torch.telemetry import spans as tspans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RES = 6  # tiny shared Poisson workload (plan memoized inside serve.client)


def _wave(n, **kw):
    return serve.poisson_requests(n_requests=n, resolution=RES, device="cpu", **kw)


def _reset():
    telemetry.disable()
    telemetry.reset()
    telemetry.clear_events()
    telemetry.clear_flight()
    tspans._FLIGHT_PATH = None


@pytest.fixture(autouse=True)
def _clean_telemetry():
    _reset()
    yield
    _reset()


def _sequential(rq):
    """The request solved on its own, as the reference's tests solve it."""
    f = rq.rhs * rq.bc.free_mask
    if rq.backend == "csr":
        k = rq.bc.apply_matrix_only(tc.assemble(rq.plan, rq.form))
        return tc.sparse_solve(k, f, rq.spec, return_info=True)
    op = tc.matfree_operator(rq.plan, rq.form).condensed(rq.bc)
    return tc.matfree_solve(op, f, rq.spec, return_info=True)


# ---------------------------------------------------------------------------
# units: pad buckets, compatibility keys, the default device
# ---------------------------------------------------------------------------

def test_pad_bucket():
    assert [pad_bucket(b) for b in (1, 2, 3, 5, 8, 9, 16)] == [1, 2, 4, 8, 8, 16, 16]
    with pytest.raises(ValueError):
        pad_bucket(0)


def test_admission_key_compatibility():
    a, b = _wave(2)
    assert admission_key(a) == admission_key(b)
    assert not torch.equal(a.leaves[0], b.leaves[0])
    assert all(leaf.device.type == "cpu" and leaf.dtype == torch.float64 for leaf in a.leaves)
    assert admission_key(dataclasses.replace(a, tol=1e-8)) != admission_key(a)
    assert admission_key(dataclasses.replace(a, maxiter=7)) != admission_key(a)
    assert admission_key(_wave(1, backend="matfree")[0]) != admission_key(a)
    with pytest.raises(ValueError, match="unknown backend"):
        dataclasses.replace(a, backend="ell")


def test_requests_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.poisson_requests(n_requests=1, resolution=RES)


# ---------------------------------------------------------------------------
# parity: one admission batch vs B sequential solves; the padding rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["csr", "matfree"])
def test_batched_requests_match_sequential(backend):
    reqs = _wave(5, backend=backend)  # 5 pads to bucket 8
    svc = SolveService(window=0.0)
    pend = [svc.submit(r) for r in reqs]
    assert not pend[0].done()
    assert svc.drain() == 5
    for rq, p in zip(reqs, pend):
        resp = p.response()
        assert resp.ok and resp.batch_size == 5 and resp.info.converged
        u_ref, info = _sequential(rq)
        assert resp.info.iters == info.iters
        assert float((p.result() - u_ref).abs().max()) < 1e-12


@pytest.mark.parametrize("backend", ["csr", "matfree"])
def test_padding_rule_solves_only_the_real_rows(backend):
    """5 requests in bucket 8: the entry stacks and assembles 8 rows and
    solves 5 (one solve event of 5 instances)."""
    reqs = _wave(5, backend=backend)
    svc = SolveService(window=0.0)
    pend = [svc.submit(r) for r in reqs]
    with telemetry.enabled():
        svc.drain()
    batched = [e for e in telemetry.event_log() if e["name"].endswith("_solve_batched")]
    assert len(batched) == 1 and batched[0]["n_solves"] == 5
    dispatch = [e for e in telemetry.event_log() if e["name"] == "serve.dispatch"]
    assert dispatch[0]["padded"] == 8 and dispatch[0]["batch"] == 5
    assert all(p.response().ok for p in pend)


def test_mixed_backends_split_into_groups():
    reqs = _wave(2) + _wave(2, backend="matfree")
    svc = SolveService(window=0.0)
    pend = [svc.submit(r) for r in reqs]
    assert svc.drain() == 4
    resps = [p.response() for p in pend]
    assert all(r.ok for r in resps) and [r.batch_size for r in resps] == [2, 2, 2, 2]
    assert float((resps[0].u - resps[2].u).abs().max()) < 1e-9


def test_max_batch_chunks_one_group():
    svc = SolveService(window=0.0, max_batch=2)
    pend = [svc.submit(r) for r in _wave(5)]
    assert svc.drain() == 5
    assert [p.response().batch_size for p in pend] == [2, 2, 2, 2, 1]
    assert all(p.response().ok for p in pend)


# ---------------------------------------------------------------------------
# QoS paths: deadline, shedding, non-convergence policy, failure
# ---------------------------------------------------------------------------

def test_deadline_expired_path():
    svc = SolveService(window=0.0)
    pend = [svc.submit(r) for r in _wave(2, timeout=1e-3)]
    time.sleep(0.01)  # let both deadlines pass while queued
    assert svc.drain() == 2
    for p in pend:
        assert p.response().status == "expired" and p.response().u is None
        with pytest.raises(DeadlineExpired):
            p.result()


def test_overload_shedding():
    svc = SolveService(window=0.0, queue_limit=2)
    pend = [svc.submit(r) for r in _wave(4)]
    assert pend[2].done() and pend[3].done()
    for p in pend[2:]:
        assert p.response().status == "overloaded"
        with pytest.raises(Overloaded):
            p.result()
    svc.drain()
    assert all(p.response().ok for p in pend[:2])


def test_nonconverged_raise_policy():
    reqs = [dataclasses.replace(r, maxiter=3) for r in _wave(2)]
    with telemetry.enabled(on_nonconverged="raise"):
        svc = SolveService(window=0.0)
        pend = [svc.submit(r) for r in reqs]
        svc.drain()
    for p in pend:
        resp = p.response()
        assert resp.status == "nonconverged" and resp.u is None and not resp.info.converged
        with pytest.raises(NonConverged):
            p.result()


def test_nonconverged_warn_policy_answers_ok():
    reqs = [dataclasses.replace(r, maxiter=3) for r in _wave(2)]
    with telemetry.enabled(on_nonconverged="warn"):
        svc = SolveService(window=0.0)
        pend = [svc.submit(r) for r in reqs]
        with pytest.warns(ConvergenceWarning):
            svc.drain()
    assert all(p.response().ok and p.response().u is not None for p in pend)


# ---------------------------------------------------------------------------
# executable cache: warmup → no entry built, LRU eviction, pinning
# ---------------------------------------------------------------------------

def test_no_entry_built_and_full_hit_rate_across_waves():
    with telemetry.enabled():
        svc = SolveService(window=0.0)
        svc.warmup(_wave(1)[0], batch_sizes=(4,))
        base = telemetry.jit_trace_total("serve")
        assert base == 1
        hits0, miss0 = svc.cache.hits, svc.cache.misses
        for w in range(3):
            pend = [svc.submit(r) for r in _wave(4, seed=w + 1)]
            svc.drain()
            assert all(p.response().ok and p.response().cache_hit for p in pend)
        assert telemetry.jit_trace_total("serve") == base
        assert svc.cache.misses == miss0 and svc.cache.hits - hits0 == 3


def test_cache_eviction_and_pinning():
    base = _wave(1)[0]
    variants = [dataclasses.replace(base, tol=10.0 ** -(6 + i)) for i in range(4)]
    keys = [admission_key(v) for v in variants]
    cache = ExecutableCache(capacity=2)
    cache.pin(keys[0], 1)
    for v, k in zip(variants, keys):
        cache.get(k, 1, v)
    # 4 entries, 1 pinned, capacity 2 unpinned -> keys[1] (LRU unpinned) out
    assert len(cache) == 3 and cache.evictions == 1
    assert cache.get(keys[0], 1, variants[0])[1], "pinned entry must survive eviction"
    assert not cache.get(keys[1], 1, variants[1])[1], "LRU unpinned entry was not evicted"
    cache.unpin(keys[0], 1)
    cache._evict()
    assert cache.hit_rate() == pytest.approx(1 / 6)


# ---------------------------------------------------------------------------
# threaded dispatch path (the production lifecycle)
# ---------------------------------------------------------------------------

def test_worker_thread_end_to_end():
    reqs = _wave(3)
    svc = SolveService(window=0.001)
    early = svc.submit(reqs[0])  # queued before start(): dispatched on the first window
    with svc:
        pend = [svc.submit(r) for r in reqs[1:]]
        us = [p.result(timeout=60.0) for p in [early, *pend]]
    assert all(u.shape == reqs[0].rhs.shape for u in us)
    assert float((us[0] - _sequential(reqs[0])[0]).abs().max()) < 1e-12


def test_concurrent_submitters_lose_no_request():
    """Eight client threads submit to a running worker with a short switch
    interval: every request is answered ok, and the counters, taken under
    the registry lock, count each once."""
    reqs = _wave(32, seed=7)
    pend, lock = [], threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.enabled(), SolveService(window=0.0005, max_batch=8) as svc:
            def client(k):
                for r in reqs[k::8]:
                    p = svc.submit(r)
                    with lock:
                        pend.append(p)

            threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            resps = [p.response(timeout=60) for p in pend]
            snap = telemetry.snapshot()
    finally:
        sys.setswitchinterval(interval)
    assert len(resps) == 32 and all(r.ok for r in resps)
    assert snap["counters"]["serve_requests{outcome=ok}"] == 32
    assert snap["histograms"]["serve_e2e_us{backend=csr}"]["count"] == 32


def test_stop_drains_pending_requests():
    svc = SolveService(window=0.0)
    svc.start()
    pend = [svc.submit(r) for r in _wave(2)]
    svc.stop()
    assert all(p.done() and p.response().ok for p in pend)


def test_solve_convenience_inline():
    rq = _wave(1)[0]
    assert SolveService(window=0.0).solve(rq).shape == rq.rhs.shape


# ---------------------------------------------------------------------------
# request tracing: span trees, flight recorder, attribution gauges
# ---------------------------------------------------------------------------

def test_response_span_tree_segments_sum_to_e2e():
    with telemetry.enabled():
        svc = SolveService(window=0.0)
        svc.warmup(_wave(1)[0], batch_sizes=(4,))
        pend = [svc.submit(r) for r in _wave(4, seed=3)]
        svc.drain()
    for p in pend:
        resp = p.response()
        tree = resp.trace
        assert resp.ok and tree["name"] == "serve.request"
        assert tree["tags"]["outcome"] == "ok"
        assert tree["tags"]["request_id"] == p.request.request_id
        seg = resp.span_segments_us
        assert list(seg) == ["queue_wait", "dispatch", "solve", "slice"]
        assert sum(seg.values()) == pytest.approx(1e6 * resp.e2e_s, rel=0.05)
        assert {c["trace_id"] for c in tree["children"]} == {tree["trace_id"]}
    assert len({p.response().trace["trace_id"] for p in pend}) == 4


def test_disabled_responses_carry_no_trace():
    svc = SolveService(window=0.0)
    pend = [svc.submit(r) for r in _wave(2)]
    svc.drain()
    for p in pend:
        assert p.response().ok and p.response().trace is None
        assert p.response().span_segments_us == {}
    assert telemetry.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_error_paths_carry_traces_and_flight_dumps(tmp_path, monkeypatch):
    flight = str(tmp_path / "flight.jsonl")
    with telemetry.enabled(on_nonconverged="raise"):
        telemetry.configure_flight(capacity=32, path=flight)
        svc = SolveService(window=0.0)
        pend = [svc.submit(r) for r in _wave(1, timeout=1e-3)]
        time.sleep(0.01)
        svc.drain()
        assert pend[0].response().trace["tags"]["outcome"] == "expired"
        svc2 = SolveService(window=0.0, queue_limit=1)
        shed = [svc2.submit(r) for r in _wave(2)][1]
        assert shed.response().trace["tags"]["outcome"] == "shed"
        svc2.drain()
        p = svc2.submit(dataclasses.replace(_wave(1)[0], maxiter=3))
        svc2.drain()
        assert p.response().status == "nonconverged"
        assert p.response().trace["tags"]["outcome"] == "nonconverged"

        def broken(template):
            def run(plan, leaves, rhs, n_real):
                raise FloatingPointError("entry failed")
            return run

        monkeypatch.setattr(serve_cache, "_build_executable", broken)
        svc3 = SolveService(window=0.0)
        p = svc3.submit(_wave(1)[0])
        svc3.drain()
        assert p.response().status == "failed"
        assert p.response().trace["tags"]["error"] == "FloatingPointError"
        with pytest.raises(FloatingPointError):
            p.result()
    rows = [json.loads(line) for line in open(flight)]
    reasons = {r["reason"] for r in rows if r["kind"] == "flight_dump"}
    assert {"expired", "shed", "nonconverged", "failed"} <= reasons
    outcomes = {r.get("outcome") for r in rows if r["kind"] == "flight"}
    assert {"expired", "shed", "nonconverged", "failed"} <= outcomes


def test_queue_depth_gauge_sampled_at_drain():
    with telemetry.enabled():
        svc = SolveService(window=0.0)
        [svc.submit(r) for r in _wave(3)]
        svc.drain()
        snap = telemetry.snapshot()
    assert snap["gauges"]["serve_queue_depth"] == 3
    assert snap["histograms"]["serve_queue_depth"]["max"] == 3


def test_compile_and_memory_attribution_gauges():
    """A cache miss records its first call's wall; a CPU device records no
    device-memory gauge (the reference's CPU devices report none)."""
    with telemetry.enabled():
        svc = SolveService(window=0.0)
        pend = [svc.submit(r) for r in _wave(2)]
        svc.drain()
        assert all(p.response().ok for p in pend)
        snap = telemetry.snapshot()
        compile_hists = [k for k in snap["histograms"] if k.startswith("serve_compile_us")]
        assert compile_hists and snap["histograms"][compile_hists[0]]["count"] == 1
        assert any(k.startswith("serve_exec_compile_us") for k in snap["gauges"])
        assert snap["gauges"]["serve_exec_entries"] == len(svc.cache)
        assert not any(k.startswith("device_") for k in snap["gauges"])
        [svc.submit(r) for r in _wave(2, seed=5)]
        svc.drain()
        assert telemetry.snapshot()["histograms"][compile_hists[0]]["count"] == 1


def test_load_report_span_coverage():
    with telemetry.enabled():
        reqs = _wave(6)
        with SolveService(window=0.002) as svc:
            svc.warmup(reqs[0], batch_sizes=(1, 4))
            report = serve.open_loop_load(svc, reqs, rate=2000.0)
    assert report.ok == 6
    assert report.span_coverage == pytest.approx(1.0, rel=0.05)
    assert report.queue_depth_max >= 1


# ---------------------------------------------------------------------------
# the slice against repro.serve; chip_smoke's pins; the launcher
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_wave(backend, n=5, resolution=RES):
    """The JAX service's answers to the seeded wave: (iterations, u, the
    top-level segment names) per request."""
    with jt.enabled():
        reqs = js.poisson_requests(n_requests=n, resolution=resolution, backend=backend,
                                   seed=0)
        svc = js.SolveService(window=0.0)
        pend = [svc.submit(r) for r in reqs]
        svc.drain()
    jt.reset()
    return [(int(p.response().info.iters), np.asarray(p.response().u),
             list(p.response().span_segments_us)) for p in pend]


@pytest.mark.parametrize("backend", ["csr", "matfree"])
def test_service_matches_jax(backend):
    """The same seeded wave through ``repro.serve`` and the port: u per
    request to 1e-10, iterations ±1, the same segment names."""
    want = _jax_wave(backend)
    with telemetry.enabled():
        svc = SolveService(window=0.0)
        pend = [svc.submit(r) for r in _wave(5, backend=backend, seed=0)]
        svc.drain()
    for p, (iters, u, names) in zip(pend, want):
        resp = p.response()
        assert resp.ok and abs(resp.info.iters - iters) <= 1
        np.testing.assert_allclose(resp.u.numpy(), u, atol=1e-10, rtol=0)
        assert list(resp.span_segments_us) == names == ["queue_wait", "dispatch", "solve",
                                                         "slice"]


def test_chip_smoke_serve_pins_match_jax():
    """``chip_smoke.py`` holds the card to JAX numbers (the card machine has
    no JAX): each request's CG iterations and max u at the reference size.
    The JAX package meets them exactly, the port at the card's gates."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    pins = chip_smoke.JAX_SERVE
    assert (pins["resolution"], pins["n_requests"]) == (RES, 5)
    for backend in ("csr", "matfree"):
        got_j = [(iters, float(u.max())) for iters, u, _ in _jax_wave(backend)]
        assert got_j == [tuple(p) for p in pins[backend]]
        svc = SolveService(window=0.0)
        pend = [svc.submit(r) for r in _wave(5, backend=backend, seed=0)]
        svc.drain()
        for p, (iters, max_u) in zip(pend, pins[backend]):
            assert p.response().batch_size == 5
            assert abs(p.response().info.iters - iters) <= 1
            assert abs(float(p.response().u.max()) - max_u) <= 1e-10


def test_launch_serve_smoke_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "serve smoke OK on cpu" in out.stdout
