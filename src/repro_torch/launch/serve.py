"""Serving driver: run the :mod:`repro_torch.serve` solve service under a
synthetic open-loop load.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 64 --rate 500 \\
        --resolution 24 --backend matfree --window-ms 5
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The torch port of ``repro.launch.serve``, with its flags and ``--device``
(default: the CUDA card).  Builds the canonical heterogeneous-coefficient
Poisson workload on one shared plan (:func:`repro_torch.serve.poisson_requests`),
warms up and pins the executable cache for the expected batch buckets,
then drives the :class:`~repro_torch.serve.service.SolveService` with
Poisson arrivals at the offered ``--rate``.  Latency percentiles, queue
waits, batch sizes and executable-cache hit rates all come out of
:mod:`repro_torch.telemetry` (``--jsonl`` streams the metric rows in
``BENCH_JSON`` format).

``--smoke`` is the CI path: a tiny mesh, two waves, hard assertions that
every request is answered ``ok``, that no cache entry is built after
warmup, and that a served answer matches a sequential ``sparse_solve``
within 1e-12.
"""

from __future__ import annotations

import argparse
import sys


def _check(cond: bool, what: str) -> None:
    """A hard check of the smoke (kept under ``python -O``, unlike assert)."""
    if not cond:
        raise RuntimeError(f"serve smoke failed: {what}")


def _run_smoke(device) -> int:
    from .. import serve, telemetry
    from ..core import assemble, sparse_solve

    telemetry.enable()
    svc = serve.SolveService(window=0.002)
    reqs = serve.poisson_requests(n_requests=6, resolution=8, device=device)
    # a wave may split across admission windows → warm every bucket ≤ 8
    svc.warmup(reqs[0], batch_sizes=(1, 2, 4, 8))
    base_traces = telemetry.jit_trace_total("serve")

    with svc:
        report = serve.open_loop_load(svc, reqs, rate=2000.0)
        report2 = serve.open_loop_load(
            svc, serve.poisson_requests(n_requests=6, resolution=8, seed=1, device=device),
            rate=2000.0)
    _check(report.ok == 6 and report2.ok == 6, f"not every request answered ok: "
           f"{report}, {report2}")
    retraces = telemetry.jit_trace_total("serve") - base_traces
    _check(retraces == 0, f"warmup did not cover the smoke waves: {retraces} entries built")

    # answer correctness vs one sequential reference solve
    rq = reqs[0]
    k = rq.bc.apply_matrix_only(assemble(rq.plan, rq.form))
    u_ref = sparse_solve(k, rq.rhs * rq.bc.free_mask, rq.spec)
    pend = svc.submit(rq)
    svc.drain()
    u = pend.result()
    _check(u.device == rq.plan.device, f"answer on {u.device}, plan on {rq.plan.device}")
    err = float((u - u_ref).abs().max())
    _check(err < 1e-12, f"served answer diverges from reference: {err:.3e}")

    print(f"serve smoke OK on {rq.plan.device}: {report.ok + report2.ok + 1} requests, "
          f"0 entries built after warmup, parity {err:.1e}, "
          f"e2e p99 {report2.e2e_p99_us:.0f}us")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI run with hard correctness assertions")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card)")
    ap.add_argument("--requests", type=int, default=32, help="requests per wave")
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--rate", type=float, default=500.0,
                    help="offered load [requests/s], Poisson arrivals")
    ap.add_argument("--resolution", type=int, default=16, help="unit-square mesh resolution")
    ap.add_argument("--backend", default="csr", choices=("csr", "matfree"))
    ap.add_argument("--window-ms", type=float, default=2.0, help="admission batching window")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--queue-limit", type=int, default=1024)
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request admission deadline [s]")
    ap.add_argument("--jsonl", default=None,
                    help="append telemetry metric rows (BENCH_JSON) here")
    args = ap.parse_args(argv)

    if args.smoke:
        return _run_smoke(args.device)

    from .. import serve, telemetry

    telemetry.enable(jsonl=args.jsonl)
    svc = serve.SolveService(window=args.window_ms * 1e-3, max_batch=args.max_batch,
                             queue_limit=args.queue_limit)
    template = serve.poisson_requests(n_requests=1, resolution=args.resolution,
                                      backend=args.backend, device=args.device)[0]
    top = min(serve.pad_bucket(args.requests), args.max_batch)
    buckets = sorted({min(1 << i, top) for i in range(top.bit_length())})
    print(f"warmup: buckets {buckets} on resolution {args.resolution} ({args.backend}, "
          f"{template.plan.device})")
    svc.warmup(template, batch_sizes=buckets)

    with svc:
        for wave in range(args.waves):
            reqs = serve.poisson_requests(
                n_requests=args.requests, resolution=args.resolution, backend=args.backend,
                timeout=args.timeout, seed=wave, device=args.device)
            report = serve.open_loop_load(svc, reqs, rate=args.rate, seed=wave)
            print(f"wave {wave}: ok={report.ok} shed={report.shed} "
                  f"expired={report.expired} "
                  f"p50={report.e2e_p50_us:.0f}us "
                  f"p99={report.e2e_p99_us:.0f}us "
                  f"batch≈{report.batch_size_mean:.1f} "
                  f"hit-rate={report.cache_hit_rate:.2f} "
                  f"throughput={report.throughput:.0f}/s")
    if args.jsonl:
        rows = telemetry.export_jsonl(args.jsonl)
        print(f"exported {len(rows)} metric rows to {args.jsonl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
