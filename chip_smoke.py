#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA machine

Phases, one JSON line each:

1. device — the card (``nvidia-smi`` name and power limit), torch/CUDA
   versions, and the time to build the CUDA kernels from ``src/`` with nvcc;
2. kernels_small — every kernel against its plain PyTorch version on the
   card at ragged shapes, float32 and float64;
3. reference — ``PoissonProblem(unit_cube_tet(n)).solve(f=1.0)`` for
   n = 8, 16, 24 against the JAX package's numbers (DoFs and nnz exact,
   CG iterations within ±1, max u within 1e-6), and against a direct
   scipy solve at n = 8;
4. main_path — the 3D Poisson solver at n = 64 (274,625 DoFs, 1,572,864
   tetrahedra): set-up, assembly, CG solve, then the quickstart's
   variable-coefficient solve; every kernel must have launched, the
   residual must agree with one computed by scipy on the host, and
   max u must lie in [0.0555, 0.0565];
5. profile — a torch.profiler trace of one n = 64 solve: device busy time
   against wall time;
6. kernels_main — each kernel at the shapes of the main path: error
   against its plain version, median device time over 25 launches, the
   plain version's and one PyTorch library call's time, and the bound;
7. second_entry — ``AdvectionDiffusionProblem(unit_square_tri(256))``
   with BiCGSTAB.

Then the card's ``nvidia-smi`` line, the ``kernels`` summary line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; with no CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The JAX package's numbers for PoissonProblem(unit_cube_tet(n)).solve(f=1.0,
# tol=1e-10), measured on the CPU: n -> (DoFs, nnz, CG iterations, max u).
JAX_REFERENCE = {
    8: (729, 9_097, 16, 0.054918),
    16: (4_913, 66_961, 38, 0.055881),
    24: (15_625, 219_673, 57, 0.056065),
}
MAIN_N = 64

# Pallas TPU kernel each CUDA kernel replaces, and where its source lives
KERNELS = {
    "local_stiffness_p1": ("src/repro/kernels/local_assembly.py:101",
                           "src/repro_torch/kernels/csrc/local_assembly.cu"),
    "seg_reduce": ("src/repro/kernels/seg_reduce.py:51",
                   "src/repro_torch/kernels/csrc/seg_reduce.cu"),
    "spmv_ell": ("src/repro/kernels/spmv_ell.py:186",
                 "src/repro_torch/kernels/csrc/spmv_ell.cu"),
    "galerkin_residual_ell": ("src/repro/kernels/spmv_ell.py:195",
                              "src/repro_torch/kernels/csrc/spmv_ell.cu"),
}
# flops of one element of the P1 Map kernel (closed-form adjugate + G Gᵀ)
P1_FLOPS = {2: 57, 3: 168}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str) -> tuple[float, float]:
    """(memory bytes/s, float64 flop/s) from NVIDIA's data sheets."""
    if "H200" in name:
        return 4.8e12, 34e12
    if "PCIe" in name:
        return 2.0e12, 26e12
    if "NVL" in name:
        return 3.9e12, 30e12
    return 3.35e12, 34e12  # H100 SXM


def time_ms(fn, reps: int = 25) -> float:
    """Median device time of ``fn`` over ``reps`` launches, from CUDA
    events around each; the card is kept busy while the host enqueues, so
    host overhead between launches does not enter the times."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got − want|, max(1, max |want|)): an error and its scale."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    return err, scale


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


TOL = {torch.float32: 2e-4, torch.float64: 1e-12}


def random_simplices(rng, e, d, dtype):
    ident = np.concatenate([np.zeros((1, d)), np.eye(d)], axis=0)
    x = rng.normal(size=(e, 1, d)) + ident[None] + 0.15 * rng.normal(size=(e, d + 1, d))
    return torch.as_tensor(x, dtype=dtype, device="cuda")


def phase_kernels_small():
    from repro_torch.kernels import (galerkin_residual_ell, local_stiffness_p1, seg_reduce,
                                     spmv_ell)
    from repro_torch.kernels.ref import (galerkin_residual_ell_ref, local_stiffness_p1_ref,
                                         seg_reduce_ref, spmv_ell_ref)
    from repro_torch.kernels.seg_reduce import ReduceTable

    worst = {name: 0.0 for name in KERNELS}
    cases = 0
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for i, n in enumerate((1, 7, 129, 5000)):
            rng = np.random.default_rng(100 + n)
            for d in (2, 3):
                coords = random_simplices(rng, n, d, dtype)
                rho = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=dtype, device="cuda")
                err, scale = max_err(local_stiffness_p1(coords, rho),
                                     local_stiffness_p1_ref(coords, rho))
                check(err <= tol * scale, f"local_stiffness_p1 d={d} E={n} {dtype}: {err}")
                worst["local_stiffness_p1"] = max(worst["local_stiffness_p1"], err / scale)
                cases += 1

            rows = rng.integers(0, n, size=3 * n + 1)
            perm = np.argsort(rows, kind="stable")
            table = ReduceTable(perm, rows[perm], rows, n, "cuda")
            src = torch.as_tensor(rng.normal(size=rows.shape[0]), dtype=dtype, device="cuda")
            err, scale = max_err(seg_reduce(src, table), seg_reduce_ref(src, table.rows, n))
            check(err <= tol * scale, f"seg_reduce rows={n} {dtype}: {err}")
            worst["seg_reduce"] = max(worst["seg_reduce"], err / scale)
            cases += 1

            width = (1, 7, 15, 40)[i]
            vals = rng.normal(size=(n, width))
            vals[rng.uniform(size=vals.shape) < 0.3] = 0.0  # zero slots, any column
            vals = torch.as_tensor(vals, dtype=dtype, device="cuda")
            cols = torch.as_tensor(rng.integers(0, n, size=(n, width)), dtype=torch.int32,
                                   device="cuda")
            x = torch.as_tensor(rng.normal(size=n), dtype=dtype, device="cuda")
            f = torch.as_tensor(rng.normal(size=n), dtype=dtype, device="cuda")
            err, scale = max_err(spmv_ell(vals, cols, x), spmv_ell_ref(vals, cols, x))
            check(err <= tol * scale, f"spmv_ell N={n} L={width} {dtype}: {err}")
            worst["spmv_ell"] = max(worst["spmv_ell"], err / scale)
            err, scale = max_err(galerkin_residual_ell(vals, cols, x, f),
                                 galerkin_residual_ell_ref(vals, cols, x, f))
            check(err <= tol * scale, f"galerkin_residual_ell N={n} L={width} {dtype}: {err}")
            worst["galerkin_residual_ell"] = max(worst["galerkin_residual_ell"], err / scale)
            cases += 2
    emit({"phase": "kernels_small", "cases": cases, "tolerance": "max|err| <= tol * "
          "max(1, max|plain|), tol 2e-4 (float32) / 1e-12 (float64)",
          "worst_scaled_err": worst})


def phase_reference():
    import scipy.sparse.linalg as spla

    from repro_torch.core import unit_cube_tet
    from repro_torch.fem import PoissonProblem

    rows = []
    for n, (dofs, nnz, iters, umax) in JAX_REFERENCE.items():
        prob = PoissonProblem(unit_cube_tet(n), device="cuda")
        res = prob.solve(f=1.0)
        got_umax = float(res.u.max())
        row = {"n": n, "dofs": prob.space.num_dofs, "nnz": prob.plan.nnz,
               "iters": res.iters, "jax_iters": iters, "max_u": got_umax,
               "jax_max_u": umax, "residual": res.residual, "converged": res.converged}
        check(prob.space.num_dofs == dofs and prob.plan.nnz == nnz, f"n={n}: sizes {row}")
        check(abs(res.iters - iters) <= 1, f"n={n}: iterations {row}")
        check(abs(got_umax - umax) <= 1e-6, f"n={n}: max u {row}")
        check(res.converged, f"n={n}: not converged")
        if n == 8:
            k, load = prob.assemble(f=1.0)
            u_direct = spla.spsolve(k.to_scipy().tocsc(), load.cpu().numpy())
            row["err_vs_scipy_direct"] = float(np.abs(u_direct - res.u.cpu().numpy()).max())
            check(row["err_vs_scipy_direct"] <= 1e-8, f"n=8: against scipy {row}")
        rows.append(row)
    emit({"phase": "reference", "rows": rows})


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_main_path():
    from repro_torch import kernels
    from repro_torch.core import unit_cube_tet
    from repro_torch.fem import PoissonProblem

    kernels.reset_launches()
    prob, setup_s = timed(lambda: PoissonProblem(unit_cube_tet(MAIN_N), device="cuda"))
    (k, load), assemble_s = timed(lambda: prob.assemble(f=1.0))
    res, solve_s = timed(lambda: prob.solve(f=1.0))
    res_rho, solve_rho_s = timed(lambda: prob.solve(rho=lambda x: 1.0 + x[..., 0], f=1.0))
    launches = dict(kernels.LAUNCHES)

    a = k.to_scipy()
    u = res.u.cpu().numpy()
    f = load.cpu().numpy()
    r_host, f_norm = float(np.linalg.norm(a @ u - f)), float(np.linalg.norm(f))
    rel_host = r_host / f_norm
    max_u = float(res.u.max())
    out = {
        "phase": "main_path", "n": MAIN_N, "dofs": prob.space.num_dofs,
        "elements": prob.mesh.num_cells, "nnz": prob.plan.nnz,
        "ell_width": k.pattern.ell_layout()[2], "iters": res.iters,
        "residual": res.residual, "residual_scipy_host": rel_host, "max_u": max_u,
        "converged": res.converged, "setup_s": setup_s, "assemble_s": assemble_s,
        "solve_s": solve_s, "solve_ms_per_iter": 1e3 * solve_s / max(res.iters, 1),
        "variable_rho": {"iters": res_rho.iters, "residual": res_rho.residual,
                         "converged": res_rho.converged, "solve_s": solve_rho_s},
        "launches": launches,
    }
    emit(out)
    for name, count in launches.items():
        check(count > 0, f"main path: kernel {name} never launched")
    check(res.converged and res_rho.converged, "main path: a solve did not converge")
    # the stopping rule is ‖r‖ ≤ max(tol·‖f‖, atol) with tol = atol = 1e-10;
    # at n = 64 ‖f‖ ≈ 2e-3, so the absolute floor decides (as in the JAX package)
    # agree to 1e-8 relative, above an absolute floor at the rounding level
    check(abs(rel_host - res.residual) <= 1e-8 * rel_host + 1e-13,
          f"main path: residual {res.residual} vs host {rel_host}")
    check(r_host <= max(1e-10 * f_norm, 1e-10) * (1 + 1e-6),
          f"main path: host residual norm {r_host} above the stopping rule")
    check(0.0555 <= max_u <= 0.0565, f"main path: max u {max_u}")
    return prob, k, load, launches, out


def _device_time(prof) -> tuple[float, list]:
    """(device busy ms, top kernels) from the CUDA-device events of a
    torch.profiler trace (the CPU-side op rows repeat their kernels' time
    and are left out)."""
    rows = []
    for ev in prof.key_averages():
        # annotation ranges (tg.*) also appear on the device timeline: not kernels
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("tg."):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((ev.key, us, ev.count))
    rows.sort(key=lambda r: -r[1])
    top = [{"kernel": key[:70], "device_ms": us / 1e3, "calls": n} for key, us, n in rows[:8]]
    return sum(us for _, us, _ in rows) / 1e3, top


def phase_profile(prob):
    """Where the time of one n = 64 solve goes: a torch.profiler trace of
    ``prob.solve`` with the telemetry phase ranges on (tg.map, tg.reduce,
    tg.solve.cg), then one of the CG loop alone, each read as device busy
    time against host wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry
    from repro_torch.core import cg, make_matvec, make_preconditioner

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with telemetry.enabled(), profile(activities=acts) as prof:
        res, wall_s = timed(lambda: prob.solve(f=1.0))
    busy_ms, top = _device_time(prof)
    ranges = {ev.key: ev.cpu_time_total / 1e3 for ev in prof.key_averages()
              if ev.key.startswith("tg.") and ev.device_type == DeviceType.CPU}

    k, load = prob.assemble(f=1.0)
    matvec, m = make_matvec(k, "ell"), make_preconditioner(k, "jacobi")
    cg(matvec, load, m=m)
    with profile(activities=acts) as prof_cg:
        (_, info), loop_s = timed(lambda: cg(matvec, load, m=m))
    loop_busy_ms, loop_top = _device_time(prof_cg)
    out = {"phase": "profile", "solve": {
               "iters": res.iters, "wall_ms": 1e3 * wall_s, "device_busy_ms": busy_ms,
               "device_idle_share": 1 - busy_ms / (1e3 * wall_s), "host_ranges_ms": ranges,
               "top_kernels": top},
           "cg_loop": {
               "iters": info.iters, "wall_ms": 1e3 * loop_s, "device_busy_ms": loop_busy_ms,
               "device_idle_share": 1 - loop_busy_ms / (1e3 * loop_s),
               "wall_us_per_iter": 1e6 * loop_s / info.iters,
               "device_us_per_iter": 1e3 * loop_busy_ms / info.iters,
               "top_kernels": loop_top}}
    emit(out)
    check(busy_ms > 0 and loop_busy_ms > 0, "profile: the trace holds no device time")
    return out


def phase_kernels_main(prob, k, bw, fp64):
    from repro_torch.core import csr_to_ell, unit_square_tri
    from repro_torch.kernels import (galerkin_residual_ell, local_stiffness_p1, seg_reduce,
                                     spmv_ell)
    from repro_torch.kernels.ref import (galerkin_residual_ell_ref, local_stiffness_p1_ref,
                                         seg_reduce_ref, spmv_ell_ref)

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / bw, flops / fp64
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    rng = np.random.default_rng(7)
    rows = {}

    # B1 on the main path's tetrahedra, and on unit_square_tri(512) triangles
    b1 = {}
    for d, coords in ((3, prob.plan.coords),
                      (2, torch.as_tensor((lambda m: m.points[m.cells])(unit_square_tri(512)),
                                          dtype=torch.float64, device="cuda"))):
        e = coords.shape[0]
        rho = torch.as_tensor(rng.uniform(0.5, 2.0, e), dtype=torch.float64, device="cuda")
        k_local = local_stiffness_p1(coords, rho)
        err, scale = max_err(k_local, local_stiffness_p1_ref(coords, rho))
        check(err <= 1e-12 * scale, f"local_stiffness_p1 d={d} E={e}: {err}")
        nbytes = 8 * (coords.numel() + rho.numel() + k_local.numel())
        b_ms, b_by = bound(nbytes, P1_FLOPS[d] * e)
        b1[d] = {"E": e, "max_abs_err": err, "scale": scale,
                 "ms": time_ms(lambda: local_stiffness_p1(coords, rho)),
                 "plain_ms": time_ms(lambda: local_stiffness_p1_ref(coords, rho)),
                 "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        if d == 3:
            k_local_tet = k_local
    rows["local_stiffness_p1"] = {**b1[3], "library_ms": None,
                                  "shape": f"tet E={b1[3]['E']}", "tri": b1[2]}

    # B2 on the main path's Reduce table and Map output
    table = prob.plan.mat_reduce
    vals = seg_reduce(k_local_tet, table)
    plain = seg_reduce_ref(k_local_tet, table.rows, table.n_rows)
    err, scale = max_err(vals, plain)
    check(err <= 1e-12 * scale, f"seg_reduce: {err}")
    src, seg = k_local_tet.reshape(-1), table.rows
    nbytes = 4 * table.idx.numel() + 8 * (table.n_src + table.n_rows)
    b_ms, b_by = bound(nbytes, table.n_src)
    rows["seg_reduce"] = {
        "shape": f"rows={table.n_rows} L={table.idx.shape[1]} src={table.n_src}",
        "max_abs_err": err, "scale": scale,
        "ms": time_ms(lambda: seg_reduce(k_local_tet, table)),
        "plain_ms": time_ms(lambda: seg_reduce_ref(k_local_tet, table.rows, table.n_rows)),
        "library_ms": time_ms(lambda: torch.zeros(table.n_rows, dtype=src.dtype,
                                                  device="cuda").index_add_(0, seg, src)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}

    # B3 / B4 on the main path's condensed operator
    ell = csr_to_ell(k)
    n, width = ell.vals.shape
    x = torch.as_tensor(rng.normal(size=n), dtype=torch.float64, device="cuda")
    f = torch.as_tensor(rng.normal(size=n), dtype=torch.float64, device="cuda")
    a_lib = torch.sparse_csr_tensor(torch.as_tensor(k.indptr, device="cuda"),
                                    torch.as_tensor(k.indices, device="cuda"), k.vals,
                                    size=k.shape)
    for name, fn, ref, lib, extra in (
        ("spmv_ell", lambda: spmv_ell(ell.vals, ell.cols_dev, x),
         lambda: spmv_ell_ref(ell.vals, ell.cols_dev, x), lambda: a_lib @ x, 0),
        ("galerkin_residual_ell", lambda: galerkin_residual_ell(ell.vals, ell.cols_dev, x, f),
         lambda: galerkin_residual_ell_ref(ell.vals, ell.cols_dev, x, f),
         lambda: torch.addmv(f, a_lib, x, beta=-1.0), 1),
    ):
        err, scale = max_err(fn(), ref())
        check(err <= 1e-12 * scale, f"{name}: {err}")
        err_lib, _ = max_err(lib(), ref())
        check(err_lib <= 1e-12 * scale, f"{name}: library call disagrees: {err_lib}")
        nbytes = 12 * n * width + 8 * n * (2 + extra)
        b_ms, b_by = bound(nbytes, 2 * k.nnz + extra * n)
        rows[name] = {"shape": f"N={n} L={width} nnz={k.nnz}", "max_abs_err": err,
                      "scale": scale, "ms": time_ms(fn), "plain_ms": time_ms(ref),
                      "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
                      "bytes": nbytes}
    emit({"phase": "kernels_main", "rows": rows})
    return rows


def phase_second_entry():
    from repro_torch import kernels
    from repro_torch.core import unit_square_tri
    from repro_torch.fem import AdvectionDiffusionProblem

    kernels.reset_launches()
    prob = AdvectionDiffusionProblem(unit_square_tri(256), device="cuda")
    res, solve_s = timed(lambda: prob.solve(eps=0.05, beta=(1.0, 0.5), f=1.0))
    launches = dict(kernels.LAUNCHES)
    emit({"phase": "second_entry", "dofs": prob.space.num_dofs, "nnz": prob.plan.nnz,
          "iters": res.iters, "residual": res.residual, "converged": res.converged,
          "max_u": float(res.u.max()), "solve_s": solve_s, "launches": launches})
    check(res.converged, "advection-diffusion did not converge")
    for name in ("seg_reduce", "spmv_ell", "galerkin_residual_ell"):
        check(launches[name] > 0, f"advection-diffusion: kernel {name} never launched")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, fp64 = card_peaks(name)
    t0 = time.perf_counter()
    kernels.build()
    emit({"phase": "device", "nvidia_smi": smi, "device": name, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "peak_bytes_per_s": bw, "peak_fp64_per_s": fp64})

    phase_kernels_small()
    phase_reference()
    prob, k, _, launches, _ = phase_main_path()
    phase_profile(prob)
    rows = phase_kernels_main(prob, k, bw, fp64)
    phase_second_entry()

    print(smi)
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[kname], "max_abs_err": rows[kname]["max_abs_err"],
         "max_err": rows[kname]["max_abs_err"], "ms": rows[kname]["ms"],
         "plain_ms": rows[kname]["plain_ms"], "twin_ms": rows[kname]["plain_ms"],
         "bound_ms": rows[kname]["bound_ms"], "bound_by": rows[kname]["bound_by"],
         "library_ms": rows[kname]["library_ms"], "shape": rows[kname]["shape"]}
        for kname, (replaces, source) in KERNELS.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
