#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA machine
    python3 chip_smoke.py --only host_cost,ell_timing,gradients --src DIR
                                   # those phases alone, on DIR/src/repro_torch

Phases, one JSON line each:

1. device — the card (``nvidia-smi`` name and power limit), torch/CUDA
   versions, and the time to build the CUDA kernels from ``src/`` with nvcc;
   then, on a line each, ``ptxas -v``'s registers, static shared memory and
   spills for each kernel of each source;
2. kernels_small — every kernel against its plain PyTorch version on the
   card at ragged shapes, float32 and float64 (B1/B2 also batched, B ∈
   {1, 3}; B3/B4 at widths 1-45 with N
   not a multiple of 32 and operands one element off 16-byte alignment;
   the streaming kernels at the
   JAX package's sweep shapes, pipeline depths 1-3, and on plans that take
   each path of the kernel's schedule at every depth the wrapper accepts:
   decreasing window starts, a step past the ring, odd window starts with
   misaligned operands, ragged N and block_n, CTA runs over many blocks),
   and a streaming plan too large for shared memory must raise
   ``ValueError`` before launch;
3. reference — ``PoissonProblem(unit_cube_tet(n)).solve(f=1.0)`` for
   n = 8, 16, 24 against the JAX package's numbers (DoFs and nnz exact,
   CG iterations within ±1, max u within 1e-6), and against a direct
   scipy solve at n = 8;
4. main_path — the 3D Poisson solver at n = 64 (274,625 DoFs, 1,572,864
   tetrahedra): set-up, assembly, CG solve, then the quickstart's
   variable-coefficient solve; B1-B4 must have launched, the residual must
   agree with one computed by scipy on the host, and max u must lie in
   [0.0555, 0.0565];
5. profile — a torch.profiler trace of one n = 64 solve: device busy time
   against wall time;
6. transient — on the main path's assembler and condenser: 20
   Crank–Nicolson steps of the heat equation (dt = 1e-3) with
   ``backend="ell_stream"`` (B5 in every CG iteration) checked against the
   decay e^{-3π²t}, against the ``ell`` rollout and, at n = 8 and 16,
   against the JAX package's numbers; 20 Newmark steps of the wave
   equation (energy drift <= 1e-6); one profiled rollout;
7. stream_solve — ``PoissonProblem(unit_cube_tet(96))`` (912,673 DoFs)
   solved with ``backend="ell_stream"`` (B5 in CG, B6 for the residual)
   against ``backend="ell"``, with the streaming plan near its
   shared-memory limit;
8. kernels_main — each kernel at the shapes of the main path (B3/B4 at the
   n = 64 and n = 96 stiffness, B5/B6 at the n = 64 θ-method operator and
   the n = 96 stiffness): error against its plain version, median device
   time over 25 launches, the plain version's and one PyTorch library
   call's time, and the bound (B3/B4 also with their grid, rows per tile,
   tiles in flight, shared memory and the bytes they request; B5/B6 with
   their CTAs, x-ring length, shared memory and bytes moved);
9. second_entry — ``AdvectionDiffusionProblem(unit_square_tri(256))``
   with BiCGSTAB;
10. gradients — at n = 64 the gradient of a Newmark rollout loss with
   respect to u0 through ``backend="ell"`` and ``"ell_stream"`` against
   ``backend="csr"`` (1e-8 relative), and ``torch.autograd.gradcheck`` of
   B1's and B3-B6's autograd Functions in float64 at small N (B1's
   gradient also against the plain version's, 1e-12);
11. mixed_bc — ``MixedBCPoisson(disk_tri(256))`` (197,377 DoFs):
   Dirichlet, Neumann and Robin parts, BiCGSTAB; the volume Map is B1 and
   the volume and facet Reduces B2 (launch counts and a profiler trace),
   error against u = x ≤ 1e-6, a scipy residual on the host, and the JAX
   package's numbers at n_r = 14;
12. elasticity — ``ElasticityProblem(hollow_cube_tet(48))`` (316,446
   DoFs, ELL width 45): BiCGSTAB on ``ell``, a scipy residual, the six
   rigid-body modes through B3 on the un-condensed K, the JAX package's
   numbers at n = 4 and 8, and B3/B4's times at L = 45;
13. batched — at n = 64, ``solve_coeff_batch`` over 8 coefficient fields
   (one batched B1 and one batched B2 launch) and ``solve_batch`` over 8
   Gaussian right-hand sides, each instance against its single solve; the
   batched B1/B2 timed against their plain versions and 8 single launches;
14. quickstart — ``examples/quickstart_torch.py`` in a subprocess against
   the numbers of ``examples/quickstart.py``;
15. kernels_offsets64 — batched B1 and B2 once past 2^31 elements in all
   (float32, ~12 GB of device memory), last, so that its allocations do
   not sit before the earlier phases' first readings.

Then the card's ``nvidia-smi`` line, the ``kernels`` summary line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; with no CUDA device it exits 2 and prints no result.

``--only`` runs the named phases alone, to hold a change against its
parent on one card: ``gradients``, ``ell_timing`` (B3/B4 at the n = 64 and
n = 96 stiffness, built for the phase) and ``host_cost`` (the ELL wrappers'
host time per call and the n = 64 CG loop's wall time per iteration),
``assembly_cost`` (the wall time of a warm n = 64 assembly) and
``cold_path`` (reference, main_path and transient in a fresh process: the
first n = 64 assembly and solve, and the time per θ step); or to try
``kernels_small``, ``mixed_bc``, ``elasticity``, ``batched``,
``quickstart`` and ``kernels_offsets64`` alone.
``--src DIR`` imports ``repro_torch`` from ``DIR/src`` (a checkout of
another commit) instead.  Such a partial run ends with a ``partial_run``
line, never with the full run's ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent

# The JAX package's numbers for PoissonProblem(unit_cube_tet(n)).solve(f=1.0,
# tol=1e-10), measured on the CPU: n -> (DoFs, nnz, CG iterations, max u).
JAX_REFERENCE = {
    8: (729, 9_097, 16, 0.054918),
    16: (4_913, 66_961, 38, 0.055881),
    24: (15_625, 219_673, 57, 0.056065),
}
MAIN_N = 64
# The JAX package's numbers for 20 Crank–Nicolson steps (dt = 1e-3, CG at
# tol 1e-10 warm-started, backend "ell") of the heat equation on
# unit_cube_tet(n) from u0 = sin(πx)sin(πy)sin(πz) on the free DoFs,
# measured on the CPU: n -> (CG iterations per step, max u after 20 steps).
JAX_THETA_REFERENCE = {
    8: ([8, 8] + [7] * 18, 0.531882311278741),
    16: ([5] * 20, 0.5478196849090163),
}
STREAM_N = 96

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
    "spmv_ell_stream": ("src/repro/kernels/spmv_ell.py:404",
                        "src/repro_torch/kernels/csrc/spmv_ell_stream.cu"),
    "galerkin_residual_ell_stream": ("src/repro/kernels/spmv_ell.py:426",
                                     "src/repro_torch/kernels/csrc/spmv_ell_stream.cu"),
}
MAIN_KERNELS = ("local_stiffness_p1", "seg_reduce", "spmv_ell", "galerkin_residual_ell")
# (N, L, block_n) of the JAX package's streaming sweep (tests/test_kernels.py)
STREAM_SWEEP = ((1000, 7, 256), (300, 1, 128), (100, 5, 4096), (4096, 9, 1024), (129, 3, 128))
# flops of one element of the P1 Map kernel (closed-form adjugate + G Gᵀ)
P1_FLOPS = {2: 57, 3: 168}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def start_ptxas(source: str):
    """Compile ``csrc/<source>.cu`` to a cubin with ``ptxas -v`` (beside the
    library build, which it does not replace); returns the process."""
    from repro_torch.kernels import _cuda

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-cubin", "-Xptxas", "-v", "-o", str(_cuda.BUILD_DIR / f"{source}.cubin"),
           str(_cuda.CSRC / f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(proc) -> list:
    """Registers, static shared memory and spills of each kernel entry in
    ``ptxas -v`` output (templates shown as kernel<type,G>)."""
    import re

    out, _ = proc.communicate()
    check(proc.returncode == 0, f"ptxas -v build failed:\n{out[-3000:]}")
    rows, entry = [], None
    for line in out.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            t = re.search(r"([a-z0-9_]+_kernel)I([fd])((?:L[ib]\d+E)*)", name)
            args = ["double" if t.group(2) == "d" else "float",
                    *re.findall(r"L[ib](\d+)E", t.group(3))] if t else []
            entry = {"kernel": f"{t.group(1)}<{','.join(args)}>" if t else name}
            rows.append(entry)
        elif entry is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif entry is not None and "Used" in line and "registers" in line:
            entry["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["smem_static_bytes"] = int(m.group(1)) if m else 0
            entry = None
    return rows


def stream_x_loads(plan, runs) -> int:
    """Elements of x one launch of the streaming kernel copies: the whole
    window at the start of each CTA run and at each reload, the slide
    otherwise (a copy stops at N)."""
    total, tpb = 0, plan.tiles_per_block
    for c in range(len(runs) - 1):
        for i, b in enumerate(range(runs[c] // tpb, (runs[c + 1] - 1) // tpb + 1)):
            start = int(plan.starts[b])
            lo = start if i == 0 or plan.load_lo[b] < 0 else int(plan.load_lo[b])
            total += max(0, min(start + plan.window, plan.n_rows) - lo)
    return total


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
    from repro_torch import kernels
    from repro_torch.kernels import (StreamPlan, galerkin_residual_ell,
                                     galerkin_residual_ell_stream, local_stiffness_p1,
                                     seg_reduce, spmv_ell, spmv_ell_stream)
    from repro_torch.kernels.ref import (galerkin_residual_ell_ref,
                                         galerkin_residual_ell_stream_ref,
                                         local_stiffness_p1_ref, seg_reduce_ref, spmv_ell_ref,
                                         spmv_ell_stream_ref)
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
    for n, width, block_n in STREAM_SWEEP:
        rng = np.random.default_rng(n + width)
        plan = StreamPlan(np.sort(rng.integers(0, n, size=(n, width)), axis=1), block_n)
        cols_local, starts = plan.staged("cuda")
        for dtype in (torch.float32, torch.float64):
            tol = TOL[dtype]
            vals, x, f = (torch.as_tensor(rng.normal(size=shape), dtype=dtype, device="cuda")
                          for shape in ((n, width), n, n))
            want = spmv_ell_stream_ref(vals, cols_local, starts, x, block_n, plan.x_len)
            want_r = galerkin_residual_ell_stream_ref(vals, cols_local, starts, x, f, block_n,
                                                      plan.x_len)
            for nbuf in (1, 2, 3):
                for name, got, ref in (
                        ("spmv_ell_stream", spmv_ell_stream(vals, plan, x, nbuf=nbuf), want),
                        ("galerkin_residual_ell_stream",
                         galerkin_residual_ell_stream(vals, plan, x, f, nbuf=nbuf), want_r)):
                    err, scale = max_err(got, ref)
                    check(err <= tol * scale,
                          f"{name} N={n} L={width} block_n={block_n} nbuf={nbuf} {dtype}: {err}")
                    worst[name] = max(worst[name], err / scale)
                    cases += 1
    cases += _ell_width_cases(worst)
    cases += _stream_schedule_cases(worst)
    cases += _batched_cases(worst)
    # a block whose columns reach 30,000 rows ahead: a 240 KB float64 window
    cols = np.repeat(np.arange(40_000, dtype=np.int32)[:, None], 3, axis=1)
    cols[::1024, 0] = np.minimum(np.arange(0, 40_000, 1024) + 30_000, 39_999)
    wide = StreamPlan(cols, 1024)
    vals = torch.ones((40_000, 3), dtype=torch.float64, device="cuda")
    x = torch.ones(40_000, dtype=torch.float64, device="cuda")
    before = dict(kernels.LAUNCHES)
    try:
        spmv_ell_stream(vals, wide, x)
    except ValueError as e:
        infeasible = str(e)
    else:
        raise AssertionError(f"a plan with W={wide.window} launched without a ValueError")
    check(kernels.LAUNCHES == before, "the infeasible plan launched a kernel")
    emit({"phase": "kernels_small", "cases": cases, "infeasible_plan": infeasible,
          "tolerance": "max|err| <= tol * "
          "max(1, max|plain|), tol 2e-4 (float32) / 1e-12 (float64)",
          "worst_scaled_err": worst})


# B3/B4 widths: one slot, the 2D and 3D P1 stencils, each side of a power
# of two, the widest tile rows and past them (a warp per row), and the 3D
# elasticity stencil
ELL_WIDTHS = (1, 7, 15, 16, 17, 32, 33, 40, 45)
def _ell_width_cases(worst) -> int:
    """B3/B4 against their plain versions at every width of ``ELL_WIDTHS``, N not a multiple of 32 (one tile and a ragged
    one; many tiles), operands aligned or one element off 16 bytes."""
    from repro_torch.kernels import galerkin_residual_ell, spmv_ell
    from repro_torch.kernels.ref import galerkin_residual_ell_ref, spmv_ell_ref

    cases = 0
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for width in ELL_WIDTHS:
            for n in (45, 10_007):
                for skip in (0, 1):
                    rng = np.random.default_rng(n + width)

                    def operand(size, dt=dtype, high=None):
                        a = (rng.normal(size=size + skip) if high is None
                             else rng.integers(0, high, size=size + skip))
                        return torch.as_tensor(a, dtype=dt, device="cuda")[skip:]

                    vals = operand(n * width).view(n, width)
                    cols = operand(n * width, torch.int32, n).view(n, width)
                    x, f = operand(n), operand(n)
                    if skip:
                        check(all(t.data_ptr() % 16 for t in (vals, cols, x)),
                              f"B3 L={width}: the operands are 16-byte aligned")
                    want = spmv_ell_ref(vals, cols, x)
                    got = [("spmv_ell", spmv_ell(vals, cols, x), want),
                           ("galerkin_residual_ell", galerkin_residual_ell(vals, cols, x, f),
                            galerkin_residual_ell_ref(vals, cols, x, f))]
                    for name, out, ref in got:
                        err, scale = max_err(out, ref)
                        check(err <= tol * scale,
                              f"{name} N={n} L={width} skip={skip} {dtype}: {err}")
                        worst[name] = max(worst[name], err / scale)
                        cases += 1
    return cases


def _batched_cases(worst) -> int:
    """Batched B1 (ρ (B, E) on shared coordinates) and batched B2 (src
    (B, n_src) on one table) against their plain versions, B ∈ {1, 3},
    ragged E, float32 and float64."""
    from repro_torch.kernels import local_stiffness_p1, seg_reduce
    from repro_torch.kernels.ref import local_stiffness_p1_ref, seg_reduce_ref
    from repro_torch.kernels.seg_reduce import ReduceTable

    cases = 0
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        for n in (1, 7, 129, 5000):
            for batch in (1, 3):
                rng = np.random.default_rng(300 + n + batch)
                for d in (2, 3):
                    coords = random_simplices(rng, n, d, dtype)
                    rho = torch.as_tensor(rng.uniform(0.5, 2.0, (batch, n)), dtype=dtype,
                                          device="cuda")
                    err, scale = max_err(local_stiffness_p1(coords, rho),
                                         local_stiffness_p1_ref(coords, rho))
                    check(err <= tol * scale,
                          f"batched local_stiffness_p1 B={batch} d={d} E={n} {dtype}: {err}")
                    worst["local_stiffness_p1"] = max(worst["local_stiffness_p1"], err / scale)
                    cases += 1
                rows = rng.integers(0, n, size=3 * n + 1)
                perm = np.argsort(rows, kind="stable")
                table = ReduceTable(perm, rows[perm], rows, n, "cuda")
                src = torch.as_tensor(rng.normal(size=(batch, rows.shape[0])), dtype=dtype,
                                      device="cuda")
                err, scale = max_err(seg_reduce(src, table, batch=True),
                                     seg_reduce_ref(src, table.rows, n, batch=True))
                check(err <= tol * scale, f"batched seg_reduce B={batch} rows={n} {dtype}: {err}")
                worst["seg_reduce"] = max(worst["seg_reduce"], err / scale)
                cases += 1
    return cases


def phase_kernels_offsets64() -> dict:
    """Batched B1 and B2 past 2^31 elements in all (float32): B1 with 9 ×
    2^24 well-shaped tetrahedra (2.4e9 outputs), B2 with 17 × 2^27 source
    slots; the last instance, whose offsets pass 2^31, against the plain
    version."""
    from repro_torch.kernels import local_stiffness_p1, seg_reduce
    from repro_torch.kernels.ref import local_stiffness_p1_ref
    from repro_torch.kernels.seg_reduce import ReduceTable

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(64)
    e, batch = 1 << 24, 9
    ident = torch.cat([torch.zeros(1, 3), torch.eye(3)]).to("cuda")
    coords = (torch.randn((e, 1, 3), generator=gen, device="cuda") + ident
              + 0.1 * torch.randn((e, 4, 3), generator=gen, device="cuda"))
    rho = torch.rand((batch, e), generator=gen, device="cuda") + 0.5
    k_local = local_stiffness_p1(coords, rho)
    check(batch * e * 16 > 2 ** 31, "B1 offsets case below 2^31")
    err, scale = max_err(k_local[-1], local_stiffness_p1_ref(coords, rho[-1]))
    out["local_stiffness_p1"] = {"B": batch, "E": e, "elements": batch * e * 16,
                                 "max_abs_err": err, "scale": scale}
    check(err <= TOL[torch.float32] * scale, f"B1 past 2^31: {err}")
    del coords, rho, k_local
    n_src, batch, width = 1 << 27, 17, 8
    slots = np.arange(n_src, dtype=np.int64)
    table = ReduceTable(slots, slots // width, slots // width, n_src // width, "cuda")
    src = torch.rand((batch, n_src), generator=gen, device="cuda")
    got = seg_reduce(src, table, batch=True)
    want = src[-1].view(-1, width).sum(dim=1)
    check(batch * n_src > 2 ** 31, "B2 offsets case below 2^31")
    err, scale = max_err(got[-1], want)
    out["seg_reduce"] = {"B": batch, "n_src": n_src, "elements": batch * n_src,
                         "max_abs_err": err, "scale": scale}
    check(err <= TOL[torch.float32] * scale, f"B2 past 2^31: {err}")
    del src, got, want, table
    torch.cuda.empty_cache()
    emit({"phase": "kernels_offsets64", **out})
    return out


def _banded(rows, centre, half=40):
    """ELL columns of a band: row r reads centre[r] - 3 .. centre[r] + half
    (a 7-wide spread within), clipped to the matrix."""
    offs = np.array([-3, -1, 0, 1, 2, half // 2, half])
    return np.clip(centre[:, None] + offs[None, :], 0, rows - 1).astype(np.int32)


def stream_schedule_plans():
    """Plans that take each path of the streaming kernel's schedule:
    name -> (plan, misaligned operands, what the plan must show)."""
    from repro_torch.kernels import StreamPlan

    r = np.arange(5000)
    quarter = np.where(r < 2560, r // 4, 5000 - (5000 - r) // 4)
    return {
        # rows of a band in reverse order: every step of starts goes down
        "decreasing_starts": (StreamPlan(_banded(5000, 4999 - r), 256), False,
                              lambda p: (p.load_lo[1:] < 0).all()),
        # a slow band that jumps 3N/4 ahead half way: slides, then one step
        # past the ring
        "step_past_ring": (StreamPlan(_banded(5000, quarter), 256), False,
                           lambda p: ((p.load_lo[1:] < 0).sum() == 1
                                      and (p.load_lo[1:] >= 0).sum() > 1)),
        # starts at 1 mod 4, x and vals one element past an aligned address
        "odd_starts_misaligned": (StreamPlan(_banded(5000, r + 4), 512), True,
                                  lambda p: (p.starts[1:] % 4 == 1).all()),
        # N and block_n multiples of neither 64 nor 128
        "ragged_n_block": (StreamPlan(_banded(30_001, np.arange(30_001)), 1000), False,
                           lambda p: p.n_rows % 128 and p.block_n % 64),
        # one-tile blocks: every CTA run covers several blocks
        "runs_over_blocks": (StreamPlan(_banded(40_000, np.arange(40_000)), 32), False,
                             lambda p: p.tiles_per_block == 1 and p.n_tiles > 4 * 132),
    }


def _stream_schedule_cases(worst) -> int:
    from repro_torch.kernels import galerkin_residual_ell_stream, spmv_ell_stream
    from repro_torch.kernels.ref import galerkin_residual_ell_stream_ref, spmv_ell_stream_ref
    from repro_torch.kernels.spmv_ell import MAX_BUFFERS

    cases = 0
    for label, (plan, misaligned, shows) in stream_schedule_plans().items():
        check(bool(shows(plan)), f"plan {label} does not take the path it is for")
        n, width = plan.n_rows, plan.width
        cols_local, starts = plan.staged("cuda")
        rng = np.random.default_rng(n + width)
        for dtype in (torch.float32, torch.float64):
            tol, skip = TOL[dtype], int(misaligned)

            def operand(size, skip=0):
                return torch.as_tensor(rng.normal(size=size + skip), dtype=dtype,
                                       device="cuda")[skip:]

            vals, x, f = operand(n * width, skip).view(n, width), operand(n, skip), operand(n)
            if misaligned:
                check(vals.data_ptr() % 16 != 0 and x.data_ptr() % 16 != 0,
                      f"{label}: the operands are 16-byte aligned")
            want = spmv_ell_stream_ref(vals, cols_local, starts, x, plan.block_n, plan.x_len)
            want_r = want - f
            for nbuf in range(1, MAX_BUFFERS + 1):
                for name, got, ref in (
                        ("spmv_ell_stream", spmv_ell_stream(vals, plan, x, nbuf=nbuf), want),
                        ("galerkin_residual_ell_stream",
                         galerkin_residual_ell_stream(vals, plan, x, f, nbuf=nbuf), want_r)):
                    err, scale = max_err(got, ref)
                    check(err <= tol * scale, f"{name} {label} nbuf={nbuf} {dtype}: {err}")
                    worst[name] = max(worst[name], err / scale)
                    cases += 1
    return cases


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
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"main path: kernel {name} never launched")
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


THETA_DT, THETA_STEPS = 1e-3, 20


def _heat_rollout(prob, backend):
    """The Crank–Nicolson integrator of the heat equation on ``prob``'s
    assembler and condenser, and u0 = sin(πx)sin(πy)sin(πz) on the free
    DoFs."""
    from repro_torch.core import weakform as wf
    from repro_torch.transient import CRANK_NICOLSON, ThetaIntegrator

    integ = ThetaIntegrator.from_form(prob.asm, wf.diffusion(1.0), THETA_DT,
                                      theta=CRANK_NICOLSON, bc=prob.bc, backend=backend)
    pts = torch.as_tensor(prob.space.dof_points, dtype=torch.float64, device="cuda")
    return integ, torch.sin(math.pi * pts).prod(dim=1) * prob.bc.free_mask


def phase_transient(prob):
    """The θ-method and Newmark rollouts on the streaming backend (B5 in
    every CG iteration of the θ steps and in every Newmark stiffness
    apply), on the main path's n = 64 assembler and condenser."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core import unit_cube_tet, weakform as wf
    from repro_torch.fem import PoissonProblem
    from repro_torch.transient import NewmarkIntegrator

    refs = []
    for n, (iters, umax) in JAX_THETA_REFERENCE.items():
        integ, u0 = _heat_rollout(PoissonProblem(unit_cube_tet(n), device="cuda"), "ell_stream")
        traj, info = integ.rollout(u0, THETA_STEPS, return_info=True)
        row = {"n": n, "iters": info.iters.tolist(), "jax_iters": iters,
               "max_u": float(traj[-1].max()), "jax_max_u": umax}
        refs.append(row)
        check(max(abs(a - b) for a, b in zip(row["iters"], iters)) <= 1,
              f"θ rollout n={n}: iterations {row}")
        check(abs(row["max_u"] - umax) <= 1e-9 * umax, f"θ rollout n={n}: max u {row}")

    integ, u0 = _heat_rollout(prob, "ell_stream")
    integ.rollout(u0, 1)  # builds and stages the streaming plan
    kernels.reset_launches()
    (traj, info), wall_s = timed(lambda: integ.rollout(u0, THETA_STEPS, return_info=True))
    launches = dict(kernels.LAUNCHES)
    ell_integ, _ = _heat_rollout(prob, "ell")
    (traj_ell, info_ell), ell_wall_s = timed(
        lambda: ell_integ.rollout(u0, THETA_STEPS, return_info=True))

    decay = math.exp(-3 * math.pi**2 * THETA_DT * THETA_STEPS)
    ratio = float(traj[-1].max() / u0.max())
    diff = float((traj - traj_ell).abs().max() / traj_ell.abs().max())
    iters = info.iters.tolist()

    m_op = prob.asm.assemble(wf.mass(1.0))
    k_op = prob.asm.assemble(wf.diffusion(1.0))
    nm = NewmarkIntegrator(m_op, k_op, dt=THETA_DT, bc=prob.bc, backend="ell_stream")
    kernels.reset_launches()
    ((u_tr, v_tr), nm_info), nm_wall_s = timed(
        lambda: nm.rollout(u0, THETA_STEPS, return_velocity=True, return_info=True))
    nm_launches = dict(kernels.LAUNCHES)

    def energy(u, v):
        return 0.5 * (v @ m_op.matvec(v) + u @ k_op.matvec(u))

    e0 = float(energy(u0, torch.zeros_like(u0)))
    drift = max(abs(float(energy(u, v)) - e0) for u, v in zip(u_tr, v_tr)) / e0

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        _, prof_wall_s = timed(lambda: integ.rollout(u0, THETA_STEPS))
    busy_ms, top = _device_time(prof)

    out = {
        "phase": "transient", "n": MAIN_N, "dofs": prob.space.num_dofs, "dt": THETA_DT,
        "steps": THETA_STEPS, "jax_reference": refs,
        "theta": {"backend": "ell_stream", "iters": iters, "converged": bool(info.converged.all()),
                  "wall_s": wall_s, "wall_ms_per_step": 1e3 * wall_s / THETA_STEPS,
                  "ell_wall_ms_per_step": 1e3 * ell_wall_s / THETA_STEPS,
                  "max_u_ratio": ratio, "expected_ratio": decay,
                  "max_rel_diff_vs_ell": diff, "ell_iters": info_ell.iters.tolist(),
                  "launches": launches,
                  "spmv_ell_stream_per_step": launches["spmv_ell_stream"] / THETA_STEPS},
        "newmark": {"backend": "ell_stream", "energy_drift": drift, "wall_s": nm_wall_s,
                    "wall_ms_per_step": 1e3 * nm_wall_s / THETA_STEPS,
                    "iters": nm_info.iters.tolist(), "launches": nm_launches},
        "profiled_theta_rollout": {"wall_ms": 1e3 * prof_wall_s, "device_busy_ms": busy_ms,
                                   "device_idle_share": 1 - busy_ms / (1e3 * prof_wall_s),
                                   "top_kernels": top},
    }
    emit(out)
    check(bool(info.converged.all()) and bool(info_ell.converged.all()),
          "θ rollout did not converge")
    check(abs(ratio / decay - 1) <= 0.01, f"θ rollout: max u ratio {ratio} vs e^-3π²t {decay}")
    check(diff <= 1e-8, f"θ rollout: ell_stream vs ell differ by {diff}")
    check(max(abs(a - b) for a, b in zip(iters, info_ell.iters.tolist())) <= 1,
          "θ rollout: iterations of ell_stream and ell differ")
    # per step: one rhs apply, the CG's initial residual, one per iteration
    check(launches["spmv_ell_stream"] == sum(iters) + 2 * THETA_STEPS,
          f"θ rollout: B5 launched {launches['spmv_ell_stream']} times for {sum(iters)} "
          "iterations")
    check(launches["spmv_ell"] == 0, "θ rollout on ell_stream launched B3")
    check(nm_launches["spmv_ell_stream"] == THETA_STEPS + 1,
          f"Newmark: B5 launched {nm_launches['spmv_ell_stream']} times")
    check(drift <= 1e-6, f"Newmark energy drift {drift}")
    check(busy_ms > 0, "transient profile: the trace holds no device time")
    return integ.lhs, launches


def phase_stream_solve():
    """The streaming backend on a problem whose plan sits near the
    shared-memory limit: PoissonProblem(unit_cube_tet(96))."""
    from repro_torch import kernels
    from repro_torch.core import unit_cube_tet
    from repro_torch.fem import PoissonProblem
    from repro_torch.kernels.spmv_ell import BLOCK_N

    prob, setup_s = timed(lambda: PoissonProblem(unit_cube_tet(STREAM_N), device="cuda"))
    k, _ = prob.assemble(f=1.0)
    kernels.reset_launches()
    # the first solve also builds the ELL layout and the streaming plan
    res, first_s = timed(lambda: prob.solve(f=1.0, backend="ell_stream"))
    launches = dict(kernels.LAUNCHES)
    res_ell, _ = timed(lambda: prob.solve(f=1.0, backend="ell"))
    _, solve_s = timed(lambda: prob.solve(f=1.0, backend="ell_stream"))
    _, ell_s = timed(lambda: prob.solve(f=1.0, backend="ell"))
    plan = k.pattern.stream_plans()(BLOCK_N)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    nbuf = plan.depth(8, optin)
    max_u = float(res.u.max())
    du = float((res.u - res_ell.u).abs().max())
    out = {"phase": "stream_solve", "n": STREAM_N, "dofs": prob.space.num_dofs,
           "elements": prob.mesh.num_cells, "nnz": prob.plan.nnz, "setup_s": setup_s,
           "iters": res.iters, "ell_iters": res_ell.iters, "residual": res.residual,
           "converged": res.converged, "max_u": max_u, "max_abs_diff_vs_ell": du,
           "first_solve_s": first_s, "solve_s": solve_s, "ell_solve_s": ell_s,
           "plan": {"window": plan.window, "ring": plan.ring, "block_n": plan.block_n,
                    "nbuf": nbuf,
                    "n_blocks": plan.n_blocks, "ell_width": plan.width,
                    "smem_bytes": plan.smem_bytes(nbuf, 8), "smem_optin_bytes": optin},
           "launches": launches}
    emit(out)
    check(res.converged and res_ell.converged, "n=96: a solve did not converge")
    check(abs(res.iters - res_ell.iters) <= 1, f"n=96: iterations {res.iters} vs {res_ell.iters}")
    check(du <= 1e-9 * float(res_ell.u.abs().max()), f"n=96: ell_stream vs ell differ by {du}")
    check(0.0555 <= max_u <= 0.0565, f"n=96: max u {max_u}")
    check(launches["galerkin_residual_ell_stream"] > 0, "n=96: B6 never launched")
    check(launches["spmv_ell_stream"] == res.iters + 1, "n=96: B5 launches != iterations + 1")
    check(launches["spmv_ell"] == 0 and launches["galerkin_residual_ell"] == 0,
          "n=96: the ell_stream solve launched B3/B4")
    return k, launches


def ell_design(n: int, width: int) -> dict | None:
    """B3/B4's launch at (N, L): grid, rows per warp tile, tiles in flight
    per warp and dynamic shared memory per CTA; None for a library without
    the query (an earlier commit's)."""
    from repro_torch.kernels import _cuda

    if not hasattr(_cuda._library("spmv_ell"), "tg_ell_grid_f64"):
        return None
    if width > 32:
        return {"kernel": "a warp per row (L > 32)",
                "grid": _cuda.query("spmv_ell", "tg_ell_grid_f64", "cuda", n, width)}
    return {"kernel": "32-row warp tiles, one bulk copy per array",
            "grid": _cuda.query("spmv_ell", "tg_ell_grid_f64", "cuda", n, width),
            "warps_per_cta": 4, "rows_per_tile": 32, "tiles_in_flight": 1,
            "smem_bytes_per_cta": _cuda.query("spmv_ell", "tg_ell_smem_f64", "cuda", width)}


def ell_rows(ops: dict, bound, rng) -> dict:
    """B3/B4 on each CSR operator of ``ops`` (label -> CSR, the first the
    main row): error against the plain version, times, bound and design
    figures.  ``requested_bytes`` counts what the kernel asks of the memory
    system: vals and cols staged once, one x element gathered per slot
    (from L2 or HBM: which was not measured), y [and f] once."""
    from repro_torch.core import csr_to_ell
    from repro_torch.kernels import galerkin_residual_ell, spmv_ell
    from repro_torch.kernels.ref import galerkin_residual_ell_ref, spmv_ell_ref

    out = {}
    for label, op in ops.items():
        ell = csr_to_ell(op)
        n, width = ell.vals.shape
        x = torch.as_tensor(rng.normal(size=n), dtype=torch.float64, device="cuda")
        f = torch.as_tensor(rng.normal(size=n), dtype=torch.float64, device="cuda")
        a_lib = torch.sparse_csr_tensor(torch.as_tensor(op.indptr, device="cuda"),
                                        torch.as_tensor(op.indices, device="cuda"), op.vals,
                                        size=op.shape)
        design = ell_design(n, width)
        for name, fn, ref, lib, extra in (
            ("spmv_ell", lambda: spmv_ell(ell.vals, ell.cols_dev, x),
             lambda: spmv_ell_ref(ell.vals, ell.cols_dev, x), lambda: a_lib @ x, 0),
            ("galerkin_residual_ell", lambda: galerkin_residual_ell(ell.vals, ell.cols_dev, x, f),
             lambda: galerkin_residual_ell_ref(ell.vals, ell.cols_dev, x, f),
             lambda: torch.addmv(f, a_lib, x, beta=-1.0), 1),
        ):
            err, scale = max_err(fn(), ref())
            check(err <= 1e-12 * scale, f"{name} {label}: {err}")
            err_lib, _ = max_err(lib(), ref())
            check(err_lib <= 1e-12 * scale, f"{name} {label}: library call disagrees: {err_lib}")
            # the bound: vals, cols, x, y [, f] once each
            nbytes = 12 * n * width + 8 * n * (2 + extra)
            b_ms, b_by = bound(nbytes, 2 * op.nnz + extra * n)
            row = {"shape": f"N={n} L={width} nnz={op.nnz}", "max_abs_err": err,
                   "scale": scale, "ms": time_ms(fn), "plain_ms": time_ms(ref),
                   "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
                   "bytes": nbytes, "requested_bytes": nbytes - 8 * n + 8 * n * width,
                   "design": design}
            out.setdefault(name, {})[label] = row
    first = next(iter(ops))
    return {name: {**by_label[first], **{lab: r for lab, r in by_label.items() if lab != first}}
            for name, by_label in out.items()}


def wrapper_host_us(calls: int = 500, reps: int = 11) -> dict:
    """Host time of one B3/B4 wrapper call, µs: the median over ``reps`` of
    ``calls`` calls on the n = 8 stiffness (729 rows, a few µs of device
    work, so the loop waits on the host), synchronised at the end."""
    from repro_torch.core import csr_to_ell, unit_cube_tet
    from repro_torch.fem import PoissonProblem
    from repro_torch.kernels import galerkin_residual_ell, spmv_ell

    ell = csr_to_ell(PoissonProblem(unit_cube_tet(8), device="cuda").assemble(f=1.0)[0])
    x = torch.ones(ell.vals.shape[0], dtype=torch.float64, device="cuda")
    out = {}
    for name, fn in (("spmv_ell", lambda: spmv_ell(ell.vals, ell.cols_dev, x)),
                     ("galerkin_residual_ell",
                      lambda: galerkin_residual_ell(ell.vals, ell.cols_dev, x, x))):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            runs.append(1e6 * (time.perf_counter() - t0) / calls)
        out[name] = statistics.median(runs)
    return out


def phase_ell_timing(bw, fp64):
    """B3/B4 alone at the n = 64 and n = 96 stiffness (``--only``): the
    rows of ``kernels_main`` and the wrappers' host time per call, for
    holding a change against its parent."""
    from repro_torch.core import unit_cube_tet
    from repro_torch.fem import PoissonProblem

    ops = {f"n{n}": PoissonProblem(unit_cube_tet(n), device="cuda").assemble(f=1.0)[0]
           for n in (MAIN_N, STREAM_N)}
    rows = ell_rows(ops, bounder(bw, fp64), np.random.default_rng(7))
    emit({"phase": "ell_timing", "rows": rows, "host_us_per_call": wrapper_host_us()})
    return rows


def phase_host_cost(reps: int = 7):
    """The host cost of the ELL path (``--only``): the B3/B4 wrappers' host
    µs per call, and the n = 64 CG loop on ``ell`` and ``ell_stream``: wall
    µs per iteration over ``reps`` runs (host-bound, so this reads the
    wrappers and the loop), then one run under torch.profiler as in phase
    ``profile``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import cg, make_matvec, make_preconditioner, unit_cube_tet
    from repro_torch.fem import PoissonProblem

    k, load = PoissonProblem(unit_cube_tet(MAIN_N), device="cuda").assemble(f=1.0)
    m = make_preconditioner(k, "jacobi")
    out = {"phase": "host_cost", "host_us_per_call": wrapper_host_us()}
    for backend in ("ell", "ell_stream"):
        matvec = make_matvec(k, backend)
        cg(matvec, load, m=m)  # builds the ELL layout or the streaming plan
        runs = []
        for _ in range(reps):
            (_, info), loop_s = timed(lambda: cg(matvec, load, m=m))
            runs.append(1e6 * loop_s / info.iters)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            (_, info), loop_s = timed(lambda: cg(matvec, load, m=m))
        busy_ms, _ = _device_time(prof)
        out[backend] = {"iters": info.iters, "wall_us_per_iter": statistics.median(runs),
                        "wall_us_per_iter_runs": runs,
                        "profiled_wall_us_per_iter": 1e6 * loop_s / info.iters,
                        "profiled_device_us_per_iter": 1e3 * busy_ms / info.iters}
    emit(out)
    return out


def phase_cold_path():
    """The earlier cells' first readings in a fresh process (``--only``):
    the reference solves, then the main path (its first n = 64 assembly and
    solve) and the transient phase (time per θ and Newmark step), as the
    full run orders them after the kernel checks."""
    phase_reference()
    prob = phase_main_path()[0]
    phase_transient(prob)


def phase_assembly_cost(reps: int = 11):
    """The wall time of a warm n = 64 assembly (``--only``): stiffness and
    load with ρ = 1 and with ρ = 1 + x, ms, median over ``reps`` runs each
    (host-bound: a few kernels behind several ms of Python)."""
    from repro_torch.core import unit_cube_tet
    from repro_torch.fem import PoissonProblem

    prob = PoissonProblem(unit_cube_tet(MAIN_N), device="cuda")
    out = {"phase": "assembly_cost"}
    for label, rho in (("rho_1", None), ("rho_1_plus_x", lambda x: 1.0 + x[..., 0])):
        prob.assemble(rho=rho, f=1.0)
        runs = [1e3 * timed(lambda: prob.assemble(rho=rho, f=1.0))[1] for _ in range(reps)]
        out[label] = {"median_ms": statistics.median(runs), "runs_ms": runs}
    emit(out)
    return out


def bounder(bw, fp64):
    """bound(bytes, flops) -> (ms, "bytes" | "operations") on this card."""
    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / bw, flops / fp64
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    return bound


def phase_kernels_main(prob, k, theta_lhs, k_stream, bw, fp64):
    from repro_torch import telemetry
    from repro_torch.core import csr_to_ell, unit_square_tri
    from repro_torch.kernels import (autotune_ell_stream, galerkin_residual_ell_stream,
                                     local_stiffness_p1, seg_reduce, spmv_ell, spmv_ell_stream)
    from repro_torch.kernels.ref import (galerkin_residual_ell_stream_ref,
                                         local_stiffness_p1_ref, seg_reduce_ref,
                                         spmv_ell_stream_ref)
    from repro_torch.kernels.spmv_ell import BLOCK_N

    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    bound = bounder(bw, fp64)
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

    # B3 / B4 on the main path's condensed operator and the n = 96 stiffness
    rows.update(ell_rows({"n64": k, "n96": k_stream}, bound, rng))
    for name, us in wrapper_host_us().items():
        rows[name]["host_us_per_call"] = us
    # B5 / B6 at the n = 64 θ-method operator (M + θΔtK, condensed) and the
    # n = 96 stiffness; the bound is B3's (vals, cols, x, y [, f] once each);
    # moved_bytes counts x as the kernel copies it (x_loaded elements: each
    # CTA run's first window, then slides and reloads)
    stream = {}
    for label, op in (("theta_lhs_n64", theta_lhs), ("stiffness_n96", k_stream)):
        ell = csr_to_ell(op)
        n, width = ell.vals.shape
        plan = op.pattern.stream_plans()(BLOCK_N)
        cols_local, starts = plan.staged("cuda")
        x = torch.as_tensor(rng.normal(size=n), dtype=torch.float64, device="cuda")
        f = torch.as_tensor(rng.normal(size=n), dtype=torch.float64, device="cuda")
        a_lib = torch.sparse_csr_tensor(torch.as_tensor(op.indptr, device="cuda"),
                                        torch.as_tensor(op.indices, device="cuda"), op.vals,
                                        size=op.shape)
        b3_ms = time_ms(lambda: spmv_ell(ell.vals, ell.cols_dev, x))
        telemetry.reset()
        with telemetry.enabled():
            tuned = autotune_ell_stream(ell, x, block_candidates=(512, 1024, 2048, 4096, 8192),
                                        nbuf_candidates=(1, 2, 3, 4, 6), iters=10)
            sweep = {key.split("{")[1].rstrip("}"): h["mean"]
                     for key, h in telemetry.snapshot()["histograms"].items()
                     if key.startswith("ell_stream_autotune_us")}
        telemetry.reset()
        nbuf = plan.depth(8, optin)
        _, runs, n_ctas = plan.schedule(x.device, nbuf, 8)
        x_loaded = stream_x_loads(plan, runs.cpu().numpy())
        for name, fn, ref, lib, extra in (
            ("spmv_ell_stream", lambda: spmv_ell_stream(ell.vals, plan, x),
             lambda: spmv_ell_stream_ref(ell.vals, cols_local, starts, x, plan.block_n,
                                         plan.x_len),
             lambda: a_lib @ x, 0),
            ("galerkin_residual_ell_stream",
             lambda: galerkin_residual_ell_stream(ell.vals, plan, x, f),
             lambda: galerkin_residual_ell_stream_ref(ell.vals, cols_local, starts, x, f,
                                                      plan.block_n, plan.x_len),
             lambda: torch.addmv(f, a_lib, x, beta=-1.0), 1),
        ):
            err, scale = max_err(fn(), ref())
            check(err <= 1e-12 * scale, f"{name} {label}: {err}")
            err_lib, _ = max_err(lib(), ref())
            check(err_lib <= 1e-12 * scale, f"{name} {label}: library call disagrees: {err_lib}")
            nbytes = 12 * n * width + 8 * n * (2 + extra)
            b_ms, b_by = bound(nbytes, 2 * op.nnz + extra * n)
            stream.setdefault(name, {})[label] = {
                "shape": f"N={n} L={width} nnz={op.nnz} W={plan.window} "
                         f"block_n={plan.block_n} nbuf={nbuf}",
                "max_abs_err": err, "scale": scale, "ms": time_ms(fn),
                "plain_ms": time_ms(ref), "library_ms": time_ms(lib), "bound_ms": b_ms,
                "bound_by": b_by, "bytes": nbytes,
                "moved_bytes": nbytes - 8 * n + 8 * x_loaded, "x_loaded": x_loaded,
                "ctas": n_ctas, "ring_elems": plan.ring, "n_blocks": plan.n_blocks,
                "reloads": int((plan.load_lo[1:] < 0).sum()),
                "smem_bytes": plan.smem_bytes(nbuf, 8), "spmv_ell_ms": b3_ms,
                "autotune": {"block_n": tuned[0], "nbuf": tuned[1], "wall_us": sweep}}
    for name, by_label in stream.items():
        rows[name] = {**by_label["theta_lhs_n64"], "n96": by_label["stiffness_n96"]}
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


GRAD_STEPS = 5


def phase_gradients():
    """C1 on the card: the gradient of a Newmark rollout loss with respect
    to u0 through the ELL kernels (B3 on ``ell``, B5 on ``ell_stream``, in
    the stiffness applies K·u*) equals the ``csr`` rollout's to 1e-8
    relative at n = 64; gradcheck of the four wrappers' autograd Functions
    in float64 at small N.  The readings are emitted before the checks."""
    from repro_torch import kernels
    from repro_torch.core import SolverSpec, unit_cube_tet, weakform as wf
    from repro_torch.fem import PoissonProblem
    from repro_torch.kernels import (StreamPlan, galerkin_residual_ell,
                                     galerkin_residual_ell_stream, local_stiffness_p1,
                                     spmv_ell, spmv_ell_stream)
    from repro_torch.kernels.ref import local_stiffness_p1_ref
    from repro_torch.transient import NewmarkIntegrator
    from torch.autograd.gradcheck import GradcheckError

    prob = PoissonProblem(unit_cube_tet(MAIN_N), device="cuda")
    m_op = prob.asm.assemble(wf.mass(1.0))
    k_op = prob.asm.assemble(wf.diffusion(1.0))
    pts = torch.as_tensor(prob.space.dof_points, dtype=torch.float64, device="cuda")
    u0 = torch.sin(math.pi * pts).prod(dim=1) * prob.bc.free_mask
    wts = torch.as_tensor(np.random.default_rng(3).normal(size=(GRAD_STEPS, u0.shape[0])),
                          device="cuda")
    spec = SolverSpec(method="cg", tol=1e-12, atol=1e-14)
    grads, launches = {}, {}
    for backend in ("csr", "ell", "ell_stream"):
        nm = NewmarkIntegrator(m_op, k_op, dt=THETA_DT, bc=prob.bc, spec=spec, backend=backend)
        u = u0.clone().requires_grad_()
        kernels.reset_launches()
        (wts * nm.rollout(u, GRAD_STEPS)).sum().backward()
        grads[backend], launches[backend] = u.grad, dict(kernels.LAUNCHES)
    ref = grads["csr"]
    rel = {b: float((grads[b] - ref).abs().max() / ref.abs().max()) for b in ("ell", "ell_stream")}

    rng = np.random.default_rng(4)
    n, width = 301, 15
    cols_np = np.sort(rng.integers(0, n, size=(n, width)), axis=1).astype(np.int32)
    cols = torch.as_tensor(cols_np, device="cuda")
    plan = StreamPlan(cols_np, 64)
    vals, x, f = (torch.as_tensor(rng.normal(size=shape), device="cuda").requires_grad_()
                  for shape in ((n, width), n, n))
    calls = {"spmv_ell": (lambda v, xx: spmv_ell(v, cols, xx), (vals, x)),
             "galerkin_residual_ell": (lambda v, xx, ff: galerkin_residual_ell(v, cols, xx, ff),
                                       (vals, x, f)),
             "spmv_ell_stream": (lambda v, xx: spmv_ell_stream(v, plan, xx), (vals, x)),
             "galerkin_residual_ell_stream": (
                 lambda v, xx, ff: galerkin_residual_ell_stream(v, plan, xx, ff), (vals, x, f))}
    gradcheck, gradcheck_launches = {}, {}
    for name, (fn, inputs) in calls.items():
        kernels.reset_launches()
        try:
            gradcheck[name] = bool(torch.autograd.gradcheck(fn, inputs))
        except (RuntimeError, GradcheckError) as e:
            gradcheck[name] = f"failed: {str(e).splitlines()[0][:160]}"
        gradcheck_launches[name] = kernels.LAUNCHES[name]
    # B1's Function: gradcheck (batched ρ), and Σ w·K's gradient against the
    # plain version's autograd on the card
    coords = random_simplices(rng, 40, 3, torch.float64).requires_grad_()
    rho = torch.as_tensor(rng.uniform(0.5, 2.0, (2, 40)), device="cuda").requires_grad_()
    kernels.reset_launches()
    try:
        gradcheck["local_stiffness_p1"] = bool(torch.autograd.gradcheck(
            local_stiffness_p1, (coords[:6].detach().clone().requires_grad_(),
                                 rho[:, :6].detach().clone().requires_grad_())))
    except (RuntimeError, GradcheckError) as e:
        gradcheck["local_stiffness_p1"] = f"failed: {str(e).splitlines()[0][:160]}"
    w = torch.as_tensor(rng.normal(size=(2, 40, 4, 4)), device="cuda")
    g_kernel = torch.autograd.grad((w * local_stiffness_p1(coords, rho)).sum(), (coords, rho))
    gradcheck_launches["local_stiffness_p1"] = kernels.LAUNCHES["local_stiffness_p1"]
    g_plain = torch.autograd.grad((w * local_stiffness_p1_ref(coords, rho)).sum(), (coords, rho))
    b1_grad_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_kernel, g_plain))
    with torch.no_grad():
        direct = spmv_ell(vals, cols, x).grad_fn is None
    out = {"phase": "gradients", "n": MAIN_N, "dofs": prob.space.num_dofs,
           "steps": GRAD_STEPS, "grad_rel_diff_vs_csr": rel,
           "grad_max_abs_csr": float(ref.abs().max()), "rollout_launches": launches,
           "gradcheck": gradcheck, "gradcheck_launches": gradcheck_launches,
           "gradcheck_shape": f"N={n} L={width} block_n=64; B1: B=2 E=6",
           "b1_grad_rel_diff_vs_plain": b1_grad_err, "no_grad_direct": direct}
    emit(out)
    for b in ("ell", "ell_stream"):
        check(rel[b] <= 1e-8, f"gradients: {b} differs from csr by {rel[b]} (relative)")
    check(launches["ell"]["spmv_ell"] > 0 and launches["ell_stream"]["spmv_ell_stream"] > 0,
          "gradients: the rollouts did not launch B3/B5")
    for name, ok in gradcheck.items():
        check(ok is True, f"gradients: gradcheck of {name}: {ok}")
        check(gradcheck_launches[name] > 0, f"gradients: gradcheck never launched {name}")
    check(direct, "gradients: a call under no_grad recorded an autograd node")
    check(b1_grad_err <= 1e-12, f"gradients: B1's gradient differs from the plain version's "
          f"by {b1_grad_err}")
    return out


# The JAX package's MixedBCPoisson on disk_tri(14) (bench_mixed_bc's data,
# u = x), on the CPU: 631 DoFs, 92 BiCGSTAB iterations, relative error
# 7.056437587069318e-05.  The iteration count is not reproducible past
# rounding there: one-ulp perturbations of the reference's own condensed
# values gave 86-93 iterations (ROADMAP C2), so the port is held to that
# spread ±1.
JAX_MIXED_REFERENCE = {"n_r": 14, "dofs": 631, "iters": 92, "iters_spread": (86, 93),
                       "rel_err": 7.056437587069318e-05}
MIXED_N_R = 256
# The JAX package's ElasticityProblem(hollow_cube_tet(n)).solve() on the CPU:
# n -> (DoFs, BiCGSTAB iterations, max |u|); at n = 4 every DoF lies on the
# boundary, so nothing is solved.
JAX_ELASTICITY_REFERENCE = {4: (372, 0, 0.0), 8: (2_106, 15, 0.019151727213464177)}
ELASTICITY_N = 48
BATCH = 8
# examples/quickstart.py (the JAX package) on the CPU
JAX_QUICKSTART = {"dofs": 729, "iters": 16, "max_u": "0.054918",
                  "batched_iters": [30] * 8, "advection_max_u": "0.7236"}


def _on_lower_arc(c):
    return (np.sqrt(c[:, 0] ** 2 + c[:, 1] ** 2) > 0.95) & (c[:, 1] <= 0)


def _mixed_problem(n_r):
    """bench_mixed_bc's disk: Dirichlet off the lower arc, Neumann on its
    x > 0 half, Robin (α = 1) on its x ≤ 0 half."""
    from repro_torch.core import disk_tri
    from repro_torch.fem import MixedBCPoisson

    return MixedBCPoisson(disk_tri(n_r, center=(0.0, 0.0), radius=1.0), device="cuda",
                          dirichlet_pred=lambda c: ~_on_lower_arc(c),
                          neumann_pred=lambda c: _on_lower_arc(c) & (c[:, 0] > 0),
                          robin_pred=lambda c: _on_lower_arc(c) & (c[:, 0] <= 0))


def _solve_u_eq_x(prob):
    """u = x is harmonic; the Neumann data is x/r and the Robin data x/r + x."""
    r = lambda x: torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)  # noqa: E731
    res = prob.solve(f=0.0, g_neumann=lambda x: x[..., 0] / r(x), robin_alpha=1.0,
                     g_robin=lambda x: x[..., 0] / r(x) + x[..., 0],
                     dirichlet_values=lambda p: p[:, 0])
    exact = prob.space.dof_points[:, 0]
    err = float(np.linalg.norm(res.u.cpu().numpy() - exact) / np.linalg.norm(exact))
    return res, err


def _kernel_calls(prof) -> dict:
    """Device kernel launches of a torch.profiler trace by the name of each
    of this repository's kernels."""
    names = {"p1_stiffness_kernel": "local_stiffness_p1", "seg_reduce_kernel": "seg_reduce",
             "tile_kernel": "spmv_ell/residual (tiles)",
             "wide_kernel": "spmv_ell/residual (warp per row)"}
    out = dict.fromkeys(names.values(), 0)
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        for key, label in names.items():
            if key in ev.key:
                out[label] += ev.count
    return out


def phase_mixed_bc():
    """MixedBCPoisson (paper SM B.1.5) on disk_tri(256): the diffusion Map
    is B1 beside the Robin facet terms, the volume and facet Reduces are
    B2, BiCGSTAB runs B3 and the residual B4; against u = x, a scipy
    residual on the host, and the JAX package's numbers at n_r = 14."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    ref = JAX_MIXED_REFERENCE
    small = _mixed_problem(ref["n_r"])
    res14, err14 = _solve_u_eq_x(small)
    row14 = {"n_r": ref["n_r"], "dofs": small.space.num_dofs, "iters": res14.iters,
             "jax_iters": ref["iters"], "jax_iters_spread": ref["iters_spread"],
             "rel_err": err14, "jax_rel_err": ref["rel_err"], "residual": res14.residual}

    prob, setup_s = timed(lambda: _mixed_problem(MIXED_N_R))
    _solve_u_eq_x(prob)  # builds the ELL layout
    kernels.reset_launches()
    (res, err), solve_s = timed(lambda: _solve_u_eq_x(prob))
    launches = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (res_prof, _), prof_s = timed(lambda: _solve_u_eq_x(prob))
    busy_ms, top = _device_time(prof)
    calls = _kernel_calls(prof)

    # the condensed system on the host: ‖K u − f‖ / ‖f‖ by scipy
    from repro_torch.core import forms, weakform as wf
    r_at = lambda x: torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)  # noqa: E731
    k = prob.asm.assemble(wf.diffusion() + wf.robin(1.0, on=prob._fa_r))
    g_r = forms.eval_coefficient(lambda x: x[..., 0] / r_at(x) + x[..., 0], prob._ctx_r)
    g_n = forms.eval_coefficient(lambda x: x[..., 0] / r_at(x), prob._ctx_n)
    load = prob.asm.assemble_rhs(wf.source(0.0) + wf.neumann(g_r, on=prob._fa_r)
                                 + wf.neumann(g_n, on=prob._fa_n))
    bvals = torch.as_tensor(prob.space.dof_points[prob.bc.bc_dofs][:, 0], device="cuda")
    kc, fc = prob.bc.apply(k, load, bvals)
    a, u, f = kc.to_scipy(), res.u.cpu().numpy(), fc.cpu().numpy()
    r_host, f_norm = float(np.linalg.norm(a @ u - f)), float(np.linalg.norm(f))
    rel_host = r_host / f_norm

    out = {"phase": "mixed_bc", "n_r": MIXED_N_R, "dofs": prob.space.num_dofs,
           "triangles": prob.mesh.num_cells, "nnz": prob.plan.nnz,
           "ell_width": kc.pattern.ell_layout()[2],
           "facets": {"dirichlet": len(prob.d_facets), "neumann": len(prob.n_facets),
                      "robin": len(prob.r_facets)},
           "iters": res.iters, "residual": res.residual, "residual_scipy_host": rel_host,
           "residual_norm_host": r_host, "f_norm": f_norm,
           "converged": res.converged, "rel_err_vs_u_eq_x": err, "setup_s": setup_s,
           "solve_s": solve_s, "launches": launches,
           "profiled": {"wall_ms": 1e3 * prof_s, "device_busy_ms": busy_ms,
                        "device_idle_share": 1 - busy_ms / (1e3 * prof_s),
                        "iters": res_prof.iters, "kernel_calls": calls,
                        "top_kernels": top},
           "jax_reference": row14}
    emit(out)
    check(small.space.num_dofs == ref["dofs"], f"mixed_bc n_r=14: DoFs {row14}")
    lo, hi = ref["iters_spread"]
    check(lo - 1 <= res14.iters <= hi + 1, f"mixed_bc n_r=14: iterations {row14}")
    check(abs(err14 - ref["rel_err"]) <= 1e-8, f"mixed_bc n_r=14: error {row14}")
    check(res14.converged and res.converged, "mixed_bc: a solve did not converge")
    check(err <= 1e-6, f"mixed_bc: relative error {err} against u = x")
    check(abs(rel_host - res.residual) <= 1e-8 * rel_host + 1e-13,
          f"mixed_bc: residual {res.residual} vs host {rel_host}")
    # the stopping rule ‖r‖ ≤ max(tol·‖f‖, atol), tol = atol = 1e-10
    check(r_host <= max(1e-10 * f_norm, 1e-10) * (1 + 1e-6),
          f"mixed_bc: host residual norm {r_host} above the stopping rule")
    # one assembly: one volume Map (B1); Reduces of K, the Robin matrix, the
    # volume load and the two boundary loads (B2)
    check(launches["local_stiffness_p1"] == 1, f"mixed_bc: B1 launches {launches}")
    check(launches["seg_reduce"] == 5, f"mixed_bc: B2 launches {launches}")
    check(launches["spmv_ell"] == 2 * res.iters + 1, f"mixed_bc: B3 launches {launches}")
    check(launches["galerkin_residual_ell"] == 1, f"mixed_bc: B4 launches {launches}")
    check(calls["local_stiffness_p1"] == 1 and calls["seg_reduce"] == 5,
          f"mixed_bc: the profiler saw {calls}")
    # rows 8 wide: B3 (2·iters + 1) and B4 (1) on the tile kernel
    check(calls["spmv_ell/residual (tiles)"] == 2 * res_prof.iters + 2
          and calls["spmv_ell/residual (warp per row)"] == 0,
          f"mixed_bc: the profiler saw {calls} for {res_prof.iters} iterations")
    return out


def rigid_body_modes(points: np.ndarray) -> np.ndarray:
    """The d(d+1)/2 rigid-body displacement fields (translations and
    infinitesimal rotations), interleaved, one per row."""
    n, d = points.shape
    modes = []
    for i in range(d):
        t = np.zeros((n, d))
        t[:, i] = 1.0
        modes.append(t.reshape(-1))
    for i in range(d):
        for j in range(i + 1, d):
            r = np.zeros((n, d))
            r[:, i], r[:, j] = -points[:, j], points[:, i]
            modes.append(r.reshape(-1))
    return np.stack(modes)


def phase_elasticity(bw, fp64):
    """ElasticityProblem(hollow_cube_tet(48)) (paper Benchmark II): BiCGSTAB
    on `ell`, whose rows are 45 wide (B3/B4 take the warp-per-row kernel);
    a scipy residual on the host; the un-condensed K through B3 on the six
    rigid-body modes; the JAX package's numbers at n = 4 and 8; B3/B4's
    times at L = 45."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core import csr_to_ell, hollow_cube_tet, weakform as wf
    from repro_torch.fem import ElasticityProblem
    from repro_torch.kernels import spmv_ell

    refs = []
    for n, (dofs, iters, umax) in JAX_ELASTICITY_REFERENCE.items():
        p = ElasticityProblem(hollow_cube_tet(n), device="cuda")
        r = p.solve()
        row = {"n": n, "dofs": p.space.num_dofs, "iters": r.iters, "jax_iters": iters,
               "max_abs_u": float(r.u.abs().max()), "jax_max_abs_u": umax}
        refs.append(row)
        check(p.space.num_dofs == dofs and abs(r.iters - iters) <= 1, f"elasticity: {row}")
        check(abs(row["max_abs_u"] - umax) <= 1e-9 * max(umax, 1.0), f"elasticity: {row}")

    prob, setup_s = timed(lambda: ElasticityProblem(hollow_cube_tet(ELASTICITY_N), device="cuda"))
    kc, fc = prob.assemble()
    prob.solve()  # builds the ELL layout
    kernels.reset_launches()
    res, solve_s = timed(lambda: prob.solve())
    launches = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res_prof, prof_s = timed(lambda: prob.solve())
    busy_ms, top = _device_time(prof)
    calls = _kernel_calls(prof)
    a, u, f = kc.to_scipy(), res.u.cpu().numpy(), fc.cpu().numpy()
    r_host, f_norm = float(np.linalg.norm(a @ u - f)), float(np.linalg.norm(f))
    rel_host = r_host / f_norm

    k_full = prob.asm.assemble(wf.elasticity(prob.lam, prob.mu))
    ell = csr_to_ell(k_full)
    k_norm = float(k_full.vals.abs().max())
    modes = torch.as_tensor(rigid_body_modes(prob.mesh.points), device="cuda")
    null = [float(spmv_ell(ell.vals, ell.cols_dev, r).abs().max()) / k_norm for r in modes]
    rows = ell_rows({"n48": kc}, bounder(bw, fp64), np.random.default_rng(45))
    for name in rows:
        rows[name]["launches_in_solve"] = launches[name]
    out = {"phase": "elasticity", "n": ELASTICITY_N, "dofs": prob.space.num_dofs,
           "tets": prob.mesh.num_cells, "nnz": prob.plan.nnz,
           "ell_width": kc.pattern.ell_layout()[2], "iters": res.iters,
           "residual": res.residual, "residual_scipy_host": rel_host,
           "residual_norm_host": r_host, "f_norm": f_norm,
           "converged": res.converged, "max_abs_u": float(res.u.abs().max()),
           "setup_s": setup_s, "solve_s": solve_s, "launches": launches,
           "profiled": {"wall_ms": 1e3 * prof_s, "device_busy_ms": busy_ms,
                        "device_idle_share": 1 - busy_ms / (1e3 * prof_s),
                        "iters": res_prof.iters, "kernel_calls": calls,
                        "top_kernels": top},
           "rigid_body_max_rel": null, "jax_reference": refs, "kernels": rows}
    emit(out)
    check(res.converged, "elasticity: BiCGSTAB did not converge")
    check(abs(rel_host - res.residual) <= 1e-8 * rel_host + 1e-13,
          f"elasticity: residual {res.residual} vs host {rel_host}")
    check(r_host <= max(1e-10 * f_norm, 1e-10) * (1 + 1e-6),
          f"elasticity: host residual norm {r_host} above the stopping rule")
    check(max(null) <= 1e-10, f"elasticity: rigid-body modes {null}")
    check(launches["seg_reduce"] == 2 and launches["local_stiffness_p1"] == 0,
          f"elasticity: assembly launches {launches}")
    check(launches["spmv_ell"] == 2 * res.iters + 1 and launches["galerkin_residual_ell"] == 1,
          f"elasticity: solve launches {launches}")
    # rows 45 wide: B3 (2·iters + 1) and B4 (1) on the warp-per-row kernel;
    # the assembly's two Reduces on B2, no B1 (a vector space)
    check(calls["spmv_ell/residual (warp per row)"] == 2 * res_prof.iters + 2
          and calls["spmv_ell/residual (tiles)"] == 0,
          f"elasticity: the profiler saw {calls} for {res_prof.iters} iterations")
    check(calls["seg_reduce"] == 2 and calls["local_stiffness_p1"] == 0,
          f"elasticity: the profiler saw {calls}")
    return out


def phase_batched(prob, bw, fp64):
    """Batched families (SM B.1.4) at n = 64: ``solve_coeff_batch`` with
    B = 8 fields ρ_b = 1 + 0.5·b·x (one B1 and one B2 launch for the
    batched assembly), ``solve_batch`` with the quickstart's 8 Gaussian
    right-hand sides; each instance against its single solve (1e-10
    relative, equal iterations); the batched B1/B2 against their plain
    versions and against B single launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core import (SolverSpec, assemble_batched, assemble_rhs,
                                  sparse_solve, sparse_solve_batched, weakform as wf)
    from repro_torch.kernels import local_stiffness_p1, seg_reduce
    from repro_torch.kernels.ref import local_stiffness_p1_ref, seg_reduce_ref

    if prob is None:
        from repro_torch.core import unit_cube_tet
        from repro_torch.fem import PoissonProblem

        prob = PoissonProblem(unit_cube_tet(MAIN_N), device="cuda")
    plan = prob.plan
    x_mid = plan.coords[:, :, 0].mean(dim=1)
    rho = torch.stack([1.0 + 0.5 * b * x_mid for b in range(BATCH)])
    spec = SolverSpec(method="cg", tol=1e-10, atol=1e-10, maxiter=10000)

    kernels.reset_launches()
    kb, assemble_s = timed(lambda: assemble_batched(plan, wf.diffusion(rho[0]),
                                                    leaves_batch=(rho, None)))
    asm_launches = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed(lambda: assemble_batched(plan, wf.diffusion(rho[0]), leaves_batch=(rho, None)))
    asm_calls = _kernel_calls(prof)
    kc = prob.bc.apply_matrix_only(kb)
    load = prob.bc.project_residual(assemble_rhs(plan, wf.source(1.0)))
    (u_b, info_b), solve_s = timed(lambda: sparse_solve_batched(kc, load, spec,
                                                                return_info=True))
    u_api = prob.solve_coeff_batch(rho)
    coeff_rows = []
    for b in range(BATCH):
        k1 = prob.asm.assemble(wf.diffusion(rho[b]))
        u1, i1 = sparse_solve(prob.bc.apply_matrix_only(k1), load, spec, return_info=True)
        rel = float((u_b[b] - u1).abs().max() / u1.abs().max())
        coeff_rows.append({"b": b, "iters": int(info_b.iters[b]), "single_iters": i1.iters,
                           "rel_diff": rel, "vals_equal": bool(torch.equal(kb.vals[b], k1.vals))})
    api_diff = float((u_api - u_b).abs().max() / u_b.abs().max())

    rng = np.random.default_rng(0)  # the quickstart's right-hand sides, at n = 64
    f_batch = torch.as_tensor(rng.normal(size=(BATCH, prob.space.num_dofs)), device="cuda")
    kernels.reset_launches()
    (us, iters), batch_s = timed(lambda: prob.solve_batch(f_batch))
    rhs_launches = dict(kernels.LAUNCHES)
    rhs_rows = []
    for b in range(BATCH):
        single = prob.solve(f=f_batch[b])
        rel = float((us[b] - single.u).abs().max() / single.u.abs().max())
        rhs_rows.append({"b": b, "iters": int(iters[b]), "single_iters": single.iters,
                         "rel_diff": rel})

    # the batched kernels against their plain versions and B single launches
    rho_e = rho.contiguous()
    coords = plan.coords
    local_b = local_stiffness_p1(coords, rho_e)
    err1, scale1 = max_err(local_b, local_stiffness_p1_ref(coords, rho_e))
    table = plan.mat_reduce
    vals_b = seg_reduce(local_b, table, batch=True)
    err2, scale2 = max_err(vals_b, seg_reduce_ref(local_b, table.rows, table.n_rows, batch=True))
    e = coords.shape[0]
    bound = bounder(bw, fp64)
    src = local_b.reshape(BATCH, -1)
    b1_bytes = 8 * (coords.numel() + rho_e.numel() + local_b.numel())
    b2_bytes = 4 * table.idx.numel() + 8 * BATCH * (table.n_src + table.n_rows)
    b1 = {"shape": f"B={BATCH} tet E={e}", "max_abs_err": err1, "scale": scale1,
          "ms": time_ms(lambda: local_stiffness_p1(coords, rho_e)),
          "single_x_B_ms": time_ms(lambda: [local_stiffness_p1(coords, rho_e[b])
                                            for b in range(BATCH)]),
          "plain_ms": time_ms(lambda: local_stiffness_p1_ref(coords, rho_e)),
          "library_ms": None, "bytes": b1_bytes,
          "launches": asm_launches["local_stiffness_p1"]}
    b1["bound_ms"], b1["bound_by"] = bound(b1_bytes, P1_FLOPS[3] * e * BATCH)
    b2 = {"shape": f"B={BATCH} rows={table.n_rows} L={table.idx.shape[1]} src={table.n_src}",
          "max_abs_err": err2, "scale": scale2,
          "ms": time_ms(lambda: seg_reduce(local_b, table, batch=True)),
          "single_x_B_ms": time_ms(lambda: [seg_reduce(local_b[b], table)
                                            for b in range(BATCH)]),
          "plain_ms": time_ms(lambda: seg_reduce_ref(local_b, table.rows, table.n_rows,
                                                     batch=True)),
          "library_ms": time_ms(lambda: torch.zeros((BATCH, table.n_rows), dtype=src.dtype,
                                                    device="cuda").index_add_(1, table.rows,
                                                                              src)),
          "bytes": b2_bytes, "launches": asm_launches["seg_reduce"]}
    b2["bound_ms"], b2["bound_by"] = bound(b2_bytes, BATCH * table.n_src)
    out = {"phase": "batched", "n": MAIN_N, "dofs": prob.space.num_dofs, "B": BATCH,
           "coeff_batch": {"assemble_s": assemble_s, "solve_s": solve_s,
                           "launches": asm_launches, "profiled_kernel_calls": asm_calls,
                           "rows": coeff_rows,
                           "solve_coeff_batch_rel_diff": api_diff},
           "rhs_batch": {"solve_s": batch_s, "launches": rhs_launches, "rows": rhs_rows},
           "kernels": {"local_stiffness_p1": b1, "seg_reduce": b2}}
    emit(out)
    check(asm_launches["local_stiffness_p1"] == 1 and asm_launches["seg_reduce"] == 1,
          f"batched: the batched assembly launched {asm_launches}")
    check(asm_calls["local_stiffness_p1"] == 1 and asm_calls["seg_reduce"] == 1,
          f"batched: the profiler saw {asm_calls} in the batched assembly")
    check(rhs_launches["seg_reduce"] == 2 and rhs_launches["local_stiffness_p1"] == 1,
          f"batched: solve_batch's assembly launched {rhs_launches}")
    check(err1 <= 1e-12 * scale1 and err2 <= 1e-12 * scale2, f"batched kernels: {err1}, {err2}")
    # the csr matvec sums with atomics on the card, so two runs of one solve
    # agree to rounding, not bit for bit
    check(api_diff <= 1e-10, f"batched: solve_coeff_batch differs from its parts by {api_diff}")
    for row in coeff_rows + rhs_rows:
        check(row["rel_diff"] <= 1e-10 and row["iters"] == row["single_iters"],
              f"batched: instance against its single solve {row}")
    check(all(r["vals_equal"] for r in coeff_rows), "batched: values differ from single")
    return out


def phase_quickstart():
    """examples/quickstart_torch.py in a subprocess on the card, against the
    numbers of examples/quickstart.py (the JAX package, on the CPU)."""
    import os
    import re

    import repro_torch

    script = ROOT / "examples" / "quickstart_torch.py"
    env = {**os.environ, "PYTHONPATH": str(Path(repro_torch.__file__).parents[1])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          env=env, timeout=600)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"quickstart_torch.py failed:\n{proc.stderr[-3000:]}")
    text = proc.stdout

    def field(pattern):
        m = re.search(pattern, text)
        check(m is not None, f"quickstart_torch.py printed no match for {pattern!r}:\n{text}")
        return m.group(1)

    got = {"dofs": int(field(r"DoFs:\s+(\d+)")),
           "iters": int(field(r"CG iterations:\s+(\d+)")),
           "residual": float(field(r"relative residual:\s+(\S+)")),
           "max_u": field(r"max u:\s+(\S+)"),
           "batched_iters": [int(v) for v in field(r"iters=\[([\d, ]+)\]").split(",")],
           "advection_max_u": field(r"advection-diffusion: .* max u (\S+)")}
    emit({"phase": "quickstart", "got": got, "jax": JAX_QUICKSTART, "wall_s": wall_s})
    ref = JAX_QUICKSTART
    check(got["dofs"] == ref["dofs"] and abs(got["iters"] - ref["iters"]) <= 1,
          f"quickstart: {got}")
    check(got["residual"] <= 1e-10, f"quickstart: residual {got['residual']}")
    check(got["max_u"] == ref["max_u"] and got["advection_max_u"] == ref["advection_max_u"],
          f"quickstart: {got}")
    check(len(got["batched_iters"]) == len(ref["batched_iters"])
          and all(abs(a - b) <= 1 for a, b in zip(got["batched_iters"], ref["batched_iters"])),
          f"quickstart: batched iterations {got['batched_iters']}")
    return got


def device_line() -> tuple[str, str]:
    """(the nvidia-smi name/power-limit line, torch's device name)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return smi, torch.cuda.get_device_name(0)


ONLY_PHASES = ("cold_path", "host_cost", "assembly_cost", "ell_timing", "gradients",
               "kernels_small", "mixed_bc", "elasticity", "batched", "quickstart",
               "kernels_offsets64")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", help="comma-separated phases to run alone: "
                    + ", ".join(ONLY_PHASES))
    ap.add_argument("--src", help="import repro_torch from SRC/src instead of this checkout")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else None
    if only and not set(only) <= set(ONLY_PHASES):
        ap.error(f"--only takes {', '.join(ONLY_PHASES)}, got {args.only}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    src = Path(args.src).resolve() / "src" if args.src else ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch package under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if only:
        return run_only(only)
    from repro_torch import kernels

    smi, name = device_line()
    bw, fp64 = card_peaks(name)
    t0 = time.perf_counter()
    ptxas = {source: start_ptxas(source)
             for source in ("local_assembly", "seg_reduce", "spmv_ell", "spmv_ell_stream")}
    try:
        kernels.build()
    finally:
        reports = {source: ptxas_report(proc) for source, proc in ptxas.items()}
    emit({"phase": "device", "nvidia_smi": smi, "device": name, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "peak_bytes_per_s": bw, "peak_fp64_per_s": fp64})
    for source, report in reports.items():
        emit({"phase": "device", "ptxas": f"src/repro_torch/kernels/csrc/{source}.cu",
              "kernels": report})

    phase_kernels_small()
    phase_reference()
    prob, k, _, main_launches, _ = phase_main_path()
    phase_profile(prob)
    theta_lhs, transient_launches = phase_transient(prob)
    k_stream, stream_launches = phase_stream_solve()
    rows = phase_kernels_main(prob, k, theta_lhs, k_stream, bw, fp64)
    phase_second_entry()
    phase_gradients()
    mixed = phase_mixed_bc()
    elasticity = phase_elasticity(bw, fp64)
    batched = phase_batched(prob, bw, fp64)
    phase_quickstart()
    phase_kernels_offsets64()

    # each kernel's launches on the path that runs it: B1-B4 on the main
    # path, B5 on the θ rollout, B6 in the n = 96 streaming solve
    paths = {**{kname: ("main_path", main_launches) for kname in MAIN_KERNELS},
             "spmv_ell_stream": ("transient", transient_launches),
             "galerkin_residual_ell_stream": ("stream_solve", stream_launches)}
    launches = {kname: counts[kname] for kname, (_, counts) in paths.items()}
    # and on this slice's paths, each counted from 0 around its own run
    later = {"mixed_bc": mixed["launches"], "elasticity": elasticity["launches"],
             "batched": batched["coeff_batch"]["launches"]}

    print(smi)
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[kname], "path": paths[kname][0],
         "launches_by_path": {path: counts[kname] for path, counts in later.items()},
         "max_abs_err": rows[kname]["max_abs_err"],
         "max_err": rows[kname]["max_abs_err"], "ms": rows[kname]["ms"],
         "plain_ms": rows[kname]["plain_ms"], "twin_ms": rows[kname]["plain_ms"],
         "bound_ms": rows[kname]["bound_ms"], "bound_by": rows[kname]["bound_by"],
         "library_ms": rows[kname]["library_ms"], "shape": rows[kname]["shape"]}
        for kname, (replaces, source) in KERNELS.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def run_only(only) -> int:
    """The phases of ``--only`` on the repro_torch on the path, in the order
    of ``ONLY_PHASES``, then the card's line and a ``partial_run`` line
    naming them (not the full run's last line)."""
    from repro_torch import kernels

    smi, name = device_line()
    t0 = time.perf_counter()
    kernels.build()
    emit({"phase": "device", "nvidia_smi": smi, "device": name, "src": sys.path[0],
          "build_s": time.perf_counter() - t0})
    phases = {"cold_path": phase_cold_path,
              "host_cost": phase_host_cost,
              "assembly_cost": phase_assembly_cost,
              "ell_timing": lambda: phase_ell_timing(*card_peaks(name)),
              "gradients": phase_gradients,
              "kernels_small": phase_kernels_small,
              "mixed_bc": phase_mixed_bc,
              "elasticity": lambda: phase_elasticity(*card_peaks(name)),
              "batched": lambda: phase_batched(None, *card_peaks(name)),
              "quickstart": phase_quickstart,
              "kernels_offsets64": phase_kernels_offsets64}
    for phase in ONLY_PHASES:
        if phase in only:
            phases[phase]()
    print(smi)
    emit({"partial_run": {"phases": [p for p in ONLY_PHASES if p in only],
                          "src": sys.path[0], "passed": True}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
