#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA machine
    python3 chip_smoke.py --only host_cost,ell_timing,gradients --src DIR
                                   # those phases alone, on DIR/src/repro_torch

Phases, one JSON line each:

1. device — the card (``nvidia-smi`` name and power limit), torch/CUDA
   versions, and the time to build the CUDA kernels from ``src/`` with nvcc;
   then, on a line each, ``ptxas -v``'s registers, static shared memory and
   spills for each kernel of ``spmv_ell.cu`` and ``spmv_ell_stream.cu``;
2. kernels_small — every kernel against its plain PyTorch version on the
   card at ragged shapes, float32 and float64 (B3/B4 at widths 1-40 with N
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
   B3-B6's autograd Functions in float64 at small N.

Then the card's ``nvidia-smi`` line, the ``kernels`` summary line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; with no CUDA device it exits 2 and prints no result.

``--only`` runs the named phases alone, to hold a change against its
parent on one card: ``gradients``, ``ell_timing`` (B3/B4 at the n = 64 and
n = 96 stiffness, built for the phase) and ``host_cost`` (the ELL wrappers'
host time per call and the n = 64 CG loop's wall time per iteration).
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
            t = re.search(r"([a-z_]+_kernel)I([fd])((?:Li\d+E)*)", name)
            args = ["double" if t.group(2) == "d" else "float",
                    *re.findall(r"Li(\d+)E", t.group(3))] if t else []
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
# of two, the widest tile rows and past them (a warp per row)
ELL_WIDTHS = (1, 7, 15, 16, 17, 32, 33, 40)
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
                                     galerkin_residual_ell_stream, spmv_ell, spmv_ell_stream)
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
    with torch.no_grad():
        direct = spmv_ell(vals, cols, x).grad_fn is None
    out = {"phase": "gradients", "n": MAIN_N, "dofs": prob.space.num_dofs,
           "steps": GRAD_STEPS, "grad_rel_diff_vs_csr": rel,
           "grad_max_abs_csr": float(ref.abs().max()), "rollout_launches": launches,
           "gradcheck": gradcheck, "gradcheck_launches": gradcheck_launches,
           "gradcheck_shape": f"N={n} L={width} block_n=64", "no_grad_direct": direct}
    emit(out)
    for b in ("ell", "ell_stream"):
        check(rel[b] <= 1e-8, f"gradients: {b} differs from csr by {rel[b]} (relative)")
    check(launches["ell"]["spmv_ell"] > 0 and launches["ell_stream"]["spmv_ell_stream"] > 0,
          "gradients: the rollouts did not launch B3/B5")
    for name, ok in gradcheck.items():
        check(ok is True, f"gradients: gradcheck of {name}: {ok}")
        check(gradcheck_launches[name] > 0, f"gradients: gradcheck never launched {name}")
    check(direct, "gradients: a call under no_grad recorded an autograd node")
    return out


def device_line() -> tuple[str, str]:
    """(the nvidia-smi name/power-limit line, torch's device name)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return smi, torch.cuda.get_device_name(0)


ONLY_PHASES = ("host_cost", "ell_timing", "gradients")


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
    ptxas = {source: start_ptxas(source) for source in ("spmv_ell", "spmv_ell_stream")}
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

    # each kernel's launches on the path that runs it: B1-B4 on the main
    # path, B5 on the θ rollout, B6 in the n = 96 streaming solve
    paths = {**{kname: ("main_path", main_launches) for kname in MAIN_KERNELS},
             "spmv_ell_stream": ("transient", transient_launches),
             "galerkin_residual_ell_stream": ("stream_solve", stream_launches)}
    launches = {kname: counts[kname] for kname, (_, counts) in paths.items()}

    print(smi)
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[kname], "path": paths[kname][0],
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
    phases = {"host_cost": phase_host_cost,
              "ell_timing": lambda: phase_ell_timing(*card_peaks(name)),
              "gradients": phase_gradients}
    for phase in ONLY_PHASES:
        if phase in only:
            phases[phase]()
    print(smi)
    emit({"partial_run": {"phases": [p for p in ONLY_PHASES if p in only],
                          "src": sys.path[0], "passed": True}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
