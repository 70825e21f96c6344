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
   {1, 3}; B2 bit for bit against the ordered plain sum with rows that
   get nothing, rows of 1,000 slots and past the kernel's stage, and
   ragged row and slot counts; B3/B4 at widths 1-129, each side of
   every hand-over between their three kernels that the library reports,
   with N not a multiple of 32 and operands one element off 16-byte
   alignment; B3 and B4 bit-equal
   to B5 and B6 at L = 33, 45, 64 and 81; the streaming kernels at the
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
   their CTAs, x-ring length, shared memory and bytes moved; B2 with the
   device bytes of its table);
9. reduce_timing — B2 at n = 64 on the stiffness table, on the load table
   (L2 flushed before each launch) and batched (B = 8) against 8 single
   launches: bit for bit against the ordered plain sum on the slot table,
   times beside the plain version and ``index_add_``, bound by the bytes
   of the Reduce's work;
10. second_entry — ``AdvectionDiffusionProblem(unit_square_tri(256))``
   with BiCGSTAB;
11. gradients — at n = 64 the gradient of a Newmark rollout loss with
   respect to u0 through ``backend="ell"`` and ``"ell_stream"`` against
   ``backend="csr"`` (1e-8 relative), and ``torch.autograd.gradcheck`` of
   B1's and B3-B6's autograd Functions in float64 at small N (B1's
   gradient also against the plain version's, 1e-12);
12. mixed_bc — ``MixedBCPoisson(disk_tri(256))`` (197,377 DoFs):
   Dirichlet, Neumann and Robin parts, BiCGSTAB; the volume Map is B1 and
   the volume and facet Reduces B2 (launch counts and a profiler trace),
   error against u = x ≤ 1e-6, a scipy residual on the host, and the JAX
   package's numbers at n_r = 14;
13. elasticity — ``ElasticityProblem(hollow_cube_tet(48))`` (316,446
   DoFs, ELL width 45): BiCGSTAB on ``ell``, a scipy residual, the six
   rigid-body modes through B3 on the un-condensed K, the JAX package's
   numbers at n = 4 and 8, and B3/B4's times at L = 45 and on grid
   operators on each side of the wide-tile kernel's limits;
14. batched — at n = 64, ``solve_coeff_batch`` over 8 coefficient fields
   (one batched B1 and one batched B2 launch) and ``solve_batch`` over 8
   Gaussian right-hand sides, each instance against its single solve; the
   batched B1/B2 timed against their plain versions and 8 single launches;
15. matfree_kernel — the fused P1 diffusion action (``csrc/matfree_p1.cu``): its
   ``ptxas -v`` line; the kernel against its plain twin at (k, d) = (4, 3) and
   (3, 2), float64 and float32, ragged element counts, every coefficient
   encoding and a rank's block; one apply at unit_cube_tet(16) launches it
   and B2 once each and no cuBLAS kernel, and the matrix-free solve there
   is within 1e-8 of ``ell``'s; at n = 96 its time against its bound and
   the einsum action, a whole apply each way, and one matrix-free solve;
16. matfree — at n = 64 on the main path's plan: ``PoissonProblem.solve(
   backend="matfree")`` for the stores ``context``, ``coords`` and
   ``local`` against the ``ell`` solve (u 1e-8, iterations ±1, B2 once per
   apply and B1 for ``local`` by the wrappers and a profiler trace of 30
   CG iterations; the apply's gather, action and scatter timed apart, its
   peak memory and the operator's state beside the CSR values); ∂/∂ρ of
   Σu² through ``matfree_solve`` against ``sparse_solve`` (1e-6
   relative); a family of 8 fields (one batched B1 launch for its
   element matrices, ``matvec`` and ``diagonal`` one batched B2 launch
   each, equal to 8 single applies; ``matfree_solve_batched`` against 8
   single solves); 20 Crank–Nicolson steps on matrix-free operators
   against the ``csr`` rollout at the default tolerance (1e-6) and the
   ``ell`` and ``csr`` rollouts at CG tolerance 1e-12 (1e-8, iterations
   ±1 against ``csr``'s); Allen–Cahn with ``NewtonKrylovIntegrator`` on
   ``unit_square_tri(512)`` (‖G(u)‖ < 1e-8) and at n = 8 against the JAX
   package's numbers;
17. opt — TensorOpt on the paper's 60×30 cantilever: compliance, CG
   iterations and ‖∂C/∂ρ‖ at ρ = 0.5 against pinned JAX numbers, the
   autograd sensitivity against Eq. B.28 (1e-5), 10 MMA iterations (the
   first 3 compliances pinned; C below 0.8 of its start) and 10 OC
   iterations (below 0.7, volume held), a multistart family of 8 (one
   batched B2 launch in ``compliance_batch``, each instance equal to its
   single call, 1e-10);
18. pils — physics-informed learning: at unit_square_tri(16) the Galerkin
   residual loss on ``ell`` (one B4 launch per loss and gradient) against
   ``csr`` (1e-9; its gradient in u 1e-10) and ``matfree``, 10 Adam steps
   of the paper's SIREN on ``csr`` and ``ell`` against pinned JAX losses
   (1e-8); at unit_square_tri(256) Adam it/s for TensorPILS on ``csr``,
   ``ell``, ``matfree`` and for PINN, ``fit_family`` over 8 fields (one
   batched B1 and B2 build), and 5 epochs of the wave AGN (finite, falling
   loss);
19. elemalg — the element tensor algebra: ``PoissonProblem(
   unit_square_tri(256), degree=2).solve(backend="matfree",
   condensed=True)`` (263,169 DoFs, the 66,049 vertices the interface)
   against the uncondensed ``matfree`` and ``ell`` solves (fewer outer
   iterations; at a tight inner tolerance u within 1e-8·max|u| and the
   interior rows of a loose solve within 1e-9·‖f‖∞), B2 on the scaffold's
   compact tables bit for bit against the ordered plain sum; the condensed
   solve at n = 64 and jacobi/ebe/chebyshev on anisotropic P1 at n = 32
   against pinned JAX numbers; ∂/∂ρ through ``condensed_solve`` against
   ``sparse_solve`` (1e-8 relative); jacobi/ebe/chebyshev on anisotropic
   P1 at unit_square_tri(512) (ebe and chebyshev in fewer iterations); EbE
   on the ``coords`` store and Chebyshev on ``ell`` on the n = 64 main
   path (u within 1e-8 of Jacobi's, fewer iterations; B1–B4 counted by
   the wrappers and a profiler trace); times of ``factorize``,
   ``ElementFactors.solve``, an EbE, a Chebyshev and a Schur apply;
20. serve — the solve service (``repro_torch.serve``) and its telemetry
   on ``csr`` and then ``matfree``: ``poisson_requests(resolution=256)``
   (66,049 DoFs), ``warmup`` of the buckets 1-16, two open-loop waves of
   16 requests at 2,000 requests/s through the worker thread, telemetry
   on; every response ok, no entry built after warmup, B1 and B2 at the
   path's shapes against their plain versions (the ``csr`` entry's batched
   K at bucket 16, one matrix-free apply's B2 on the 66,049-row vector
   table), wave 0 against
   sequential solves (1e-12·max|u|, equal iterations), one B1 and one B2 a
   ``csr`` group and B2 once an apply on ``matfree`` (the wrappers and a
   profiler trace of one dispatch, with its idle share), the span segments
   summing to e2e, a ``telemetry.capture`` naming the kernels, the JAX
   package's numbers at resolution 6, and ``python -m
   repro_torch.launch.serve --smoke`` in a subprocess;
21. sharded — element-parallel sharding over ``torch.distributed`` ranks
   spawned on the one card (``torch.multiprocessing``, start method
   ``spawn``; each rank builds its own n = 64 plan and reports through a
   queue): one rank on NCCL, where the sharded assembly and each store's
   ``matfree_sharded`` solve must be bit-equal to the unsharded ones; two
   ranks on gloo (NCCL refuses two ranks on one card), where the sharded
   stiffness and load must lie within 1e-13 of max|vals| of the
   single-device B1 + B2 assembly, each store's solve take 147 ± 1
   iterations with u within 1e-8 of ``ell``'s and the same on both ranks
   bit for bit, 5 Crank–Nicolson steps on ``matfree_sharded`` lie within
   1e-10 of ``matfree``'s, ∂/∂ρ of Σu² at n = 16 within 1e-10 of the
   unsharded gradient, B1 and B2 at each rank's block match their plain
   versions (B2 bit for bit against the ordered sum), and an apply launch
   one B2 and one all-reduce a rank (its gather, action, B2 and
   all-reduce timed, and each rank's device memory read); four ranks on
   gloo at unit_cube_tet(9), whose 4,374 elements split unevenly;
22. lm — the LM harness's dense decoder family (A17a): the five ported
   architectures (qwen3-4b, qwen3-32b, deepseek-67b, nemotron-4-340b,
   internvl2-26b) at smoke width in float32 on numpy-drawn parameters
   against pinned JAX numbers (the loss, 3 optimizer steps, prefill and
   decode logits; 1e-4 relative); qwen3-4b served at full width (36
   layers, bfloat16 weights, tp_degree 1): 4 prompts of 512 tokens and 32
   greedy decode steps (finite logits; at depth 4 in float32 the decode
   logits against a full forward within 2e-2), prefill and decode times
   and peak memory; qwen3-4b trained at full width and depth 8 (AdamW,
   8 × 512 tokens in two microbatches, remat, 20 steps: finite losses and
   grad norms, the last 5 losses below the first 5, a fifth of the card
   left free), step time, tokens/s and model FLOPs; the launcher at
   ``--smoke`` with checkpoints every 10 steps, relaunched from 20 to 35;
   and what float32 results of bfloat16 contractions cost.  The path
   launches none of B1-B6;
23. lm_families — the LM harness's other five families (A17b): all ten
   architectures at smoke width against pinned JAX numbers; RWKV6 and
   Mamba2 chunked against stepwise decode, RWKV6's chunk-size invariance,
   its chunked WKV's overflow (ROADMAP C4) in the host's rows, MoE routing
   on tied gates; then at published widths (``LM_FAMILY_CELLS``, bfloat16
   serve weights, tp_degree 1): rwkv6-1.6b served (4 × 512, 32 steps) and
   trained at full depth and zamba2-7b served at 81 layers and trained at
   12, both at ssm_chunk 8 with their scans' decay sums probed (C4, C5);
   whisper-tiny served and trained on 1,500 frames; qwen3-moe-30b-a3b
   served at depth 24 and trained at depth 2; llama4-maverick-400b-a17b
   served at depth 1 (finite logits, falling losses, a fifth of the card
   free while training; prefill, decode and step times, tokens/s, peak
   memory, profiled idle shares); one MoE layer of each at 128 experts
   timed by its router, dense dispatch and combine, and expert products.
   The path launches none of B1-B6;
24. lm_layout — the LM's 2-D layout on DTensor and its dry-run tooling
   (A17c): qwen3-4b at its published widths and depth 8 on a (1, 1) mesh of
   one NCCL rank, ``jit_train_step`` against ``make_train_step`` from the
   same draw (bit-equal losses, or 1e-6), with the op counter's roofline;
   depth 2 on four gloo ranks on the card, a (2, 2) mesh: 3 steps equal on
   every rank, every loss and grad norm within 5e-3 of one rank's, the
   collective bytes tapped where DTensor calls them and equal to the op
   counter's, the elastic reshard of the weights (2, 2) → (4, 1) → (1, 4)
   bit-equal, the sharded prefill and 8 decode steps in bfloat16 compute
   within two bf16 ulps of one rank's (and in float32 compute within
   1e-4 and one ulp), a step split into compute and collectives; the
   dry-run of qwen3-4b and the perf variants baseline, seqpar and dp_attn
   on the host (started before the first phase); the launcher under
   torchrun with resume; none of B1-B6;
25. quickstart — ``examples/quickstart_torch.py`` in a subprocess against
   the numbers of ``examples/quickstart.py``;
26. kernels_offsets64 — batched B1 and B2 once past 2^31 elements in all
   (float32, ~12 GB of device memory), last, so that its allocations do
   not sit before the earlier phases' first readings.

Then the card's ``nvidia-smi`` line, the ``kernels`` summary line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; with no CUDA device it exits 2 and prints no result.

``--only`` runs the named phases alone, to hold a change against its
parent on one card: ``gradients``, ``ell_timing`` (B3/B4 at the n = 64 and
n = 96 stiffness, the n = 48 elasticity operator (L = 45), the mixed-BC
operator (L = 8) and grid operators on each side of the wide tiles'
hand-over, built for the phase), ``ell_sweep`` (B3 on the wide tiles and
on a warp per row side by side, at L = 45 and 81 on the repo's vector
operators and at L = 45-256 on grid operators: where the hand-over
belongs), ``reduce_timing`` (B2 on the n = 64 stiffness and load tables
and batched, phase 9) and ``host_cost`` (the ELL wrappers'
host time per call and the n = 64 CG loop's wall time per iteration),
``assembly_cost`` (the wall time of a warm n = 64 assembly) and
``cold_path`` (reference, main_path and transient in a fresh process: the
first n = 64 assembly and solve, and the time per θ step); or to try
``kernels_small``, ``mixed_bc``, ``elasticity``, ``batched``, ``matfree_kernel``,
``matfree``,
``opt``, ``pils``, ``elemalg``, ``serve``, ``sharded``, ``lm``, ``lm_families``,
``lm_layout``, ``quickstart`` and
``kernels_offsets64`` alone; ``trace_drops`` runs only
so: how often a profiler trace misses a B1/B2 launch that the wrappers
counted, on the matrix-free gate's window, by how the trace is opened
(after other phases: ``--only mixed_bc,elasticity,batched,trace_drops``).
``--src DIR`` imports ``repro_torch`` from ``DIR/src`` (a checkout of
another commit) instead.  Such a partial run ends with a ``partial_run``
line, never with the full run's ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import json
import math
import re
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
    "matfree_p1_diffusion": ("none (the einsum action of src/repro/core/operator.py)",
                             "src/repro_torch/kernels/csrc/matfree_p1.cu"),
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


def card_fp32(name: str) -> float:
    """float32 flop/s outside the tensor cores, from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51e12
    if "NVL" in name:
        return 60e12
    return 67e12  # H100 SXM, H200


def time_ms(fn, reps: int = 25, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches, from CUDA
    events around each; the card is kept busy while the host enqueues, so
    host overhead between launches does not enter the times.  ``flush``,
    if given, runs before each launch, outside its events (an L2 flush)."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def ordered_reduce_ref():
    """``seg_reduce_ordered_ref`` of this checkout's ``ref.py`` (it imports
    torch alone), also when ``--src`` puts another commit's package on the
    path: the kernel of either commit is held to the same ordered sum."""
    import importlib.util

    path = ROOT / "src" / "repro_torch" / "kernels" / "ref.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.seg_reduce_ordered_ref


def segments(perm, rows_sorted, n_rows):
    """A routing's segment table on the card, ``(slots, ptr)``: row ``n``'s
    local slots are ``slots[ptr[n]:ptr[n+1]]`` in sorted order (built here
    from the routing, apart from the package's builder)."""
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows_sorted, minlength=n_rows))])
    return (torch.as_tensor(perm, dtype=torch.int64, device="cuda"),
            torch.as_tensor(ptr, dtype=torch.int64, device="cuda"))


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
    bits = _stream_bit_cases()
    cases += _stream_schedule_cases(worst)
    cases += _batched_cases(worst)
    cases += _reduce_cases(worst)
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
          "b3_b5_bits_equal": bits,
          "tolerance": "max|err| <= tol * "
          "max(1, max|plain|), tol 2e-4 (float32) / 1e-12 (float64)",
          "worst_scaled_err": worst})


# B3/B4 widths: one slot, the 2D and 3D P1 stencils, each side of a power
# of two, the 3D vector P1 and Q1 stencils (45, 81), and each side of every
# hand-over between the tile kernel (up to 32 slots), the wide-tile kernel
# and a warp per row (a stage of 32 KiB or more: 85 | 86 in float64,
# 127 | 128 in float32), which the library reports
ELL_WIDTHS = (1, 7, 15, 16, 17, 32, 33, 40, 45, 47, 48, 49, 63, 64, 65, 79, 80, 81, 85, 86,
              95, 96, 97, 111, 112, 113, 127, 128, 129)
ELL_VARIANTS = ("tile_kernel", "wide_tile_kernel", "wide_kernel")  # tg_ell_variant_* order


def ell_variant(width: int, itemsize: int) -> str:
    """The kernel the library launches on rows of ``width`` slots of
    ``itemsize``-byte values."""
    from repro_torch.kernels import _cuda

    return ELL_VARIANTS[_cuda.query("spmv_ell", f"tg_ell_variant_f{8 * itemsize}", "cuda",
                                    width)]


def _ell_width_cases(worst) -> int:
    """B3/B4 against their plain versions at every width of
    ``ELL_WIDTHS``, which holds each side of every hand-over the library
    reports between its kernels, N not a multiple of 32 (one tile and a
    ragged one; many tiles), operands aligned or one element off 16
    bytes."""
    from repro_torch.kernels import galerkin_residual_ell, spmv_ell
    from repro_torch.kernels.ref import galerkin_residual_ell_ref, spmv_ell_ref

    for itemsize in (4, 8):
        kinds = [ell_variant(width, itemsize) for width in range(1, 400)]
        for width in range(1, 399):
            if kinds[width - 1] != kinds[width]:
                check({width, width + 1} <= set(ELL_WIDTHS),
                      f"ELL_WIDTHS misses a side of {width} | {width + 1} ({itemsize} bytes)")
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


def _reduce_rows(rng, case: str) -> tuple[np.ndarray, int]:
    """The row of each local slot (unsorted) and the row count of one B2
    case of ``REDUCE_CASES``."""
    if case == "empty_rows":   # every third row and the last 600 get nothing
        rows = rng.choice(np.flatnonzero(np.arange(403) % 3), size=2_501)
        return rows, 1_003
    if case.startswith("long_row_"):   # row 200 among short ones
        n, long = 517, int(case.rsplit("_", 1)[1])
        short = rng.integers(0, n - 1, size=1_551)
        short[short >= 200] += 1
        return rng.permutation(np.concatenate([short, np.full(long, 200)])), n
    n = int(case.rsplit("_", 1)[1])    # ragged: rows and slots no multiple of 32
    return rng.integers(0, n, size=3 * n + 1), n


# B2 cases beside the ragged ones of kernels_small: rows with no slots
# (runs of them), one row of 1,000 slots, one of the stage (2,048) and one
# past it (the kernel's path from global memory), row counts and slot
# counts that are no multiple of 32 or of a run
REDUCE_CASES = ("empty_rows", "long_row_1000", "long_row_2048", "long_row_2049",
                "long_row_4133", "ragged_1", "ragged_31", "ragged_33", "ragged_257",
                "ragged_4102")


def _reduce_cases(worst) -> int:
    """B2 on each of ``REDUCE_CASES``, float32 and float64, one instance
    and B ∈ {1, 3}: bit for bit against the ordered plain sum on the slot
    table, and against the plain version within the tolerance."""
    from repro_torch.kernels import _cuda, seg_reduce
    from repro_torch.kernels.ref import seg_reduce_ref
    from repro_torch.kernels.seg_reduce import ReduceTable

    ordered = ordered_reduce_ref()
    stage = _cuda.query("seg_reduce", "tg_seg_reduce_stage_slots", "cuda")
    cases = 0
    for case in REDUCE_CASES:
        rng = np.random.default_rng(len(case) + cases)
        rows, n = _reduce_rows(rng, case)
        perm = np.argsort(rows, kind="stable")
        table = ReduceTable(perm, rows[perm], rows, n, "cuda")
        slots, ptr = segments(perm, rows[perm], n)
        run_slots = (table.ptr[table.runs[1:].long()] - table.ptr[table.runs[:-1].long()]).max()
        check((int(run_slots) > stage) == case.endswith(("2049", "4133")),
              f"B2 {case}: largest run {int(run_slots)} slots against a stage of {stage}")
        for dtype in (torch.float32, torch.float64):
            for batch in (None, 1, 3):
                shape = rows.shape if batch is None else (batch, rows.shape[0])
                src = torch.as_tensor(rng.normal(size=shape), dtype=dtype, device="cuda")
                got = seg_reduce(src, table, batch=batch is not None)
                want = ordered(src, slots, ptr, batch=batch is not None)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"B2 {case} B={batch} {dtype}: not bit-equal to the ordered sum")
                err, scale = max_err(got, seg_reduce_ref(src, table.rows, n,
                                                         batch=batch is not None))
                check(err <= TOL[dtype] * scale, f"B2 {case} B={batch} {dtype}: {err}")
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


def _wide_band(rows, width):
    """ELL columns of a band ``width`` slots wide: row r reads ``width``
    columns spread evenly over r - 120 .. r + 120, clipped to the matrix."""
    offs = np.round(np.linspace(-120, 120, width)).astype(np.int64)
    return np.clip(np.arange(rows)[:, None] + offs[None, :], 0, rows - 1).astype(np.int32)


# widths past 32 slots at which B3/B4 and B5/B6 must agree bit for bit
BIT_WIDTHS = (33, 45, 64, 81)


def _stream_bit_cases() -> dict:
    """B3 against B5 and B4 against B6 with ``torch.equal`` at each width
    of ``BIT_WIDTHS`` (wide tiles, and a warp per row at 64), float32 and
    float64, on a band whose streaming plan fits shared memory: both
    kernels sum a row in the same order."""
    from repro_torch.kernels import (StreamPlan, galerkin_residual_ell,
                                     galerkin_residual_ell_stream, spmv_ell, spmv_ell_stream)

    n, out = 30_001, {}
    rng = np.random.default_rng(33)
    for width in BIT_WIDTHS:
        cols = _wide_band(n, width)
        plan, cols_dev = StreamPlan(cols, 1024), torch.as_tensor(cols, device="cuda")
        for dtype in (torch.float32, torch.float64):
            vals, x, f = (torch.as_tensor(rng.normal(size=shape), dtype=dtype, device="cuda")
                          for shape in ((n, width), n, n))
            out[f"L={width} {str(dtype)[6:]}"] = (
                torch.equal(spmv_ell(vals, cols_dev, x), spmv_ell_stream(vals, plan, x))
                and torch.equal(galerkin_residual_ell(vals, cols_dev, x, f),
                                galerkin_residual_ell_stream(vals, plan, x, f)))
    check(all(out.values()), f"B3/B4 and B5/B6 differ in bits: {out}")
    return out


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
        if (ev.device_type != DeviceType.CUDA or ev.key.startswith("tg.")
                or "spin_kernel" in ev.key):  # _open_trace's pad
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


def _heat_rollout(prob, backend, spec=None):
    """The Crank–Nicolson integrator of the heat equation on ``prob``'s
    assembler and condenser (solver ``spec``, CG at 1e-10 by default), and
    u0 = sin(πx)sin(πy)sin(πz) on the free DoFs."""
    from repro_torch.core import weakform as wf
    from repro_torch.transient import CRANK_NICOLSON, ThetaIntegrator

    integ = ThetaIntegrator.from_form(prob.asm, wf.diffusion(1.0), THETA_DT,
                                      theta=CRANK_NICOLSON, bc=prob.bc, backend=backend,
                                      spec=spec)
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


def ell_design(n: int, width: int, itemsize: int = 8) -> dict | None:
    """B3/B4's launch at (N, L) with ``itemsize``-byte values, as the
    library reports it: the kernel, grid, warps per CTA, dynamic shared
    memory per CTA, and for the tile kernels rows per warp tile and tiles
    in flight per warp; None for a library without the query (an earlier
    commit's)."""
    from repro_torch.kernels import _cuda

    if not hasattr(_cuda._library("spmv_ell"), "tg_ell_variant_f64"):
        return None
    bits = 8 * itemsize
    kernel = ell_variant(width, itemsize)
    out = {"kernel": kernel,
           "grid": _cuda.query("spmv_ell", f"tg_ell_grid_f{bits}", "cuda", n, width),
           "warps_per_cta": {"tile_kernel": 4, "wide_tile_kernel": 1, "wide_kernel": 8}[kernel],
           "smem_bytes_per_cta": _cuda.query("spmv_ell", f"tg_ell_smem_f{bits}", "cuda", width)}
    if kernel != "wide_kernel":
        out.update(rows_per_tile=32, tiles_in_flight=1)
    return out


def grid_operator(width: int, dtype=torch.float64, n: int = 40):
    """A FEM-like vector CSR operator: 3 components on each node of an n³
    grid, node k coupled to the ceil(L/3) grid offsets nearest it (up to 3
    apart); a row takes the first L of those (offset, component) columns
    that lie in the grid, so interior rows are L wide.  Random values of
    ``dtype``."""
    from repro_torch.core.sparse import CSR

    c = -(-width // 3)
    r = np.arange(-3, 4)
    off = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    off = off[np.lexsort((off[:, 2], off[:, 1], off[:, 0], (off ** 2).sum(1)))][:c]
    ijk = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3)
    nb = ijk[:, None, :] + off[None]
    keep = np.repeat(((nb >= 0) & (nb < n)).all(-1), 3, axis=1)
    keep[:, width:] = False
    node = (nb[..., 0] * n + nb[..., 1]) * n + nb[..., 2]
    cols = np.sort(np.where(keep, (3 * node[:, :, None] + np.arange(3)).reshape(keep.shape),
                            3 * n ** 3), axis=1)  # the kept columns first, in order
    counts = keep.sum(1)
    first = np.repeat(np.arange(3 * c)[None, :] < counts[:, None], 3, axis=0)
    indices = np.repeat(cols, 3, axis=0)[first]
    indptr = np.concatenate([[0], np.cumsum(np.repeat(counts, 3))])
    vals = torch.as_tensor(np.random.default_rng(width).normal(size=indices.size), dtype=dtype,
                           device="cuda")
    return CSR.from_arrays(vals, indptr, indices, (3 * n ** 3, 3 * n ** 3))


# grid operators at the elasticity stencil's width and on each side of the
# wide tiles' hand-over to a warp per row, as dtype -> widths: 85 | 86 in
# float64 and 127 | 128 in float32
GRID_WIDTHS = {torch.float64: (45, 85, 86), torch.float32: (127, 128)}
# phase ell_sweep: widths on each side of the hand-over and well past it,
# on grid operators of SWEEP_GRIDS³ nodes
SWEEP_WIDTHS = {torch.float64: (40, 45, 48, 56, 64, 72, 80, 81, 85, 86, 96, 105, 128, 160,
                                201),
                torch.float32: (64, 127, 128, 129, 160, 201, 256)}
SWEEP_GRIDS = (40, 48)
SWEEP_HEX_N = 47  # ElasticityProblem(unit_cube_hex(47)): 331,776 DoFs, rows 81 wide


def ell_rows(ops: dict, bound, rng, bound32=None) -> dict:
    """B3/B4 on each CSR operator of ``ops`` (label -> CSR, the first the
    main row), in the dtype of its values: error against the plain
    version, times, bound (``bound``, or ``bound32`` for float32 values)
    and design figures.  ``requested_bytes`` counts what the kernel asks
    of the memory system: vals and cols staged once, one x element
    gathered per slot (from L2 or HBM: which was not measured), y [and f]
    once."""
    from repro_torch.core import csr_to_ell
    from repro_torch.kernels import galerkin_residual_ell, spmv_ell
    from repro_torch.kernels.ref import galerkin_residual_ell_ref, spmv_ell_ref

    out = {}
    for label, op in ops.items():
        ell = csr_to_ell(op)
        n, width = ell.vals.shape
        dtype, item = op.vals.dtype, op.vals.element_size()
        x = torch.as_tensor(rng.normal(size=n), dtype=dtype, device="cuda")
        f = torch.as_tensor(rng.normal(size=n), dtype=dtype, device="cuda")
        a_lib = torch.sparse_csr_tensor(torch.as_tensor(op.indptr, device="cuda"),
                                        torch.as_tensor(op.indices, device="cuda"), op.vals,
                                        size=op.shape)
        design = ell_design(n, width, item)
        for name, fn, ref, lib, extra in (
            ("spmv_ell", lambda: spmv_ell(ell.vals, ell.cols_dev, x),
             lambda: spmv_ell_ref(ell.vals, ell.cols_dev, x), lambda: a_lib @ x, 0),
            ("galerkin_residual_ell", lambda: galerkin_residual_ell(ell.vals, ell.cols_dev, x, f),
             lambda: galerkin_residual_ell_ref(ell.vals, ell.cols_dev, x, f),
             lambda: torch.addmv(f, a_lib, x, beta=-1.0), 1),
        ):
            err, scale = max_err(fn(), ref())
            check(err <= TOL[dtype] * scale, f"{name} {label}: {err}")
            err_lib, _ = max_err(lib(), ref())
            check(err_lib <= TOL[dtype] * scale,
                  f"{name} {label}: library call disagrees: {err_lib}")
            # the bound: vals, cols, x, y [, f] once each
            nbytes = (item + 4) * n * width + item * n * (2 + extra)
            b_ms, b_by = (bound32 if dtype == torch.float32 else bound)(nbytes,
                                                                        2 * op.nnz + extra * n)
            row = {"shape": f"N={n} L={width} nnz={op.nnz} {str(dtype)[6:]}",
                   "max_abs_err": err, "scale": scale, "ms": time_ms(fn),
                   "plain_ms": time_ms(ref), "library_ms": time_ms(lib), "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes,
                   "requested_bytes": nbytes - item * n + item * n * width, "design": design}
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
    """B3/B4 alone (``--only``) at the n = 64 and n = 96 stiffness (L =
    15, the rows of ``kernels_main``), the n = 48 elasticity operator (L =
    45) and the n_r = 256 mixed-BC operator (L = 8) that phases
    ``elasticity`` and ``mixed_bc`` solve, and the grid operators of
    ``GRID_WIDTHS``; and the wrappers' host time per call: for holding a
    change against its parent."""
    from repro_torch.core import hollow_cube_tet, unit_cube_tet, weakform as wf
    from repro_torch.fem import ElasticityProblem, PoissonProblem

    ops = {f"n{n}": PoissonProblem(unit_cube_tet(n), device="cuda").assemble(f=1.0)[0]
           for n in (MAIN_N, STREAM_N)}
    ops[f"elasticity_n{ELASTICITY_N}"] = ElasticityProblem(hollow_cube_tet(ELASTICITY_N),
                                                           device="cuda").assemble()[0]
    mixed = _mixed_problem(MIXED_N_R)
    k = mixed.asm.assemble(wf.diffusion() + wf.robin(1.0, on=mixed._fa_r))
    ops[f"mixed_bc_n{MIXED_N_R}"] = mixed.bc.apply_matrix_only(k)
    ops.update({f"grid_L{w}_{str(dtype)[6:]}": grid_operator(w, dtype)
                for dtype, widths in GRID_WIDTHS.items() for w in widths})
    rows = ell_rows(ops, bounder(bw, fp64), np.random.default_rng(7),
                    bounder(bw, card_fp32(torch.cuda.get_device_name(0))))
    emit({"phase": "ell_timing", "rows": rows, "host_us_per_call": wrapper_host_us()})
    return rows


def phase_ell_sweep(bw, fp64):
    """B3 on the wide tiles and on a warp per row side by side (``--only``;
    ``tg_spmv_ell_as_*`` launches the kernel it is given): the repo's
    operators past 32 slots (the n = 48 elasticity operator, L = 45; vector
    Q1 hexes, ``ElasticityProblem(unit_cube_hex(47))``, L = 81) and the
    grid operators of ``SWEEP_GRIDS`` and ``SWEEP_WIDTHS``, each against
    the plain version and the two kernels bit for bit: where the library
    should hand rows from one kernel to the other."""
    from repro_torch.core import csr_to_ell, hollow_cube_tet, unit_cube_hex
    from repro_torch.fem import ElasticityProblem
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.ref import spmv_ell_ref

    ops = {f"elasticity_n{ELASTICITY_N}": lambda: ElasticityProblem(
               hollow_cube_tet(ELASTICITY_N), device="cuda").assemble()[0],
           f"hex_elasticity_n{SWEEP_HEX_N}": lambda: ElasticityProblem(
               unit_cube_hex(SWEEP_HEX_N), device="cuda").assemble()[0]}
    for dtype, widths in SWEEP_WIDTHS.items():
        for grid in SWEEP_GRIDS:
            for w in widths:
                ops[f"grid{grid}_L{w}_{str(dtype)[6:]}"] = (
                    lambda w=w, dtype=dtype, grid=grid: grid_operator(w, dtype, grid))
    bounds = {torch.float64: bounder(bw, fp64),
              torch.float32: bounder(bw, card_fp32(torch.cuda.get_device_name(0)))}
    rng = np.random.default_rng(11)
    rows = {}
    for label, make in ops.items():
        op = make()
        ell = csr_to_ell(op)
        n, width = ell.vals.shape
        dtype, item = op.vals.dtype, op.vals.element_size()
        x = torch.as_tensor(rng.normal(size=n), dtype=dtype, device="cuda")
        want = spmv_ell_ref(ell.vals, ell.cols_dev, x)
        row = {"shape": f"N={n} L={width} nnz={op.nnz} {str(dtype)[6:]}",
               "library_picks": ell_variant(width, item)}
        outs = []
        for variant, kernel in ((1, "wide_tile_kernel"), (2, "wide_kernel")):
            y = torch.empty(n, dtype=dtype, device="cuda")

            def fn(variant=variant, y=y):
                _cuda.launch("spmv_ell", "spmv_ell", _cuda.symbol("tg_spmv_ell_as", dtype),
                             ell.vals, ell.cols_dev, x, y, n, width, variant)

            fn()
            err, scale = max_err(y, want)
            check(err <= TOL[dtype] * scale, f"ell_sweep {label} {kernel}: {err}")
            outs.append(y)
            row[f"{kernel}_ms"] = time_ms(fn)
        check(torch.equal(*outs), f"ell_sweep {label}: the two kernels' bits differ")
        row["bound_ms"], row["bound_by"] = bounds[dtype]((item + 4) * n * width + 2 * item * n,
                                                         2 * op.nnz)
        row["wide_tiles_over_warp_per_row"] = row["wide_tile_kernel_ms"] / row["wide_kernel_ms"]
        rows[label] = row
        del op, ell, outs
    emit({"phase": "ell_sweep", "rows": rows})
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


def reduce_bytes(table, batch: int) -> int:
    """The bytes of B2's work, whatever reads them: the source read and the
    output written once per instance (8 B each), one int32 slot index per
    contribution and one int32 offset per row."""
    return 8 * batch * (table.n_src + table.n_rows) + 4 * table.n_src + 4 * (table.n_rows + 1)


def reduce_width(table) -> int:
    """The most contributions any row of a B2 table receives."""
    counts = torch.bincount(table.rows, minlength=table.n_rows)
    return int(counts.max()) if counts.numel() else 0


def phase_reduce_timing(prob, bw, fp64) -> dict:
    """B2 alone (``--only``; also in the full run) at n = 64: on the
    stiffness table, on the load table (its ~78 MB working set is near the
    50 MB L2, so L2 is flushed before each launch) and batched, B = 8, on
    the stiffness table against 8 single launches; each bit for bit against
    the ordered plain sum on the slot table (and the batched one against
    its single launches), and timed beside its plain version and
    ``index_add_``.  The bound reads only ``n_src`` and ``n_rows``, so the
    phase runs on another commit's package too (``--src``)."""
    from repro_torch.kernels import seg_reduce
    from repro_torch.kernels.ref import seg_reduce_ref

    if prob is None:
        from repro_torch.core import unit_cube_tet
        from repro_torch.fem import PoissonProblem

        prob = PoissonProblem(unit_cube_tet(MAIN_N), device="cuda")
    plan, ordered, bound = prob.plan, ordered_reduce_ref(), bounder(bw, fp64)
    vr = plan.vec_routing
    gen = torch.Generator(device="cuda").manual_seed(19)
    l2 = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for label, table, (perm, rows_sorted), batch, flush in (
            ("stiffness", plan.mat_reduce, (plan.mat_routing.perm, plan.mat_routing.seg_ids),
             None, None),
            ("load", plan.vec_reduce, (vr.perm, vr.touched[vr.seg_ids]), None, l2.zero_),
            ("stiffness_batched", plan.mat_reduce,
             (plan.mat_routing.perm, plan.mat_routing.seg_ids), BATCH, None)):
        n_inst = batch or 1
        shape = (table.n_src,) if batch is None else (batch, table.n_src)
        src = torch.randn(shape, generator=gen, dtype=torch.float64, device="cuda")
        is_b = batch is not None
        got = seg_reduce(src, table, batch=is_b)
        slots, ptr = segments(perm, rows_sorted, table.n_rows)
        bits = bool(torch.equal(got, ordered(src, slots, ptr, batch=is_b)))
        del slots, ptr
        err, scale = max_err(got, seg_reduce_ref(src, table.rows, table.n_rows, batch=is_b))
        nbytes = reduce_bytes(table, n_inst)
        b_ms, b_by = bound(nbytes, n_inst * table.n_src)
        row = {"shape": f"rows={table.n_rows} src={table.n_src}", "B": n_inst,
               "bit_equal_ordered": bits, "max_abs_err": err, "scale": scale,
               "l2_flushed": flush is not None,
               "ms": time_ms(lambda: seg_reduce(src, table, batch=is_b), flush=flush),
               "plain_ms": time_ms(lambda: seg_reduce_ref(src, table.rows, table.n_rows,
                                                          batch=is_b), flush=flush),
               "library_ms": time_ms(lambda: torch.zeros(got.shape, dtype=src.dtype,
                                                         device="cuda").index_add_(
                   -1, table.rows, src), flush=flush),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        if is_b:
            singles = torch.stack([seg_reduce(src[b], table) for b in range(batch)])
            row["bit_equal_single"] = bool(torch.equal(got, singles))
            row["single_x_B_ms"] = time_ms(lambda: [seg_reduce(src[b], table)
                                                    for b in range(batch)])
            del singles
        row["share"] = row["bound_ms"] / row["ms"]
        rows[label] = row
        del src, got
    del l2
    torch.cuda.empty_cache()
    emit({"phase": "reduce_timing", "n": MAIN_N, "rows": rows})
    for label, row in rows.items():
        check(row["bit_equal_ordered"] and row.get("bit_equal_single", True),
              f"reduce_timing {label}: not bit-equal {row}")
        check(row["max_abs_err"] <= 1e-12 * row["scale"], f"reduce_timing {label}: {row}")
    return rows


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
    nbytes = reduce_bytes(table, 1)
    b_ms, b_by = bound(nbytes, table.n_src)
    rows["seg_reduce"] = {
        "shape": f"rows={table.n_rows} L={reduce_width(table)} src={table.n_src}",
        "table_device_bytes": sum(t.numel() * t.element_size()
                                  for t in (table.slots, table.ptr, table.runs)),
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


OPEN_TRACE_PAD = 1024


def _open_trace() -> None:
    """Open a counted torch.profiler trace with OPEN_TRACE_PAD throwaway
    ``spin_kernel`` launches and a sync.  On an H100 a trace loses the
    device records of its first few kernels, however long it waits before
    them: 5 in most traces after the mixed-BC, elasticity and batched
    phases, up to 59, none or 2 in a fresh process (``--only
    trace_drops``), and once 258 (a serve capture in a full run).  The
    pad's kernels take that loss, so that the launches to count are not
    among the first."""
    for _ in range(OPEN_TRACE_PAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _lost_records(prof) -> list:
    """Host launch calls of a trace that have no device kernel record
    (paired by CUPTI correlation id): their start, in µs from the trace's
    start."""
    kernels_seen = {e.id for e in prof.events() if e.device_type == DeviceType.CUDA}
    return sorted(e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CPU and e.id not in kernels_seen
                  and re.match(r"cu(da)?LaunchKernel", e.name))


def _kernel_calls(prof) -> dict:
    """Device kernel launches of a torch.profiler trace by the name of each
    of this repository's kernels."""
    names = {"p1_stiffness_kernel": "local_stiffness_p1",
             "p1_diffusion_kernel": "matfree_p1_diffusion", "seg_reduce_kernel": "seg_reduce",
             "tile_kernel": "spmv_ell/residual (tiles)",
             "wide_tile_kernel": "spmv_ell/residual (wide tiles)",
             "wide_kernel": "spmv_ell/residual (warp per row)"}
    out = dict.fromkeys(names.values(), 0)
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        for key, label in names.items():
            if re.search(rf"\b{key}\b", ev.key):  # tile_kernel is not wide_tile_kernel
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
        _open_trace()
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
          and calls["spmv_ell/residual (wide tiles)"] == 0
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
    on `ell`, whose rows are 45 wide (B3/B4 take the wide-tile kernel);
    a scipy residual on the host; the un-condensed K through B3 on the six
    rigid-body modes; the JAX package's numbers at n = 4 and 8; B3/B4's
    times at L = 45 and on the float64 grid operators of ``GRID_WIDTHS``."""
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
        _open_trace()
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
    grids = {f"grid_L{w}": grid_operator(w) for w in GRID_WIDTHS[torch.float64]}
    rows = ell_rows({"n48": kc, **grids}, bounder(bw, fp64), np.random.default_rng(45))
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
    # rows 45 wide: B3 (2·iters + 1) and B4 (1) on the wide-tile kernel;
    # the assembly's two Reduces on B2, no B1 (a vector space)
    check(calls["spmv_ell/residual (wide tiles)"] == 2 * res_prof.iters + 2
          and calls["spmv_ell/residual (warp per row)"] == 0
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
        _open_trace()
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
    b2_bytes = reduce_bytes(table, BATCH)
    b1 = {"shape": f"B={BATCH} tet E={e}", "max_abs_err": err1, "scale": scale1,
          "ms": time_ms(lambda: local_stiffness_p1(coords, rho_e)),
          "single_x_B_ms": time_ms(lambda: [local_stiffness_p1(coords, rho_e[b])
                                            for b in range(BATCH)]),
          "plain_ms": time_ms(lambda: local_stiffness_p1_ref(coords, rho_e)),
          "library_ms": None, "bytes": b1_bytes,
          "launches": asm_launches["local_stiffness_p1"]}
    b1["bound_ms"], b1["bound_by"] = bound(b1_bytes, P1_FLOPS[3] * e * BATCH)
    b2 = {"shape": f"B={BATCH} rows={table.n_rows} L={reduce_width(table)} src={table.n_src}",
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


# The JAX package's numbers for NewtonKrylovIntegrator on unit_square_tri(8):
# Allen–Cahn r(u) = −u(u²−1), κ = 1e-2, dt = 1e-3, 4 Newton iterations, CG at
# tol = atol = 1e-12, u0 = sin(πx)sin(πy) on the free DoFs (the set-up of
# tests/test_transient.py), measured on the CPU: per step max u, ‖u‖₂ and the
# Krylov iterations of the step's Newton updates.
JAX_ALLEN_CAHN = {
    "max_u": [0.9999790773207442, 0.9999547718354254, 0.9999271731771893,
              0.9998963689778884, 0.999862444911567],
    "norm": [4.000689345237632, 4.0013867484930605, 4.002092029231528, 4.002805011235624,
             4.003525522491766],
    "iters": [21] * 5,
}
ALLEN_CAHN_N, ALLEN_CAHN_STEPS = 512, 5
MATFREE_STORES = ("context", "coords", "local")
PROFILED_ITERS = 30


def _allen_cahn(n):
    """The Newton–Krylov Allen–Cahn integrator on unit_square_tri(n) and
    its initial state."""
    from repro_torch.core import SolverSpec, unit_square_tri, weakform as wf
    from repro_torch.fem import PoissonProblem
    from repro_torch.transient import NewtonKrylovIntegrator

    prob = PoissonProblem(unit_square_tri(n), device="cuda")
    asm = prob.asm
    nk = NewtonKrylovIntegrator(
        asm, asm.assemble(wf.mass(1.0)), asm.assemble(wf.diffusion(1.0)), dt=1e-3,
        reaction=lambda u: -u * (u ** 2 - 1.0), diffusion_scale=1e-2, bc=prob.bc,
        newton_iters=4, spec=SolverSpec(method="cg", tol=1e-12, atol=1e-12))
    pts = torch.as_tensor(prob.space.dof_points, dtype=torch.float64, device="cuda")
    return nk, torch.sin(math.pi * pts[:, 0]) * torch.sin(math.pi * pts[:, 1]) * prob.bc.free_mask


def _matfree_window(plan, bc, load, store):
    """A matrix-free solve's device work over a window that a trace reads
    in seconds: the operator's build (B1 for ``store="local"``), the
    Jacobi diagonal (B2), CG's first residual and PROFILED_ITERS
    iterations (B2 in each apply)."""
    from repro_torch.core import cg, jacobi_preconditioner, matfree_operator, weakform as wf

    op = matfree_operator(plan, wf.diffusion(None), store=store).condensed(bc)
    return cg(op, load, m=jacobi_preconditioner(op), maxiter=PROFILED_ITERS)


# bytes an element of the fused P1 diffusion action's work (tgbench's
# action_work: the 4×3 gradients, the measure, ρ and x_e read, y_e written,
# in float64) and what the kernel moves from memory besides (the Q = 4
# measures and the int64 indices; x gathered from L2)
MF_WORK_BYTES, MF_MOVED_BYTES = 176, 96 + 32 + 8 + 32 + 32
MF_KERNEL_N = 96


def _matfree_kernel_cases(worst) -> int:
    """The fused kernel against its plain twin on ragged element counts,
    float64 and float32, every coefficient encoding and layout it reads."""
    from repro_torch import kernels
    from repro_torch.core import FunctionSpace, build_plan, element_for_mesh
    from repro_torch.core import unit_cube_tet, unit_square_tri
    from repro_torch.kernels.ref import matfree_p1_diffusion_ref

    cases = 0
    for gen, n in ((unit_cube_tet, 7), (unit_square_tri, 13)):
        m = gen(n)
        plan = build_plan(FunctionSpace(m, element_for_mesh(m)), device="cuda")
        ctx = plan.context()
        for dtype in (torch.float64, torch.float32):
            grad, detj, w = ctx.grad.to(dtype), ctx.detj.to(dtype), ctx.w.to(dtype)
            e, q = detj.shape
            x = torch.randn(plan.num_dofs, dtype=dtype, device="cuda")
            rho_e = torch.rand(e, dtype=dtype, device="cuda") + 0.5
            rho_q = torch.rand((e, q), dtype=dtype, device="cuda") + 0.5
            rho_t = (torch.rand((q, e), dtype=dtype, device="cuda") + 0.5).t()
            dev_scale = torch.tensor(0.7, dtype=dtype, device="cuda")
            full = (plan.cell_dofs, grad, detj, w)
            variants = {
                "cell_expand": (full, rho_e[:, None].expand(e, q), 0.7),
                "quad": (full, rho_q, dev_scale),
                "quad_transposed": (full, rho_t, 1.3),
                "none": (full, None, 1.0),
                "number": (full, 2.5, 0.5),
                "one_point": ((plan.cell_dofs, grad[:, :1], detj[:, :1], w[:1]), rho_e[:, None],
                              1.0),
            }
            for lo, hi in ((0, 1), (0, 127), (5, 134), (e // 3, e)):  # ragged tiles, a block
                cd, g, dj, _ = full
                variants[f"block_{lo}_{hi}"] = ((cd[lo:hi], g[lo:hi], dj[lo:hi], w),
                                                rho_q[lo:hi], dev_scale)
            for label, ((cd, g, dj, ww), rho, scale) in variants.items():
                got = kernels.matfree_p1_diffusion(x, cd, g, dj, ww, rho, scale)
                want = matfree_p1_diffusion_ref(x, cd, g, dj, ww, rho, scale)
                err, mag = max_err(got, want)
                tol = (1e-13 if dtype == torch.float64 else 1e-5) * mag
                check(err <= tol, f"matfree_p1_diffusion {gen.__name__}({n}) {dtype} {label}: "
                                  f"{err} > {tol}")
                key = str(dtype)
                worst[key] = max(worst.get(key, 0.0), err / mag)
                cases += 1
    return cases


def phase_matfree_kernel(bw, fp64, ptxas=None):
    """The fused P1 diffusion action (``kernels.matfree_p1_diffusion``,
    ``csrc/matfree_p1.cu``): ``ptxas -v``; the kernel against its plain
    twin (:func:`_matfree_kernel_cases`); at unit_cube_tet(16) one apply
    launches it once and B2 once and no cuBLAS kernel (wrappers and a
    profiler trace), and the matrix-free solve is within 1e-8 of ``ell``'s
    in as many iterations ±1; at n = 96 (5,308,416 tets, the
    ``poisson96.matfree`` cell's mesh) the kernel's time against its bound
    and against the einsum action it replaces, a whole apply each way, and
    one matrix-free solve on the context store at ρ = 1 (iterations, time,
    the kernel's launches against the ``matfree_action`` counter)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels, telemetry
    from repro_torch.core import matfree_operator, unit_cube_tet, weakform as wf
    from repro_torch.core.assembly import reduce_vector
    from repro_torch.fem import PoissonProblem

    proc = start_ptxas("matfree_p1") if ptxas is None else None
    worst = {}
    cases = _matfree_kernel_cases(worst)
    ptxas = ptxas_report(proc) if proc is not None else ptxas

    prob = PoissonProblem(unit_cube_tet(16), device="cuda")
    plan = prob.plan
    rho = torch.rand(plan.num_cells, dtype=torch.float64, device="cuda") + 0.5
    op = matfree_operator(plan, wf.diffusion(rho))
    x = torch.randn(plan.num_dofs, dtype=torch.float64, device="cuda")
    op.matvec(x)
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _open_trace()
        y = op.matvec(x)
        torch.cuda.synchronize()
    wrappers = {k: v for k, v in kernels.LAUNCHES.items() if v}
    calls, lost = _kernel_calls(prof), len(_lost_records(prof))
    library = sorted({ev.key[:70] for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA
                      and re.search(r"gemv|gemm|cublas", ev.key, re.I)})
    err16, mag16 = max_err(y, prob.asm.assemble(wf.diffusion(rho)).matvec(x))
    mf, ell = prob.solve(f=1.0, backend="matfree"), prob.solve(f=1.0, backend="ell")
    path16 = {"wrapper_launches": wrappers, "profiled_kernel_calls": calls,
              "lost_records": lost, "library_kernels": library,
              "apply_vs_assembled": err16 / mag16, "iters": mf.iters, "ell_iters": ell.iters,
              "max_abs_diff_vs_ell": float((mf.u - ell.u).abs().max())}
    check(wrappers == {"matfree_p1_diffusion": 1, "seg_reduce": 1},
          f"matfree_kernel: one apply launched {wrappers}")
    check(calls["matfree_p1_diffusion"] == 1 and calls["seg_reduce"] == 1 and not library,
          f"matfree_kernel: the trace of one apply {path16}")
    check(err16 <= 1e-12 * mag16, f"matfree_kernel: apply against the assembled matvec {path16}")
    check(abs(mf.iters - ell.iters) <= 1 and path16["max_abs_diff_vs_ell"] <= 1e-8,
          f"matfree_kernel: the n = 16 solve against ell {path16}")
    del prob, plan, op

    # n = 96: the cell's mesh
    t0 = time.perf_counter()
    prob = PoissonProblem(unit_cube_tet(MF_KERNEL_N), device="cuda")
    setup_s = time.perf_counter() - t0
    plan, bc = prob.plan, prob.bc
    e = plan.num_cells
    op = matfree_operator(plan, wf.diffusion(None))
    ctx = op.ctx
    x = torch.randn(plan.num_dofs, dtype=torch.float64, device="cuda")
    args = (x, plan.cell_dofs, ctx.grad, ctx.detj, ctx.w)
    xe = x[plan.cell_dofs]
    kernel_ms = time_ms(lambda: kernels.matfree_p1_diffusion(*args))
    einsum_ms = time_ms(lambda: op._local_apply(xe, False))
    gather_ms = time_ms(lambda: x[plan.cell_dofs])
    err, mag = max_err(kernels.matfree_p1_diffusion(*args), op._local_apply(xe, False))
    apply_ms = time_ms(lambda: op.matvec(x))
    einsum_apply_ms = time_ms(lambda: reduce_vector(op._local_apply(x[plan.cell_dofs], False),
                                                    plan))
    bound_ms = 1e3 * MF_WORK_BYTES * e / bw
    moved_ms = 1e3 * MF_MOVED_BYTES * e / bw
    # one matrix-free solve at ρ = 1 on the context store
    kernels.reset_launches()
    telemetry.reset()
    with telemetry.enabled():
        res, solve_s = timed(lambda: prob.solve(f=1.0, backend="matfree"))
        counters = telemetry.snapshot()["counters"]
    telemetry.reset()
    fused = counters.get("matfree_action{path=fused}", 0)
    solve = {"iters": res.iters, "wall_s": solve_s, "ms_per_iter": 1e3 * solve_s / res.iters,
             "residual": res.residual, "converged": res.converged,
             "kernel_launches": kernels.LAUNCHES["matfree_p1_diffusion"],
             "seg_reduce_launches": kernels.LAUNCHES["seg_reduce"],
             "matfree_action": {"fused": fused,
                                "einsum": counters.get("matfree_action{path=einsum}", 0)}}
    out = {"phase": "matfree_kernel", "ptxas": ptxas, "cases": cases, "worst_rel_err": worst,
           "n16": path16,
           "n96": {"elements": e, "dofs": plan.num_dofs, "setup_s": setup_s,
                   "kernel_ms": kernel_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                   "share": bound_ms / kernel_ms, "moved_bytes_per_elem": MF_MOVED_BYTES,
                   "moved_gb_per_s": MF_MOVED_BYTES * e / kernel_ms / 1e6,
                   "moved_share": moved_ms / kernel_ms, "einsum_action_ms": einsum_ms,
                   "gather_ms": gather_ms, "max_rel_err_vs_einsum": err / mag,
                   "apply_ms": apply_ms, "einsum_apply_ms": einsum_apply_ms, "solve": solve,
                   "peak_bytes_per_s": bw}}
    emit(out)
    check(err <= 1e-13 * mag, f"matfree_kernel: n = 96 kernel against the einsum {err / mag}")
    check(res.converged and fused == solve["kernel_launches"] > 0 and
          counters.get("matfree_action{path=einsum}", 0) == 0,
          f"matfree_kernel: the n = 96 solve {solve}")
    return {"ms": kernel_ms, "plain_ms": einsum_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "max_abs_err": err, "shape": f"tet E = {e:,}",
            "launches": solve["kernel_launches"]}


def phase_matfree(prob):
    """Matrix-free operators (A9) and the time stepping on them (A12) at
    n = 64, on the main path's plan and condenser: ``PoissonProblem.solve(
    backend="matfree")`` for each store against the ``ell`` solve (B2 once
    per apply, B1 for ``store="local"``, by the wrappers' counts over the
    solve and a profiler trace of the build and 30 iterations, the same
    window for every store; the apply's gather,
    action and scatter timed apart); ∂/∂ρ of Σu² through ``matfree_solve``
    against ``sparse_solve``; a family of 8 fields on the ``local`` store
    (one batched B1 launch; ``matvec`` and ``diagonal`` one batched B2
    launch each; ``matfree_solve_batched`` against 8 single solves); 20
    Crank–Nicolson steps on matrix-free operators, timed at the default
    tolerance and held against the ``csr`` rollout there (1e-6), then
    against the ``ell`` and ``csr`` rollouts at a tolerance that resolves
    1e-8 (iterations against ``csr``'s: both start each solve from zero,
    ``ell`` from uⁿ); and
    Allen–Cahn with ``NewtonKrylovIntegrator`` on unit_square_tri(512)
    (263,169 DoFs) and, against the JAX package's numbers, at n = 8."""
    from torch.autograd.function import BackwardCFunction
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core import (SolverSpec, assemble, assemble_rhs, matfree_family,
                                  matfree_operator, matfree_solve, matfree_solve_batched,
                                  sparse_solve, weakform as wf)
    from repro_torch.core.assembly import reduce_vector

    if prob is None:
        from repro_torch.core import unit_cube_tet
        from repro_torch.fem import PoissonProblem

        prob = PoissonProblem(unit_cube_tet(MAIN_N), device="cuda")
    plan, bc, n = prob.plan, prob.bc, prob.space.num_dofs
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ref = prob.solve(f=1.0)
    gates, walls = [], {}  # gates are read after the phase's line is out

    def gate(cond, what):
        gates.append((bool(cond), what))

    t_section = time.perf_counter()

    def section(name):
        nonlocal t_section
        now = time.perf_counter()
        walls[name] = now - t_section
        t_section = now

    # the path: the first solve of each store, counted from 0 around the three
    kernels.reset_launches()
    firsts = {}
    for store in MATFREE_STORES:
        before = dict(kernels.LAUNCHES)
        res, first_s = timed(lambda: prob.solve(f=1.0, backend="matfree", store=store))
        firsts[store] = (res, first_s, {k: v - before[k] for k, v in kernels.LAUNCHES.items()})
    launches = dict(kernels.LAUNCHES)

    csr_vals_bytes = 8 * plan.nnz
    csr_bytes = csr_vals_bytes + 8 * plan.nnz + 8 * (n + 1)
    load = bc.project_residual(assemble_rhs(plan, wf.source(1.0)))
    stores = {}
    for store in MATFREE_STORES:
        res, first_s, counts = firsts[store]
        _, warm_s = timed(lambda: prob.solve(f=1.0, backend="matfree", store=store))

        kernels.reset_launches()
        with profile(activities=acts) as prof:
            _open_trace()
            _, prof_s = timed(lambda: _matfree_window(plan, bc, load, store))
        traced_launches = dict(kernels.LAUNCHES)
        busy_ms, top = _device_time(prof)
        calls = _kernel_calls(prof)
        op_full = matfree_operator(plan, wf.diffusion(None), store=store)
        op = op_full.condensed(bc)
        x = ref.u.clone()
        xe = x[plan.cell_dofs]
        y_local = op._local_apply(xe, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        op.matvec(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        applies = res.iters + 2  # CG's first residual, one per iteration, the final residual
        row = {"iters": res.iters, "ell_iters": ref.iters, "residual": res.residual,
               "converged": res.converged, "max_u": float(res.u.max()),
               "max_abs_diff_vs_ell": float((res.u - ref.u).abs().max()),
               "first_s": first_s, "warm_s": warm_s,
               "profiled": {"window": f"build + diagonal + {PROFILED_ITERS} CG iterations",
                            "wall_ms": 1e3 * prof_s, "device_busy_ms": busy_ms,
                            "device_busy_share": busy_ms / (1e3 * prof_s), "top_kernels": top,
                            "kernel_calls": calls, "wrapper_launches": traced_launches,
                            "lost_records": len(_lost_records(prof))},
               "applies": applies, "launches": counts,
               "apply_ms": time_ms(lambda: op.matvec(x)),
               "gather_ms": time_ms(lambda: x[plan.cell_dofs]),
               "action_ms": time_ms(lambda: op._local_apply(xe, False)),
               "fused_action_ms": (None if store == "local" else
                                   time_ms(lambda: op._fused_action(x, *op._fused_terms(x)))),
               "scatter_ms": time_ms(lambda: reduce_vector(y_local, plan)),
               "apply_peak_bytes": peak, "state_bytes": op_full.state_bytes(),
               "csr_vals_bytes": csr_vals_bytes, "csr_bytes": csr_bytes}
        stores[store] = row
        section(store)
        b1 = 1 if store == "local" else 0
        gate(res.converged, f"matfree {store}: not converged")
        gate(abs(res.iters - ref.iters) <= 1 and abs(res.iters - 147) <= 1,
             f"matfree {store}: {res.iters} iterations against ell's {ref.iters}")
        gate(row["max_abs_diff_vs_ell"] <= 1e-8, f"matfree {store}: u differs from ell {row}")
        gate(0.0555 <= row["max_u"] <= 0.0565, f"matfree {store}: max u {row['max_u']}")
        # B2 once per apply, besides the load's Reduce and the Jacobi diagonal
        # (a solve; a window: the diagonal and CG's first residual)
        lost = f"; the trace lost {row['profiled']['lost_records']} kernel records"
        for label, got, want in (("wrappers", counts, applies + 2),
                                 ("profiler", calls, PROFILED_ITERS + 2)):
            gate(got["seg_reduce"] == want,
                 f"matfree {store}: B2 launched {got['seg_reduce']} times, not {want} "
                 f"({label}{lost})")
            gate(got["local_stiffness_p1"] == b1,
                 f"matfree {store}: B1 launched {got['local_stiffness_p1']} times ({label}{lost})")
        gate(counts["spmv_ell"] == 0 and counts["galerkin_residual_ell"] == 0,
             f"matfree {store}: launched B3/B4 {counts}")
        # the fused P1 diffusion action once per apply, but on stored element matrices
        fused = store != "local"
        for label, got, want in (("wrappers", counts, applies if fused else 0),
                                 ("profiler", calls, PROFILED_ITERS + 1 if fused else 0)):
            gate(got["matfree_p1_diffusion"] == want,
                 f"matfree {store}: the fused action launched {got['matfree_p1_diffusion']} "
                 f"times, not {want} ({label}{lost})")

    # the gradient through matfree_solve against sparse_solve's
    spec12 = SolverSpec(method="cg", tol=1e-12, atol=1e-12)
    x_mid = plan.coords[:, :, 0].mean(dim=1)

    def grad_of(solve):
        rho = (1.0 + x_mid).requires_grad_(True)
        u, info = solve(rho)
        return torch.autograd.grad((u ** 2).sum(), rho)[0], info

    kernels.reset_launches()
    (g_mf, i_mf), grad_mf_s = timed(lambda: grad_of(lambda r: matfree_solve(
        matfree_operator(plan, wf.diffusion(r)).condensed(bc), load, spec12, return_info=True)))
    grad_launches = dict(kernels.LAUNCHES)
    (g_sp, i_sp), grad_sp_s = timed(lambda: grad_of(lambda r: sparse_solve(
        bc.apply_matrix_only(assemble(plan, wf.diffusion(r))), load, spec12, return_info=True)))
    grad_rel = float((g_mf - g_sp).abs().max() / g_sp.abs().max())
    grad = {"rel_diff_vs_sparse_solve": grad_rel, "iters": i_mf.iters,
            "sparse_iters": i_sp.iters, "wall_s": grad_mf_s, "sparse_wall_s": grad_sp_s,
            "launches": grad_launches}
    gate(grad_rel <= 1e-6, f"matfree gradient against sparse_solve's: {grad_rel}")
    # the apply that the backward differentiates scatters through B2's
    # autograd Function (taken where the source requires grad); the walk
    # stops at a custom Function's node, whose inputs torch does not expose
    op_g = matfree_operator(plan, wf.diffusion((1.0 + x_mid).requires_grad_(True)))
    nodes, todo = set(), [op_g.condensed(bc).matvec(load).grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in nodes:
            nodes.add(type(fn).__name__)
            if not isinstance(fn, BackwardCFunction):
                todo.extend(f for f, _ in fn.next_functions)
    grad["apply_graph_has_seg_reduce_function"] = "_SegReduceBackward" in nodes
    gate(grad["apply_graph_has_seg_reduce_function"],
         f"matfree gradient: the apply's graph has no B2 Function: {sorted(nodes)}")

    section("gradient")

    # a family of 8 fields on the shared plan, its element matrices formed
    # by one batched B1 launch (store="local")
    rho_b = torch.stack([1.0 + 0.5 * b * x_mid for b in range(BATCH)])
    kernels.reset_launches()
    fam = matfree_family(plan, wf.diffusion(rho_b[0]), leaves_batch=(rho_b, None),
                         store="local").condensed(bc)
    fam_launches = {"build_b1": kernels.LAUNCHES["local_stiffness_p1"]}
    gate(fam_launches["build_b1"] == 1, f"family: B1 launched {fam_launches['build_b1']} times")
    xb = torch.as_tensor(np.random.default_rng(3).normal(size=(BATCH, n)), device="cuda")
    for name, fn in (("matvec", lambda: fam.matvec(xb)), ("diagonal", fam.diagonal)):
        kernels.reset_launches()
        out = fn()
        fam_launches[name] = kernels.LAUNCHES["seg_reduce"]
        single = torch.stack([fam[b].matvec(xb[b]) if name == "matvec" else fam[b].diagonal()
                              for b in range(BATCH)])
        err, scale = max_err(out, single)
        gate(fam_launches[name] == 1, f"family {name}: B2 launched {fam_launches[name]} times")
        gate(err <= 1e-12 * scale, f"family {name}: {err} against 8 single applies")
        fam_launches[f"{name}_max_abs_err"] = err
    with profile(activities=acts) as prof:
        _open_trace()
        fam.matvec(xb)
        fam.diagonal()
        torch.cuda.synchronize()
    fam_calls, fam_lost = _kernel_calls(prof), len(_lost_records(prof))
    gate(fam_calls["seg_reduce"] == 2, f"family: the profiler saw {fam_calls}")
    section("family_applies")
    (xs, info_b), fam_solve_s = timed(lambda: matfree_solve_batched(fam, load, return_info=True))
    fam_rows = []
    for b in range(BATCH):
        x1, i1 = matfree_solve(fam[b], load, return_info=True)
        fam_rows.append({"b": b, "iters": int(info_b.iters[b]), "single_iters": i1.iters,
                         "rel_diff": float((xs[b] - x1).abs().max() / x1.abs().max())})
    for row in fam_rows:
        gate(row["rel_diff"] <= 1e-10 and row["iters"] == row["single_iters"],
             f"matfree_solve_batched: instance against its single solve {row}")
    family = {"B": BATCH, "store": "local", "launches": fam_launches,
              "profiled_kernel_calls": fam_calls, "profiled_lost_records": fam_lost,
              "matvec_ms": time_ms(lambda: fam.matvec(xb)),
              "single_x_B_matvec_ms": time_ms(lambda: [fam[b].matvec(xb[b])
                                                       for b in range(BATCH)]),
              "solve_batched_s": fam_solve_s, "rows": fam_rows}
    section("family")

    # Crank–Nicolson on matrix-free operators: the rollout at the default
    # tolerance, timed and counted; then matfree, csr and ell at a tolerance
    # that resolves 1e-8 (at tol = atol = 1e-10 each solve may stop ~1e-7
    # apart in u: the absolute floor, over λ_min(M + θΔtK) ~ h³)
    mf_integ, u0 = _heat_rollout(prob, "matfree")
    kernels.reset_launches()
    (traj, info), theta_s = timed(lambda: mf_integ.rollout(u0, THETA_STEPS, return_info=True))
    theta_launches = dict(kernels.LAUNCHES)
    section("theta_default")
    iters = info.iters.tolist()
    traj_csr, info_csr = _heat_rollout(prob, "csr")[0].rollout(u0, THETA_STEPS, return_info=True)
    decay = math.exp(-3 * math.pi**2 * THETA_DT * THETA_STEPS)
    tight = SolverSpec(method="cg", tol=1e-12, atol=1e-15)
    runs = {be: _heat_rollout(prob, be, spec=tight)[0].rollout(u0, THETA_STEPS, return_info=True)
            for be in ("matfree", "csr", "ell")}
    (t_mf, i_mf), (t_csr, i_csr), (t_ell, i_ell) = runs.values()
    theta = {"iters": iters, "wall_s": theta_s, "wall_ms_per_step": 1e3 * theta_s / THETA_STEPS,
             "max_u_ratio": float(traj[-1].max() / u0.max()), "expected_ratio": decay,
             "launches": theta_launches, "csr_iters": info_csr.iters.tolist(),
             "max_rel_diff_vs_csr": float((traj - traj_csr).abs().max() / traj_csr.abs().max()),
             "tight": {"tol": tight.tol, "atol": tight.atol, "iters": i_mf.iters.tolist(),
                       "csr_iters": i_csr.iters.tolist(), "ell_iters": i_ell.iters.tolist(),
                       "max_rel_diff_vs_csr": float((t_mf - t_csr).abs().max()
                                                    / t_csr.abs().max()),
                       "max_rel_diff_vs_ell": float((t_mf - t_ell).abs().max()
                                                    / t_ell.abs().max())}}
    gate(bool(info.converged.all()) and all(bool(i.converged.all()) for _, i in runs.values()),
         "matfree θ rollout did not converge")
    gate(abs(theta["max_u_ratio"] / decay - 1) <= 0.01, f"matfree θ rollout: decay {theta}")
    # the timed rollout against csr's at the same tolerance: both start each
    # solve from zero; 1e-6 is 16 times the 6.3e-8 that the stopping rule
    # left between them on an H100
    gate(bool(info_csr.converged.all()) and theta["max_rel_diff_vs_csr"] <= 1e-6,
         f"matfree θ rollout at the default tolerance against csr's: "
         f"{theta['max_rel_diff_vs_csr']}")
    # per step: the rhs apply, CG's first residual, one per iteration; the
    # Jacobi diagonal once (cached on the condensed operator)
    gate(theta_launches["seg_reduce"] == 2 * THETA_STEPS + sum(iters) + 1,
         f"matfree θ rollout: B2 launched {theta_launches['seg_reduce']} times")
    tt = theta["tight"]
    gate(tt["max_rel_diff_vs_ell"] <= 1e-8 and tt["max_rel_diff_vs_csr"] <= 1e-8,
         f"matfree θ rollout against ell / csr: {tt}")
    # each matfree solve starts from zero, as csr's; ell's from uⁿ
    gate(max(abs(a - b) for a, b in zip(tt["iters"], tt["csr_iters"])) <= 1,
         f"matfree θ rollout: iterations {tt['iters']} against csr's {tt['csr_iters']}")
    section("theta")

    # Allen–Cahn with Newton–Krylov: the JAX package's numbers at n = 8, then n = 512
    nk8, u08 = _allen_cahn(8)
    traj8, info8 = nk8.rollout(u08, ALLEN_CAHN_STEPS, return_info=True)
    small = {"max_u": traj8.max(dim=1).values.tolist(),
             "norm": torch.linalg.vector_norm(traj8, dim=1).tolist(),
             "iters": info8.iters.tolist()}
    for key in ("max_u", "norm"):
        dev = max(abs(a - b) for a, b in zip(small[key], JAX_ALLEN_CAHN[key]))
        small[f"{key}_max_abs_diff_vs_jax"] = dev
        gate(dev <= 1e-10, f"Allen–Cahn n=8: {key} {small[key]} against {JAX_ALLEN_CAHN[key]}")
    gate(max(abs(a - b) for a, b in zip(small["iters"], JAX_ALLEN_CAHN["iters"])) <= 1,
         f"Allen–Cahn n=8: iterations {small['iters']}")
    (nk, u0), ac_setup_s = timed(lambda: _allen_cahn(ALLEN_CAHN_N))
    kernels.reset_launches()
    (traj, info), ac_s = timed(lambda: nk.rollout(u0, ALLEN_CAHN_STEPS, return_info=True))
    ac_launches = dict(kernels.LAUNCHES)
    g_norm = float(torch.linalg.vector_norm(nk.residual(traj[-2], traj[-1])))
    allen_cahn = {"n": ALLEN_CAHN_N, "dofs": int(u0.shape[0]), "setup_s": ac_setup_s,
                  "wall_s": ac_s, "wall_ms_per_step": 1e3 * ac_s / ALLEN_CAHN_STEPS,
                  "iters": info.iters.tolist(), "last_residual_norm": g_norm,
                  "max_u": float(traj[-1].max()), "launches": ac_launches, "jax_n8": small}
    gate(bool(torch.isfinite(traj).all()) and bool(info.converged.all()),
         "Allen–Cahn n=512: not finite or not converged")
    gate(g_norm < 1e-8, f"Allen–Cahn n=512: ‖G(u)‖ = {g_norm}")

    section("allen_cahn")
    for name in ("local_stiffness_p1", "seg_reduce"):
        gate(launches[name] > 0, f"matfree path: kernel {name} never launched")
    out = {"phase": "matfree", "n": MAIN_N, "dofs": n, "elements": plan.num_cells,
           "launches": launches, "stores": stores, "gradient": grad, "family": family,
           "theta": theta, "allen_cahn": allen_cahn, "section_walls_s": walls,
           "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    for ok, what in gates:
        check(ok, what)
    return out


# The JAX package's numbers for the paper's 60×30 cantilever
# (CantileverProblem() at its defaults), measured on the CPU and held
# against the JAX package by tests/test_torch_opt.py: at ρ = 0.5 the
# compliance, ‖∂C/∂ρ‖₂ and the CG iterations of the solve; then the
# compliances C(ρ_k) of the first 3 MMA iterates (the loop of
# examples/topology_optimization.py).
JAX_CANTILEVER = {"compliance": 43.39550515685954, "sens_norm": 9.913248529980333,
                  "iters": 470,
                  "mma_compliance": [33.4513131774414, 26.749118857975834, 22.487469042101708]}
OPT_STEPS, MULTISTART_SEED = 10, 8
# The JAX package's TensorPILS losses over 10 Adam steps (lr 1e-3) of the
# paper's SIREN (2→64×4→1, ω0 = 30) made by siren_numpy(0), on the K = 4
# checkerboard of examples/poisson_pils.py at unit_square_tri(16), measured
# on the CPU and held against the JAX package by
# tests/test_torch_pils_training.py.
JAX_PILS_ADAM = [0.8335716640085153, 0.990513486717317, 0.6366382229217824,
                 0.24314631847024376, 0.14807424069927264, 0.08274758577354219,
                 0.06442600162323092, 0.045399329219243625, 0.03417688593898358,
                 0.031836226930561276]
PILS_GATE_N, PILS_TIME_N, PILS_K = 16, 256, 4
PILS_HIST_STEPS, PILS_WINDOWS, AGN_EPOCHS = 20, 3, 5
# Adam steps in one timed window at unit_square_tri(256), 1.5–3 s each on
# an H100
PILS_WINDOW_STEPS = {"tensorpils_csr": 400, "tensorpils_ell": 400,
                     "tensorpils_matfree": 400, "pinn": 55}


# The JAX package's numbers for the element tensor algebra (A11), measured
# on the CPU and held against the JAX package by tests/test_torch_elemalg.py:
# the outer CG iterations and max u of PoissonProblem(unit_square_tri(64),
# degree=2).solve(backend="matfree", condensed=True) at CG tol = atol =
# 1e-12, and the CG iterations of matfree_solve with each preconditioner on
# the condensed anisotropic P1 operator (diag(100, 1)) at unit_square_tri(32)
# (tol = atol = 1e-10, the set-up of tests/test_elemalg.py).
JAX_ELEMALG = {"condensed_n": 64, "condensed_iters": 77, "condensed_max_u": 0.0736713542419238,
               "precond_n": 32, "precond_iters": {"jacobi": 152, "ebe": 107, "chebyshev": 68}}


def siren_numpy(seed: int, hidden: int = 64, depth: int = 4, omega0: float = 30.0) -> dict:
    """A SIREN parameter tree drawn with numpy (the reference's init bounds:
    ±1/d_in for the first layer, ±√(6/d_in)/ω0 after it; zero biases), so
    that the JAX package and the port start from the same weights."""
    rng = np.random.default_rng(seed)
    dims = [2] + [hidden] * depth + [1]
    layers = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / d_in if i == 0 else math.sqrt(6.0 / d_in) / omega0
        layers.append({"w": rng.uniform(-bound, bound, (d_in, d_out)), "b": np.zeros(d_out)})
    return {"layers": layers, "omega0": np.float64(omega0)}


def checkerboard(lib, k: int = PILS_K):
    """The K-checkerboard source sign(sin(Kπx)·sin(Kπy)) of
    examples/poisson_pils.py, on ``lib`` (torch or jax.numpy)."""
    return lambda x: lib.sign(lib.sin(k * math.pi * x[..., 0] + 1e-9)
                              * lib.sin(k * math.pi * x[..., 1] + 1e-9))


def phase_opt():
    """TensorOpt (A13a) on the paper's 60×30 cantilever (3,782 DoFs, 1,800
    Q1 elements): compliance and its autograd sensitivity at ρ = 0.5
    against the JAX package's pinned numbers and Eq. B.28; 10 MMA and 10
    OC iterations (the first 3 MMA compliances pinned); a multistart
    family of B = 8 (one batched B2 launch in ``compliance_batch``, each
    instance equal to its single call).  Gates are read after the phase's
    line is out."""
    from repro_torch import kernels
    from repro_torch.opt import CantileverProblem, MMAState, mma_update, oc_update

    gates, walls = [], {}
    t_phase = time.perf_counter()

    def gate(cond, what):
        gates.append((bool(cond), what))

    prob, walls["setup_s"] = timed(lambda: CantileverProblem(device="cuda"))
    n = prob.n_elem
    rho0 = torch.full((n,), 0.5, dtype=torch.float64, device="cuda")
    kernels.reset_launches()
    prob.compliance_and_sensitivity(rho0)  # first call: the einsum Map's kernels load
    (c0, g0), walls["sensitivity_s"] = timed(lambda: prob.compliance_and_sensitivity(rho0))
    _, info = prob._displacement(rho0)
    g_an = prob.analytic_sensitivity(rho0)
    ref = JAX_CANTILEVER
    single = {"compliance": float(c0), "sens_norm": float(torch.linalg.vector_norm(g0)),
              "iters": info.iters,
              "eq_b28_max_rel": float(((g0 - g_an).abs() / g_an.abs()).max())}
    single["compliance_rel_diff_vs_jax"] = abs(single["compliance"] / ref["compliance"] - 1)
    single["sens_norm_rel_diff_vs_jax"] = abs(single["sens_norm"] / ref["sens_norm"] - 1)
    gate(info.converged and abs(info.iters - ref["iters"]) <= 1,
         f"opt: CG iterations {info.iters} against the JAX package's {ref['iters']}")
    gate(single["compliance_rel_diff_vs_jax"] <= 1e-9, f"opt: compliance {single}")
    gate(single["sens_norm_rel_diff_vs_jax"] <= 1e-7, f"opt: ‖∂C/∂ρ‖ {single}")
    gate(single["eq_b28_max_rel"] <= 1e-5, f"opt: Eq. B.28 {single}")

    def filtered(rho, g):
        return prob.filter(g * rho) / torch.clamp(rho, min=1e-3)

    # MMA, the loop of examples/topology_optimization.py
    rho = rho0
    state = MMAState(low=rho - 0.5, upp=rho + 0.5)
    dg = torch.full((n,), 1.0 / n, dtype=torch.float64, device="cuda")
    mma_c = []
    t0 = time.perf_counter()
    for _ in range(OPT_STEPS):
        c, g = prob.compliance_and_sensitivity(rho)
        mma_c.append(float(c))
        rho, state = mma_update(rho, filtered(rho, g), rho.mean() - prob.volfrac, dg, state)
    c_end, _ = prob.compliance_and_sensitivity(rho)
    torch.cuda.synchronize()
    walls["mma_s_per_iter"] = (time.perf_counter() - t0) / OPT_STEPS
    mma = {"compliance": mma_c + [float(c_end)], "volume": float(prob.volume(rho)),
           "ratio": float(c_end) / mma_c[0]}
    mma["first3_max_rel_diff_vs_jax"] = max(
        abs(a / b - 1) for a, b in zip(mma_c[1:4], ref["mma_compliance"]))
    gate(mma["first3_max_rel_diff_vs_jax"] <= 1e-8,
         f"opt: MMA compliances {mma_c[1:4]} against the JAX package's {ref['mma_compliance']}")
    gate(mma["ratio"] < 0.8 and mma["volume"] <= prob.volfrac + 1e-2, f"opt: MMA run {mma}")

    rho = rho0
    oc_c = []
    t0 = time.perf_counter()
    for _ in range(OPT_STEPS):
        c, g = prob.compliance_and_sensitivity(rho)
        oc_c.append(float(c))
        rho = oc_update(rho, filtered(rho, g), prob.volfrac)
    c_end, _ = prob.compliance_and_sensitivity(rho)
    torch.cuda.synchronize()
    walls["oc_s_per_iter"] = (time.perf_counter() - t0) / OPT_STEPS
    oc = {"compliance": oc_c + [float(c_end)], "volume": float(prob.volume(rho)),
          "ratio": float(c_end) / oc_c[0]}
    gate(oc["ratio"] < 0.7 and abs(oc["volume"] - prob.volfrac) < 1e-3, f"opt: OC run {oc}")

    # the multistart family: one batched assembly (B2 once), B solves
    rho_b = torch.as_tensor(np.random.default_rng(MULTISTART_SEED).uniform(0.3, 0.9, (BATCH, n)),
                            device="cuda")
    before = dict(kernels.LAUNCHES)
    c_b, walls["compliance_batch_s"] = timed(lambda: prob.compliance_batch(rho_b))
    batch_launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    (c_s, g_b), walls["sensitivity_batch_s"] = timed(
        lambda: prob.compliance_and_sensitivity_batch(rho_b))
    t0 = time.perf_counter()
    singles = [prob.compliance_and_sensitivity(rho_b[b]) for b in range(BATCH)]
    torch.cuda.synchronize()
    walls["sensitivity_8_singles_s"] = time.perf_counter() - t0
    (rho_next, _), walls["multistart_step_s"] = timed(lambda: prob.multistart_step(rho_b))
    launches = dict(kernels.LAUNCHES)
    multistart = {
        "B": BATCH, "launches_compliance_batch": batch_launches,
        "max_rel_diff_c": max(abs(float(c_b[b]) / float(s[0]) - 1) for b, s in enumerate(singles)),
        "max_rel_diff_c_sens": max(abs(float(c_s[b]) / float(s[0]) - 1)
                                   for b, s in enumerate(singles)),
        "max_rel_diff_grad": max(float(torch.linalg.vector_norm(g_b[b] - s[1])
                                       / torch.linalg.vector_norm(s[1]))
                                 for b, s in enumerate(singles)),
        "volumes_after_step": rho_next.mean(dim=1).tolist()}
    gate(batch_launches["seg_reduce"] == 1 and batch_launches["local_stiffness_p1"] == 0,
         f"opt: compliance_batch launched {batch_launches}")
    gate(multistart["max_rel_diff_c"] <= 1e-10 and multistart["max_rel_diff_c_sens"] <= 1e-10
         and multistart["max_rel_diff_grad"] <= 1e-10, f"opt: multistart {multistart}")
    gate(launches["seg_reduce"] > 0, "opt path: kernel seg_reduce never launched")
    walls["phase_s"] = time.perf_counter() - t_phase
    out = {"phase": "opt", "nx": 60, "ny": 30, "elements": n, "dofs": prob.space.num_dofs,
           "single": single, "mma": mma, "oc": oc, "multistart": multistart, "walls_s": walls,
           "launches": launches, "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    for ok, what in gates:
        check(ok, what)
    return out


def _pils_problem(n):
    from repro_torch.core import (DirichletCondenser, FunctionSpace, GalerkinAssembler,
                                  element_for_mesh, unit_square_tri)

    mesh = unit_square_tri(n)
    space = FunctionSpace(mesh, element_for_mesh(mesh))
    asm = GalerkinAssembler(space, device="cuda")
    return space, asm, DirichletCondenser(asm, space.boundary_dofs())


def _adam_windows(loss_fns: dict, params) -> dict:
    """Adam it/s of each loss over ``PILS_WINDOWS`` rounds: after 2 warm
    steps each, every round times one window of each loss in turn
    (``PILS_WINDOW_STEPS[name]`` steps from ``params``, no loss read, so the
    device syncs only at a window's ends) → {name: [it/s a window]}."""
    from repro_torch.pils import train_adam

    for fn in loss_fns.values():
        train_adam(fn, params, 2, lr=1e-3)
    its = {name: [] for name in loss_fns}
    for _ in range(PILS_WINDOWS):
        for name, fn in loss_fns.items():
            its[name].append(train_adam(fn, params, PILS_WINDOW_STEPS[name], lr=1e-3)[2])
    return its


def phase_pils():
    """Physics-informed learning (A13b).  Gates at unit_square_tri(16) on
    the K = 4 checkerboard: the Galerkin residual loss on ``ell`` (one B4
    launch per loss and gradient) against ``csr`` (1e-9, its gradient in u
    1e-10) and ``matfree``; 10 Adam steps of the paper's SIREN (from
    ``siren_numpy(0)``) on ``csr`` and ``ell`` against the JAX package's
    pinned losses.  At unit_square_tri(256) (66,049 DoFs): 20 Adam losses
    on ``ell`` (B4) and ``matfree`` against ``csr``'s (1e-9), then Adam
    it/s for TensorPILS on ``csr``, ``ell`` and ``matfree`` and for PINN on
    the same points over 3 interleaved rounds of windows of 1.5–3 s; ``fit_family``
    over B = 8 coefficient fields (one batched B1 and one batched B2 launch
    for the family's matrices, held against their plain versions); 5 epochs of
    the wave AGN of examples/operator_learning_wave.py (finite, falling
    loss).  Gates are read after the phase's line is out."""
    from repro_torch import kernels
    from repro_torch.convert import params_from_numpy
    from repro_torch.pils import (GalerkinResidualLoss, adam_init, adam_update, fit_family,
                                  pinn_poisson_loss, siren_apply, train_adam)
    from repro_torch.pils.gnn import agn_init, agn_rollout
    from repro_torch.kernels.ref import local_stiffness_p1_ref, seg_reduce_ref

    gates, walls = [], {}
    t_phase = time.perf_counter()

    def gate(cond, what):
        gates.append((bool(cond), what))

    f = checkerboard(torch)
    kernels.reset_launches()
    space, asm, bc = _pils_problem(PILS_GATE_N)
    losses = {b: GalerkinResidualLoss(asm, bc, f=f, backend=b) for b in ("csr", "ell", "matfree")}
    build_launches = dict(kernels.LAUNCHES)
    gate(build_launches["local_stiffness_p1"] >= 1,
         f"pils: the loss build launched {build_launches}")

    # the residual loss of one u on each backend, and its gradient in u
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(space.num_dofs), device="cuda")
    residual = {}
    for backend, loss in losses.items():
        x = u.clone().requires_grad_(True)
        before = dict(kernels.LAUNCHES)
        val = loss(x)
        (g,) = torch.autograd.grad(val, x)
        residual[backend] = {"loss": float(val.detach()), "grad": g,
                             "launches": {k: kernels.LAUNCHES[k] - before[k] for k in before}}
    csr = residual["csr"]
    scale = float(csr["grad"].abs().max())
    for backend in ("ell", "matfree"):
        row = residual[backend]
        row["loss_rel_diff_vs_csr"] = abs(row["loss"] / csr["loss"] - 1)
        row["grad_max_diff_vs_csr"] = float((row["grad"] - csr["grad"]).abs().max()) / scale
        gate(row["loss_rel_diff_vs_csr"] <= 1e-9 and row["grad_max_diff_vs_csr"] <= 1e-10,
             f"pils: {backend} residual loss against csr's: {row['loss_rel_diff_vs_csr']}, "
             f"{row['grad_max_diff_vs_csr']}")
    ell_launches = residual["ell"]["launches"]
    gate(ell_launches["galerkin_residual_ell"] == 1 and ell_launches["spmv_ell"] == 0,
         f"pils: one ell loss and gradient launched {ell_launches}")
    for row in residual.values():
        del row["grad"]

    # 10 Adam steps of the paper's SIREN from numpy weights, against JAX's
    adam = {}
    for backend in ("csr", "ell"):
        params = params_from_numpy(siren_numpy(0), "cuda")
        before = dict(kernels.LAUNCHES)
        _, hist, its = train_adam(lambda p, l=losses[backend]: l.loss_from_net(siren_apply, p),
                                  params, 10, lr=1e-3, log_every=1)
        adam[backend] = {"losses": hist, "its": its,
                         "launches": {k: kernels.LAUNCHES[k] - before[k] for k in before},
                         "max_rel_diff_vs_jax": max(abs(a / b - 1)
                                                    for a, b in zip(hist, JAX_PILS_ADAM))}
        gate(adam[backend]["max_rel_diff_vs_jax"] <= 1e-8,
             f"pils: SIREN losses on {backend} {hist} against the JAX package's {JAX_PILS_ADAM}")
    gate(adam["ell"]["launches"]["galerkin_residual_ell"] == 10,
         f"pils: 10 Adam steps on ell launched {adam['ell']['launches']}")

    # unit_square_tri(256): ell (B4) and matfree (einsum Map, B2) against
    # csr (B1, B2, the CSR matvec) over 20 Adam losses, then the times
    (space, asm, bc), walls["setup_n256_s"] = timed(lambda: _pils_problem(PILS_TIME_N))
    params = params_from_numpy(siren_numpy(0), "cuda")
    rates, loss_fns, hists = {}, {}, {}
    for backend in ("csr", "ell", "matfree"):
        loss, build_s = timed(lambda b=backend: GalerkinResidualLoss(asm, bc, f=f, backend=b))
        name = f"tensorpils_{backend}"
        loss_fns[name] = lambda p, l=loss: l.loss_from_net(siren_apply, p)
        before = dict(kernels.LAUNCHES)
        hists[name] = train_adam(loss_fns[name], params, PILS_HIST_STEPS, lr=1e-3,
                                 log_every=1)[1]
        rates[name] = {"build_s": build_s, "first_loss": hists[name][0],
                       "last_loss": hists[name][-1],
                       "hist_launches": {k: kernels.LAUNCHES[k] - before[k] for k in before}}
    hist_csr = hists["tensorpils_csr"]
    gate(all(math.isfinite(v) for v in hist_csr) and hist_csr[-1] < hist_csr[0],
         f"pils: TensorPILS on csr at n = {PILS_TIME_N}: {hist_csr}")
    for backend in ("ell", "matfree"):
        row = rates[f"tensorpils_{backend}"]
        row["hist_max_rel_diff_vs_csr"] = max(
            abs(a / b - 1) for a, b in zip(hists[f"tensorpils_{backend}"], hist_csr))
        gate(row["hist_max_rel_diff_vs_csr"] <= 1e-9,
             f"pils: {PILS_HIST_STEPS} Adam losses on {backend} at n = {PILS_TIME_N} "
             f"{hists[f'tensorpils_{backend}']} against csr's {hist_csr}")
    ell_hist_launches = rates["tensorpils_ell"]["hist_launches"]
    gate(ell_hist_launches["galerkin_residual_ell"] == PILS_HIST_STEPS,
         f"pils: {PILS_HIST_STEPS} Adam steps on ell at n = {PILS_TIME_N} launched "
         f"{ell_hist_launches}")
    pts = torch.as_tensor(space.dof_points, device="cuda")
    free = bc.free_mask.to(torch.bool)
    interior, boundary = pts[free], pts[~free]
    f_int = f(interior[None])[0]
    loss_fns["pinn"] = lambda p: pinn_poisson_loss(siren_apply, p, interior, f_int, boundary)
    hist = train_adam(loss_fns["pinn"], params, PILS_HIST_STEPS // 2, lr=1e-3, log_every=1)[1]
    rates["pinn"] = {"points": int(interior.shape[0]), "first_loss": hist[0],
                     "last_loss": hist[-1]}
    gate(all(math.isfinite(v) for v in hist), f"pils: PINN losses {hist}")
    windows, walls["rate_windows_s"] = timed(lambda: _adam_windows(loss_fns, params))
    for name, its in windows.items():
        rates[name].update({"its": float(np.median(its)), "its_windows": its,
                            "window_steps": PILS_WINDOW_STEPS[name]})

    # fit_family over B = 8 coefficient fields
    rho_b = torch.as_tensor(np.random.default_rng(11).uniform(0.5, 2.0,
                                                             (BATCH, space.mesh.num_cells)),
                            device="cuda")
    before = dict(kernels.LAUNCHES)
    fit_family(asm, bc, rho_b, steps=2, lr=1e-3)
    family_launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    (u_fit, hist, its, fam_loss), walls["fit_family_s"] = timed(
        lambda: fit_family(asm, bc, rho_b, steps=200, lr=1e-3, log_every=50))
    r_single = GalerkinResidualLoss(asm, bc, rho=rho_b[3]).residual(u_fit[3])
    table = asm.plan.mat_reduce
    k_plain = bc.apply_matrix_only(asm.plan.batched_csr(seg_reduce_ref(
        local_stiffness_p1_ref(asm.plan.coords, rho_b), table.rows, table.n_rows, batch=True)))
    k_err, k_scale = max_err(fam_loss.k.vals, k_plain.vals)
    family = {"B": BATCH, "its": its, "losses": hist, "launches_build": family_launches,
              "k_max_abs_err": k_err, "k_scale": k_scale,
              "single_rel_diff": float((fam_loss.residual(u_fit)[3] - r_single).abs().max()
                                       / r_single.abs().max())}
    gate(k_err <= TOL[torch.float64] * k_scale,
         f"pils: fit_family's batched K against the plain B1 and B2: {k_err} (scale {k_scale})")
    gate(family_launches["local_stiffness_p1"] == 1 and family_launches["seg_reduce"] == 2,
         f"pils: fit_family's batched build launched {family_launches}")
    gate(all(math.isfinite(v) for v in hist) and hist[-1] < hist[0], f"pils: fit_family {hist}")
    gate(family["single_rel_diff"] <= 1e-12, f"pils: family instance against its single loss "
                                             f"{family['single_rel_diff']}")

    # 5 epochs of the wave AGN of examples/operator_learning_wave.py
    w, n_bundles = 4, 8
    (tp, trajs, coords, edges, deg), walls["agn_setup_s"] = timed(
        lambda: _agn_setup(w, n_bundles))
    params = agn_init(torch.Generator().manual_seed(1), w, w, hidden=32, n_layers=3,
                      device="cuda")

    def agn_loss(p):
        tot = 0.0
        for traj in trajs[:4]:
            pred = agn_rollout(p, traj[:w].T, coords, edges, deg, n_bundles, tp.interior)
            tot = tot + tp.wave_trajectory_loss(torch.cat([traj[w - 2:w], pred.T]),
                                                normalized=True)
        return tot / 4

    state = adam_init(params)
    vg = torch.func.grad_and_value(agn_loss)
    agn_hist = []
    t0 = time.perf_counter()
    for _ in range(AGN_EPOCHS):
        grads, val = vg(params)
        params, state = adam_update(params, grads, state, 1e-3)
        agn_hist.append(float(val))
    walls["agn_s_per_epoch"] = (time.perf_counter() - t0) / AGN_EPOCHS
    gate(all(math.isfinite(v) for v in agn_hist) and agn_hist[-1] < agn_hist[0],
         f"pils: AGN losses {agn_hist}")
    launches = dict(kernels.LAUNCHES)
    for name in ("local_stiffness_p1", "seg_reduce", "galerkin_residual_ell"):
        gate(launches[name] > 0, f"pils path: kernel {name} never launched")
    walls["phase_s"] = time.perf_counter() - t_phase
    out = {"phase": "pils", "gate_n": PILS_GATE_N, "time_n": PILS_TIME_N,
           "time_dofs": space.num_dofs, "build_launches": build_launches,
           "residual": residual, "adam": adam, "rates": rates, "family": family,
           "agn": {"losses": agn_hist, "nodes": int(coords.shape[0])}, "walls_s": walls,
           "launches": launches, "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    for ok, what in gates:
        check(ok, what)
    return out


def _agn_setup(w, n_bundles):
    """The wave problem of examples/operator_learning_wave.py on
    disk_tri(6): four training trajectories from the Newmark reference
    (initial conditions from a torch.Generator), the element graph and
    degrees on the card."""
    from repro_torch.core import disk_tri
    from repro_torch.pils.gnn import element_graph_edges
    from repro_torch.pils.operator import TimeDependentProblem, random_initial_condition
    from repro_torch.transient import batched_rollout

    tp = TimeDependentProblem(disk_tri(6), dt=5e-4, c=4.0, device="cuda")
    edges = element_graph_edges(tp.mesh.cells)
    deg = np.maximum(np.bincount(edges[:, 1], minlength=tp.mesh.num_vertices), 1.0)
    gen = torch.Generator().manual_seed(0)
    u0s = torch.stack([random_initial_condition(gen, tp.space.dof_points, device="cuda")
                       * tp.bc.free_mask for _ in range(4)])
    refs = batched_rollout(tp.newmark_integrator(), u0s, w + w * n_bundles)
    trajs = [torch.cat([u0s[i][None], refs[i]]) for i in range(4)]
    return (tp, trajs, torch.as_tensor(tp.mesh.points, device="cuda"),
            torch.as_tensor(edges, device="cuda"), torch.as_tensor(deg, device="cuda"))


# Element tensor algebra (A11): static condensation of P2 at
# unit_square_tri(ELEMALG_COND_N) (263,169 DoFs, 66,049 vertices as the
# interface), the preconditioners on anisotropic P1 Poisson (diag(100, 1))
# at unit_square_tri(ELEMALG_PRECOND_N) (263,169 DoFs), the gradient at
# the pins' size.
ELEMALG_COND_N, ELEMALG_PRECOND_N = 256, 512
ANISO_TENSOR = ((100.0, 0.0), (0.0, 1.0))
# The inner CG tolerance of the condensed solves that the 1e-8 and 1e-9
# gates read.  The default inner solve stops at ‖r_i‖ ≤ 1e-12 (absolute at
# these loads: ‖f_i‖ ≈ 2e-3), which leaves u_cond 1.7e-8·max|u| from the
# uncondensed solution at n = 256 and the interior rows near 1e-13 (the port
# on the CPU, as the JAX package's algorithm does); at 1e-15 they are
# 2.6e-11·max|u| apart.
ELEMALG_TIGHT_INNER = 1e-15


def _aniso_problem(n):
    """The condensed anisotropic P1 operator (diag(100, 1), ``context``
    store) on unit_square_tri(n) and its masked unit load."""
    from repro_torch.core import (DirichletCondenser, FunctionSpace, GalerkinAssembler,
                                  element_for_mesh, matfree_operator, unit_square_tri,
                                  weakform as wf)

    mesh = unit_square_tri(n)
    space = FunctionSpace(mesh, element_for_mesh(mesh, 1))
    asm = GalerkinAssembler(space, device="cuda")
    bc = DirichletCondenser(asm, space.boundary_dofs())
    a = torch.tensor(ANISO_TENSOR, dtype=torch.float64, device="cuda")
    op = matfree_operator(asm.plan, wf.anisotropic_diffusion(a)).condensed(bc)
    return op, bc.project_residual(asm.assemble_rhs(wf.source(1.0)))


def phase_elemalg(prob):
    """Element tensor algebra (A11).  The path, counted from 0 around it:
    ``PoissonProblem(unit_square_tri(256), degree=2).solve(backend="matfree",
    condensed=True)``, then on the main path's problem (n = 64) CG with
    ``precond="ebe"`` on the matrix-free ``coords`` store (B1 once, in the
    EbE build; B2 once per operator apply and per EbE apply) and with
    ``precond="chebyshev"`` on ``ell`` (B3 per iteration, B4 once), each
    also counted by a profiler trace.  Then: the condensed solve against
    the uncondensed ``matfree`` and ``ell`` solves (fewer outer iterations;
    at a tight inner tolerance u within 1e-8·max|u| of ``ell``'s and the
    interior residual rows of a loose outer solve ≤ 1e-9·‖f‖∞); the n = 64
    condensed solve and the n = 32 anisotropic counts against the JAX
    package's pins; jacobi, ebe and chebyshev on anisotropic P1 at
    unit_square_tri(512); ∂/∂ρ of Σu² through ``condensed_solve`` against
    ``sparse_solve`` (1e-8 relative); B2 on the scaffold's compact tables
    bit for bit against the ordered plain sum; CUDA-event times of
    ``factorize``, ``ElementFactors.solve``, one EbE and one Chebyshev
    apply, one Schur apply.  Gates are read after the phase's line is
    out."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core import (SolverSpec, assemble, assemble_rhs, condense, condensed_solve,
                                  factorize, make_preconditioner, masked_element_matrices,
                                  matfree_operator, matfree_solve, sparse_solve, unit_cube_tet,
                                  unit_square_tri, vertex_split, weakform as wf)
    from repro_torch.fem import PoissonProblem
    from repro_torch.kernels import seg_reduce

    gates, walls, times = [], {}, {}
    t_phase = time.perf_counter()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def gate(cond, what):
        gates.append((bool(cond), what))

    def since(before):
        return {k: kernels.LAUNCHES[k] - before[k] for k in before}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    if prob is None:
        prob = PoissonProblem(unit_cube_tet(MAIN_N), device="cuda")
    p2, walls["setup_p2_s"] = timed(
        lambda: PoissonProblem(unit_square_tri(ELEMALG_COND_N), degree=2, device="cuda"))
    cg12 = SolverSpec(method="cg", tol=1e-12, atol=1e-12)
    tight = SolverSpec(method="cg", tol=ELEMALG_TIGHT_INNER, atol=ELEMALG_TIGHT_INNER,
                       maxiter=2000)  # the default inner spec's, at a tighter tolerance
    ebe_spec = SolverSpec(method="cg", precond="ebe")
    cheb_spec = SolverSpec(method="cg", precond="chebyshev")

    # -- the path ----------------------------------------------------------
    kernels.reset_launches()
    (cond, cond_info), walls["condensed_first_s"] = timed(
        lambda: p2.solve(backend="matfree", condensed=True, spec=cg12, return_info=True))
    cond_launches = dict(kernels.LAUNCHES)
    main = {}
    for name, call in (
            ("ebe", lambda: prob.solve(f=1.0, backend="matfree", store="coords", spec=ebe_spec)),
            ("chebyshev", lambda: prob.solve(f=1.0, spec=cheb_spec))):
        before = dict(kernels.LAUNCHES)
        with profile(activities=acts) as prof:
            _open_trace()
            res, first_s = timed(call)
        main[name] = {"res": res, "first_s": first_s, "launches": since(before),
                      "kernel_calls": _kernel_calls(prof),
                      "lost_records": len(_lost_records(prof))}
    launches = dict(kernels.LAUNCHES)
    for kname in MAIN_KERNELS:
        gate(launches[kname] > 0, f"elemalg path: kernel {kname} never launched")

    # -- static condensation at n = 256 -----------------------------------
    _, walls["condensed_warm_s"] = timed(
        lambda: p2.solve(backend="matfree", condensed=True, spec=cg12))
    full, walls["matfree_first_s"] = timed(lambda: p2.solve(backend="matfree", spec=cg12))
    _, walls["matfree_warm_s"] = timed(lambda: p2.solve(backend="matfree", spec=cg12))
    ell, walls["ell_first_s"] = timed(lambda: p2.solve(spec=cg12))
    _, walls["ell_warm_s"] = timed(lambda: p2.solve(spec=cg12))
    plan, bc = p2.plan, p2.bc
    op = matfree_operator(plan, wf.diffusion(None)).condensed(bc)
    f = bc.project_residual(assemble_rhs(plan, wf.source(1.0)))
    split = vertex_split(p2.space)
    (u_t, info_t), walls["condensed_tight_s"] = timed(
        lambda: condensed_solve(op, f, cg12, split=split, inner_spec=tight, return_info=True))
    loose = SolverSpec(method="cg", tol=1e-3, atol=1e-3)
    interior = torch.as_tensor(~split.interface_mask, device="cuda") & (bc.free_mask > 0)
    f_inf = float(f.abs().max())
    loose_rows = {}
    for label, inner in (("default_inner", None), ("tight_inner", tight)):
        u_l, info_l = condensed_solve(op, f, loose, split=split, inner_spec=inner,
                                      return_info=True)
        loose_rows[label] = {"outer_iters": info_l.iters, "interior_residual_max": float(
            ((op.matvec(u_l) - f) * interior).abs().max())}
    system = condense(op, split)
    xb = torch.as_tensor(np.random.default_rng(22).standard_normal(system.shape[0]),
                         device="cuda")
    inner_iters = system.ii_solve(system.kib_matvec(xb))[1].iters
    times["schur_apply_ms"] = time_ms(lambda: system.matvec(xb))
    condensation = {
        "n": ELEMALG_COND_N, "dofs": p2.space.num_dofs, "elements": p2.mesh.num_cells,
        "interface": system.shape[0], "interior": system.sc.ni,
        "outer_iters": cond.iters, "matfree_iters": full.iters, "ell_iters": ell.iters,
        "converged": cond.converged, "residual": cond.residual, "max_u": float(cond.u.max()),
        "rel_diff_vs_ell": rel(cond.u, ell.u), "matfree_rel_diff_vs_ell": rel(full.u, ell.u),
        "tight_inner": {"tol": ELEMALG_TIGHT_INNER, "outer_iters": info_t.iters,
                        "rel_diff_vs_ell": rel(u_t, ell.u)},
        "loose_outer": {"f_inf": f_inf, **loose_rows},
        "schur_apply_inner_iters": inner_iters, "launches_first_solve": cond_launches}
    gate(cond.converged and info_t.converged, f"elemalg: condensed solves {condensation}")
    gate(cond.iters < full.iters and info_t.iters < full.iters,
         f"elemalg: outer iterations {cond.iters}, {info_t.iters} not below the "
         f"uncondensed {full.iters}")
    gate(condensation["tight_inner"]["rel_diff_vs_ell"] <= 1e-8,
         f"elemalg: condensed u against ell's {condensation['tight_inner']}")
    gate(loose_rows["tight_inner"]["interior_residual_max"] <= 1e-9 * f_inf,
         f"elemalg: interior rows of a loose condensed solve {loose_rows} (‖f‖∞ {f_inf})")

    # B2 on the scaffold's compact tables, against the ordered plain sum
    ordered = ordered_reduce_ref()
    rng = np.random.default_rng(23)
    compact = {}
    for label, table in (("interface", system.sc.reduce_b), ("interior", system.sc.reduce_i)):
        src = torch.as_tensor(rng.standard_normal(table.n_src), device="cuda")
        got, want = seg_reduce(src, table), ordered(src, table.slots, table.ptr)
        compact[label] = {"rows": table.n_rows, "src": table.n_src, "bit_equal": bool(
            torch.equal(got, want)), "max_abs_err": max_err(got, want)[0],
            "ms": time_ms(lambda: seg_reduce(src, table))}
        gate(compact[label]["bit_equal"], f"elemalg: B2 on the {label} table {compact[label]}")

    # -- the JAX package's pins -------------------------------------------
    pins = JAX_ELEMALG
    p64 = PoissonProblem(unit_square_tri(pins["condensed_n"]), degree=2, device="cuda")
    r64 = p64.solve(backend="matfree", condensed=True, spec=cg12)
    pin_rows = {"condensed": {"iters": r64.iters, "max_u": float(r64.u.max())}}
    gate(abs(r64.iters - pins["condensed_iters"]) <= 1
         and abs(float(r64.u.max()) - pins["condensed_max_u"]) <= 1e-10,
         f"elemalg: condensed solve at n = {pins['condensed_n']} {pin_rows} against the JAX "
         f"package's {pins['condensed_iters']}, {pins['condensed_max_u']}")
    op32, f32 = _aniso_problem(pins["precond_n"])
    for name, want in pins["precond_iters"].items():
        _, info = matfree_solve(op32, f32, SolverSpec(method="cg", tol=1e-10, atol=1e-10,
                                                      maxiter=10000, precond=name),
                                return_info=True)
        pin_rows[f"aniso_{name}"] = info.iters
        gate(abs(info.iters - want) <= 1,
             f"elemalg: {name} on anisotropic P1 at n = {pins['precond_n']}: {info.iters} "
             f"iterations against the JAX package's {want}")

    # -- ∂/∂ρ of Σu² through condensed_solve against sparse_solve ----------
    rho = torch.as_tensor(np.random.default_rng(24).uniform(0.5, 2.0, p64.plan.num_cells),
                          device="cuda")
    f64 = p64.bc.project_residual(assemble_rhs(p64.plan, wf.source(1.0)))
    r1 = rho.clone().requires_grad_(True)
    k64 = p64.bc.apply_matrix_only(assemble(p64.plan, wf.diffusion(r1)))
    (g_ref,), walls["grad_sparse_solve_s"] = timed(
        lambda: torch.autograd.grad((sparse_solve(k64, f64, cg12) ** 2).sum(), r1))
    r2 = rho.clone().requires_grad_(True)
    op64 = matfree_operator(p64.plan, wf.diffusion(r2)).condensed(p64.bc)
    (g_cond,), walls["grad_condensed_s"] = timed(lambda: torch.autograd.grad(
        (condensed_solve(op64, f64, cg12, space=p64.space, inner_spec=tight) ** 2).sum(), r2))
    gradient = {"n": pins["condensed_n"], "rel_diff_vs_sparse_solve": rel(g_cond, g_ref)}
    gate(gradient["rel_diff_vs_sparse_solve"] <= 1e-8, f"elemalg: ∂/∂ρ {gradient}")

    # -- preconditioners on anisotropic P1 at n = 512 ----------------------
    (op_a, f_a), walls["setup_aniso_s"] = timed(lambda: _aniso_problem(ELEMALG_PRECOND_N))
    aniso, sols = {"n": ELEMALG_PRECOND_N, "dofs": op_a.shape[0]}, {}
    for name in ("jacobi", "ebe", "chebyshev"):
        (u, info), wall = timed(lambda n=name: matfree_solve(
            op_a, f_a, SolverSpec(method="cg", tol=1e-10, atol=1e-10, maxiter=20000, precond=n),
            return_info=True))
        sols[name] = u
        aniso[name] = {"iters": info.iters, "converged": info.converged, "wall_s": wall,
                       "rel_diff_vs_jacobi": rel(u, sols["jacobi"])}
        gate(info.converged and aniso[name]["rel_diff_vs_jacobi"] <= 1e-8,
             f"elemalg: {name} on anisotropic P1 {aniso[name]}")
    for name in ("ebe", "chebyshev"):
        gate(aniso[name]["iters"] < aniso["jacobi"]["iters"],
             f"elemalg: {name} does not beat jacobi on anisotropic P1 {aniso}")
    x_a = torch.as_tensor(np.random.default_rng(25).standard_normal(op_a.shape[0]), device="cuda")
    for name in ("ebe", "chebyshev"):
        m = make_preconditioner(op_a, name)
        times[f"aniso_{name}_apply_ms"] = time_ms(lambda: m(x_a))

    # -- the main path's gates and times ------------------------------------
    ref = prob.solve(f=1.0)
    main_rows = {}
    for name, row in main.items():
        res = row.pop("res")
        _, row["warm_s"] = timed(
            lambda: prob.solve(f=1.0, backend="matfree", store="coords", spec=ebe_spec)
            if name == "ebe" else prob.solve(f=1.0, spec=cheb_spec))
        row.update({"iters": res.iters, "converged": res.converged, "max_u": float(res.u.max()),
                    "max_abs_diff_vs_jacobi_ell": float((res.u - ref.u).abs().max())})
        main_rows[name] = row
        gate(res.converged and row["max_abs_diff_vs_jacobi_ell"] <= 1e-8
             and 0.0555 <= row["max_u"] <= 0.0565 and res.iters < ref.iters,
             f"elemalg: {name} on the main path {row} (jacobi on ell: {ref.iters} iterations)")
    it_e, it_c = main_rows["ebe"]["iters"], main_rows["chebyshev"]["iters"]
    want = {"ebe": ({"local_stiffness_p1": 1, "seg_reduce": 2 * it_e + 5, "spmv_ell": 0,
                     "galerkin_residual_ell": 0},
                    {"local_stiffness_p1": 1, "seg_reduce": 2 * it_e + 5,
                     "spmv_ell/residual (tiles)": 0}),
            "chebyshev": ({"local_stiffness_p1": 1, "seg_reduce": 2, "spmv_ell": it_c + 1,
                           "galerkin_residual_ell": 1},
                          {"local_stiffness_p1": 1, "seg_reduce": 2,
                           "spmv_ell/residual (tiles)": it_c + 2})}
    for name, (by_wrapper, by_trace) in want.items():
        row = main_rows[name]
        for label, got, expect in (("wrappers", row["launches"], by_wrapper),
                                   ("profiler", row["kernel_calls"], by_trace)):
            gate(all(got[k] == v for k, v in expect.items()),
                 f"elemalg: {name} on the main path launched {got} ({label}), not {expect}; "
                 f"the trace lost {row['lost_records']} kernel records")
    mf = matfree_operator(prob.plan, wf.diffusion(None), store="coords").condensed(prob.bc)
    k_e = masked_element_matrices(mf)
    c_e = k_e + 0.25 * torch.eye(k_e.shape[-1], dtype=k_e.dtype, device="cuda")
    fac = factorize(c_e, spd=True)
    xe = torch.as_tensor(np.random.default_rng(26).standard_normal(tuple(c_e.shape[:2])),
                         device="cuda")
    x = torch.as_tensor(np.random.default_rng(27).standard_normal(mf.shape[0]), device="cuda")
    m_ebe = make_preconditioner(mf, "ebe")
    k_main, _ = prob.assemble(f=1.0)
    m_cheb = make_preconditioner(k_main, "chebyshev")
    times.update({
        "factorize_ms": time_ms(lambda: factorize(c_e, spd=True)),
        "factor_solve_ms": time_ms(lambda: fac.solve(xe)),
        "ebe_build_ms": time_ms(lambda: make_preconditioner(mf, "ebe")),
        "ebe_apply_ms": time_ms(lambda: m_ebe(x)),
        "chebyshev_build_ms": time_ms(lambda: make_preconditioner(k_main, "chebyshev")),
        "chebyshev_apply_ms": time_ms(lambda: m_cheb(x)),
        "main_shapes": {"factors": list(c_e.shape), "csr_nnz": k_main.nnz}})
    walls["phase_s"] = time.perf_counter() - t_phase
    out = {"phase": "elemalg", "condensation": condensation, "compact_b2": compact,
           "pins": pin_rows, "gradient": gradient, "aniso": aniso, "main_path": main_rows,
           "times_ms": times, "walls_s": walls, "launches": launches,
           "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    for ok, what in gates:
        check(ok, what)
    return out


# -- the solve service (A15) and its telemetry (A14) -------------------------

SERVE_N, SERVE_WAVE, SERVE_RATE = 256, 16, 2000.0
SERVE_BUCKETS = (1, 2, 4, 8, 16)
# The JAX package's answers to serve.poisson_requests(n_requests=5,
# resolution=6, seed=0) through SolveService(window=0.0).drain() (the 5
# requests padded to bucket 8), measured on the CPU: backend -> (CG
# iterations, max u) per request.
JAX_SERVE = {"resolution": 6, "n_requests": 5,
             "csr": [(20, 0.059834374025217366), (20, 0.05432883977321751),
                     (20, 0.05848283813927447), (20, 0.055598318700446375),
                     (20, 0.061079398355430525)],
             "matfree": [(20, 0.059834374025217386), (20, 0.054328839773217515),
                         (20, 0.05848283813927447), (20, 0.05559831870044639),
                         (20, 0.06107939835543051)]}


class _Recorder:
    """The service as ``open_loop_load`` drives it (``submit`` and
    ``cache``), keeping every submitted request's future."""

    def __init__(self, svc):
        self.svc, self.cache, self.pendings = svc, svc.cache, []

    def submit(self, req):
        pending = self.svc.submit(req)
        self.pendings.append(pending)
        return pending


def _hist_count(name: str, backend: str) -> int:
    from repro_torch import telemetry

    s = telemetry.snapshot()["histograms"].get(f"{name}{{backend={backend}}}")
    return 0 if s is None else s["count"]


def _chrome_kernels(events) -> dict:
    """From a Chrome trace's events (``telemetry.capture``): the launches of
    B1 and B2 by kernel name, the device busy ms of every kernel but
    ``_open_trace``'s pad, the top kernels, and the launch calls with no
    kernel record (paired by correlation id)."""
    kern = [ev for ev in events if ev.get("cat") == "kernel"]
    seen = {ev.get("args", {}).get("correlation") for ev in kern}
    lost = sum(1 for ev in events if ev.get("cat") == "cuda_runtime"
               and re.match(r"cu(da)?LaunchKernel", ev.get("name", ""))
               and ev.get("args", {}).get("correlation") not in seen)
    by_name: dict = {}
    for ev in kern:
        if "spin_kernel" not in ev["name"]:
            n, us = by_name.get(ev["name"], (0, 0.0))
            by_name[ev["name"]] = (n + 1, us + ev.get("dur", 0.0))
    calls = {label: sum(n for name, (n, _) in by_name.items() if re.search(rf"\b{key}\b", name))
             for key, label in (("p1_stiffness_kernel", "local_stiffness_p1"),
                                ("seg_reduce_kernel", "seg_reduce"))}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"calls": calls, "lost": lost,
            "busy_ms": sum(us for _, us in by_name.values()) / 1e3,
            "top": [{"kernel": name[:70], "device_ms": us / 1e3, "calls": n}
                    for name, (n, us) in top]}


def _serve_b2_per_solve(iters: int) -> int:
    """B2 launches of one matrix-free Jacobi-CG solve: the diagonal, the
    initial residual's apply and one apply an iteration."""
    return iters + 2


def _serve_kernels(csr_reqs, mf_reqs, groups, n_waves) -> dict:
    """B1 and B2 at the serve path's shapes against their plain versions,
    and what the padded bucket costs a ``csr`` group.  (1) The ``csr``
    entry's system (``serve.cache.csr_system``) on the wave's 16 stacked
    leaves: B1 at (16, 131,072) against ``local_stiffness_p1_ref`` and the
    Dirichlet-applied batched K (one batched B1 and one batched B2 onto
    (16, nnz)) against ``bc.apply_matrix_only`` of the plain B1 and B2, at
    1e-12 of scale.  (2) One matrix-free apply's B2 (a ``matfree`` entry's
    family member, ``context`` store): its element vectors reduced onto
    ``plan.vec_reduce`` (66,049 rows) against ``seg_reduce_ref``, and the
    whole apply against the plain pipeline, at 1e-12 of scale.  (3) The
    ``csr`` system's device time at each padded bucket and at each real
    group size ``b`` of the waves (``groups``: ``{b: count}``), so the
    padding's cost a group is ``t(pad_bucket(b)) − t(b)``."""
    from repro_torch import kernels
    from repro_torch.core import matfree_family
    from repro_torch.kernels.ref import local_stiffness_p1_ref, seg_reduce_ref
    from repro_torch.serve import pad_bucket
    from repro_torch.serve.cache import csr_system
    from repro_torch.serve.service import _stack_padded

    def stacked(reqs, padded):
        return tuple(_stack_padded([r.leaves[j] for r in reqs], padded, reqs[0].plan.device)
                     for j in range(len(reqs[0].leaves)))

    req = csr_reqs[0]
    plan, bc, form = req.plan, req.bc, req.form
    leaves = stacked(csr_reqs, SERVE_WAVE)
    rho_b = (leaves[0] * leaves[1][:, None]).contiguous()
    table = plan.mat_reduce
    b1_err, b1_scale = max_err(kernels.local_stiffness_p1(plan.coords, rho_b),
                               local_stiffness_p1_ref(plan.coords, rho_b))
    k_err, k_scale = max_err(csr_system(plan, form, bc, leaves).vals, bc.apply_matrix_only(
        plan.batched_csr(seg_reduce_ref(local_stiffness_p1_ref(plan.coords, rho_b), table.rows,
                                        table.n_rows, batch=True))).vals)

    mreq = mf_reqs[0]
    op = matfree_family(mreq.plan, mreq.form, leaves_batch=stacked(mf_reqs, SERVE_WAVE)
                        ).condensed(mreq.bc)[0]
    vec = mreq.plan.vec_reduce
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(mreq.plan.num_dofs),
                        device=mreq.plan.device)
    m = op.free_mask.to(x.dtype)
    y_local = op._local_apply((m * x)[mreq.plan.cell_dofs], False)
    y_plain = seg_reduce_ref(y_local, vec.rows, vec.n_rows)
    b2_err, b2_scale = max_err(kernels.seg_reduce(y_local, vec), y_plain)
    apply_err, apply_scale = max_err(op.matvec(x), m * y_plain + (1.0 - m) * x)

    sizes = sorted(set(SERVE_BUCKETS) | set(groups))
    by_size = {b: stacked(csr_reqs[:b], b) for b in sizes}
    ms = {b: time_ms(lambda b=b: csr_system(plan, form, bc, by_size[b])) for b in sizes}
    pad = {b: {"groups": n, "padded": min(pad_bucket(b), SERVE_WAVE),
               "pad_ms": ms[min(pad_bucket(b), SERVE_WAVE)] - ms[b]}
           for b, n in sorted(groups.items())}
    return {"b1_batched": {"shape": list(rho_b.shape), "max_abs_err": b1_err, "scale": b1_scale},
            "k_batched": {"shape": [SERVE_WAVE, table.n_rows], "max_abs_err": k_err,
                          "scale": k_scale},
            "b2_vector": {"rows": vec.n_rows, "src": list(y_local.shape), "max_abs_err": b2_err,
                          "scale": b2_scale},
            "matfree_apply": {"max_abs_err": apply_err, "scale": apply_scale},
            "csr_system_ms": ms, "padding_by_group_size": pad,
            "padding_ms_per_wave": sum(v["groups"] * v["pad_ms"] for v in pad.values())
            / n_waves,
            "element_matrix_bytes_per_row": plan.num_cells * 9 * 8}


def phase_serve():
    """The solve service (A15) and the telemetry it reports through (A14).
    The path, counted from 0 around it: for ``csr`` and then ``matfree``,
    ``SolveService(window=0.002, max_batch=16)`` on
    ``poisson_requests(resolution=256)`` (66,049 DoFs, 131,072 triangles,
    CG + Jacobi at 1e-10), ``warmup`` pinning the buckets 1-16, then 2
    waves of 16 requests (seeds 0 and 1) under the started worker through
    ``open_loop_load`` at 2,000 requests/s, telemetry on and the flight
    recorder writing to a temporary directory.  Then the gates, read after
    the phase's line is out: every response ``ok``; no entry built and no
    cache miss after warmup; B1 and B2 at the path's shapes against their
    plain versions at 1e-12 of scale (``_serve_kernels``: the ``csr``
    entry's batched K at bucket 16, one matrix-free apply's B2 on the
    66,049-row vector table), with the padded bucket's cost a ``csr``
    group; wave 0's answers within 1e-12·max|u| of a
    sequential ``sparse_solve`` / ``matfree_solve`` with equal iterations;
    one B1 and one B2 a ``csr`` group and B2 once an apply on ``matfree``
    (the wrappers' counts); the four span segments summing to e2e within
    5 %; a dispatch under ``telemetry.capture`` whose trace names B1 and B2
    and counts them as the wrappers do (and gives its idle share); the
    reference size (``resolution=6``, 5
    requests padded to 8) against the JAX package's pins; and
    ``python -m repro_torch.launch.serve --smoke`` in a subprocess."""
    import json
    import os
    import shutil
    import tempfile

    from repro_torch import kernels, serve, telemetry
    from repro_torch.core import assemble, matfree_operator, matfree_solve, sparse_solve
    from repro_torch.telemetry import spans

    gates, walls = [], {}
    t_phase = time.perf_counter()

    def gate(cond, what):
        gates.append((bool(cond), what))

    def since(before):
        return {k: kernels.LAUNCHES[k] - before[k] for k in before}

    tmp = tempfile.mkdtemp(prefix="serve_phase_")
    telemetry.reset()
    telemetry.enable()
    telemetry.configure_flight(path=os.path.join(tmp, "flight.jsonl"))
    try:
        # -- the path: both backends, warmup and two waves each -------------
        kernels.reset_launches()
        runs = {}
        for backend in ("csr", "matfree"):
            telemetry.reset()  # each backend's histograms, gauges and counters apart
            (waves, walls[f"{backend}_requests_s"]) = timed(lambda: [serve.poisson_requests(
                n_requests=SERVE_WAVE, resolution=SERVE_N, backend=backend, seed=seed,
                device="cuda") for seed in (0, 1)])
            svc = serve.SolveService(window=0.002, max_batch=SERVE_WAVE)
            _, walls[f"{backend}_warmup_s"] = timed(
                lambda: svc.warmup(waves[0][0], batch_sizes=SERVE_BUCKETS))
            warm_snap = telemetry.snapshot()
            traces0 = telemetry.jit_trace_total("serve")
            hits0, misses0 = svc.cache.hits, svc.cache.misses
            rows = []
            t0 = time.perf_counter()
            with svc:
                for seed, reqs in enumerate(waves):
                    rec = _Recorder(svc)
                    before, groups0 = dict(kernels.LAUNCHES), _hist_count(
                        "serve_batch_size", backend)
                    report = serve.open_loop_load(rec, reqs, rate=SERVE_RATE, seed=seed)
                    rows.append({"report": report, "launches": since(before),
                                 "groups": _hist_count("serve_batch_size", backend) - groups0,
                                 "responses": [p.response() for p in rec.pendings]})
            walls[f"{backend}_waves_s"] = time.perf_counter() - t0
            runs[backend] = {"svc": svc, "waves": waves, "rows": rows, "snap": telemetry.snapshot(),
                             "warm_snap": warm_snap,
                             "built_after_warmup": telemetry.jit_trace_total("serve") - traces0,
                             "misses_after_warmup": svc.cache.misses - misses0,
                             "hits_after_warmup": svc.cache.hits - hits0}
        launches = dict(kernels.LAUNCHES)
        for kname in ("local_stiffness_p1", "seg_reduce"):
            gate(launches[kname] > 0, f"serve path: kernel {kname} never launched")

        # -- B1 and B2 at the path's shapes against their plain versions ------
        t0 = time.perf_counter()
        sizes = collections.Counter(r.batch_size for row in runs["csr"]["rows"]
                                    for r in row["responses"])
        plain = _serve_kernels(runs["csr"]["waves"][0], runs["matfree"]["waves"][0],
                               {b: n // b for b, n in sizes.items()}, len(runs["csr"]["rows"]))
        for name in ("b1_batched", "k_batched", "b2_vector", "matfree_apply"):
            gate(plain[name]["max_abs_err"] <= TOL[torch.float64] * plain[name]["scale"],
                 f"serve: {name} against its plain version {plain[name]}")
        walls["plain_checks_s"] = time.perf_counter() - t0

        # -- per backend: readings and gates ---------------------------------
        results = {}
        for backend, run in runs.items():
            svc, snap, rows = run["svc"], run["snap"], run["rows"]
            resps = [r for row in rows for r in row["responses"]]
            hist = snap["histograms"]
            e2e = hist.get(f"serve_e2e_us{{backend={backend}}}", {})
            qw = hist.get(f"serve_queue_wait_us{{backend={backend}}}", {})
            seg = [r.span_segments_us for r in resps]
            solve_us = [s.get("solve", math.nan) for s in seg]
            shares = [s.get("solve", math.nan) / (1e6 * r.e2e_s) for s, r in zip(seg, resps)]
            lookups = run["hits_after_warmup"] + run["misses_after_warmup"]
            duration = sum(row["report"].duration_s for row in rows)
            gauges = run["warm_snap"]["gauges"]
            out = {
                "requests": len(resps), "ok": sum(r.ok for r in resps),
                "e2e_p50_us": e2e.get("p50"), "e2e_p99_us": e2e.get("p99"),
                "queue_wait_p50_us": qw.get("p50"),
                "solve_p50_us": statistics.median(solve_us),
                "solve_share_of_e2e_p50": statistics.median(shares),
                "batch_size_mean": sum(len(row["responses"]) for row in rows)
                / max(1, sum(row["groups"] for row in rows)),
                "groups_per_wave": [row["groups"] for row in rows],
                "throughput_per_s": len(resps) / duration, "waves_s": duration,
                "hit_rate_after_warmup": run["hits_after_warmup"] / max(1, lookups),
                "entries_built_after_warmup": run["built_after_warmup"],
                "cg_iters_median": statistics.median(r.info.iters for r in resps),
                "cg_iters_range": [min(r.info.iters for r in resps),
                                   max(r.info.iters for r in resps)],
                "compile_us_by_entry": {k.split("entry=")[1].rstrip("}"): v for k, v in
                                        gauges.items() if k.startswith("serve_exec_compile_us")},
                "device_memory": {k: v for k, v in gauges.items() if k.startswith("device_")},
                "wave_launches": [row["launches"] for row in rows],
                "report_wave": [{"e2e_p50_us": row["report"].e2e_p50_us,
                                 "e2e_p99_us": row["report"].e2e_p99_us,
                                 "throughput_per_s": row["report"].throughput,
                                 "span_coverage": row["report"].span_coverage}
                                for row in rows]}
            gate(out["ok"] == len(resps) == 2 * SERVE_WAVE,
                 f"serve {backend}: {out['ok']} of {len(resps)} responses ok "
                 f"({sorted({r.status for r in resps})})")
            gate(run["built_after_warmup"] == 0 and run["misses_after_warmup"] == 0,
                 f"serve {backend}: {run['built_after_warmup']} entries built and "
                 f"{run['misses_after_warmup']} cache misses after warmup")
            for r, s in zip(resps, seg):
                total, e2e_us = sum(s.values()), 1e6 * r.e2e_s
                gate(list(s) == ["queue_wait", "dispatch", "solve", "slice"]
                     and abs(total - e2e_us) <= 0.05 * e2e_us,
                     f"serve {backend}: segments {s} against e2e {e2e_us} us")
            # the wrappers' counts over each wave
            for row in rows:
                got = row["launches"]
                if backend == "csr":
                    want = {"local_stiffness_p1": row["groups"], "seg_reduce": row["groups"]}
                else:
                    want = {"local_stiffness_p1": 0, "seg_reduce": sum(
                        _serve_b2_per_solve(r.info.iters) for r in row["responses"])}
                gate(all(got[k] == v for k, v in want.items())
                     and got["spmv_ell"] == got["galerkin_residual_ell"] == 0,
                     f"serve {backend}: a wave of {row['groups']} groups launched {got}, "
                     f"not {want}")
            # wave 0 against sequential solves of the same requests
            t0 = time.perf_counter()
            parity = []
            for req, r in zip(run["waves"][0], rows[0]["responses"]):
                f = req.rhs * req.bc.free_mask
                if backend == "csr":
                    k = req.bc.apply_matrix_only(assemble(req.plan, req.form))
                    u_ref, info = sparse_solve(k, f, req.spec, return_info=True)
                else:
                    op = matfree_operator(req.plan, req.form).condensed(req.bc)
                    u_ref, info = matfree_solve(op, f, req.spec, return_info=True)
                scale = float(u_ref.abs().max())
                parity.append((float((r.u - u_ref).abs().max()) / scale,
                               r.info.iters - info.iters))
            out["parity_rel_max"] = max(p[0] for p in parity)
            out["parity_iter_diffs"] = sorted({p[1] for p in parity})
            gate(out["parity_rel_max"] <= 1e-12 and out["parity_iter_diffs"] == [0],
                 f"serve {backend}: wave 0 against sequential solves {parity}")
            walls[f"{backend}_sequential_s"] = time.perf_counter() - t0
            # one dispatch (one request, bucket 1) under telemetry.capture:
            # its Chrome trace names the kernels, counts their launches
            # against the wrappers' and gives the dispatch's idle share (a
            # trace read through key_averages() takes tens of seconds here)
            t0 = time.perf_counter()
            cap_dir = os.path.join(tmp, f"capture_{backend}")
            pend = [svc.submit(serve.poisson_requests(
                n_requests=1, resolution=SERVE_N, backend=backend, seed=2, device="cuda")[0])]
            before = dict(kernels.LAUNCHES)
            with telemetry.capture(cap_dir):
                _open_trace()
                _, wall_s = timed(svc.drain)
            files = sorted(os.listdir(cap_dir))
            with open(os.path.join(cap_dir, files[-1])) as fh:
                trace = _chrome_kernels(json.load(fh)["traceEvents"])
            iters = [p.response().info.iters for p in pend]
            want = (1 if backend == "csr" else 0,
                    1 if backend == "csr" else sum(_serve_b2_per_solve(i) for i in iters))
            got = since(before)
            out["captured_dispatch"] = {
                "files": files, "requests": len(pend), "iters": iters, "wall_ms": 1e3 * wall_s,
                "device_busy_ms": trace["busy_ms"],
                "device_idle_share": 1 - trace["busy_ms"] / (1e3 * wall_s),
                "top_kernels": trace["top"], "launches": got, "kernel_calls": trace["calls"],
                "lost_records": trace["lost"]}
            gate(all(p.response().ok for p in pend)
                 and (trace["calls"]["local_stiffness_p1"], trace["calls"]["seg_reduce"]) == want
                 and (got["local_stiffness_p1"], got["seg_reduce"]) == want,
                 f"serve {backend}: a captured dispatch {out['captured_dispatch']} against "
                 f"(B1, B2) = {want}")
            walls[f"{backend}_captured_s"] = time.perf_counter() - t0
            results[backend] = out

        # -- the reference size against the JAX package's pins --------------
        t0 = time.perf_counter()
        pins = {}
        for backend in ("csr", "matfree"):
            reqs = serve.poisson_requests(n_requests=JAX_SERVE["n_requests"],
                                          resolution=JAX_SERVE["resolution"], backend=backend,
                                          seed=0, device="cuda")
            svc = serve.SolveService(window=0.0)
            pend = [svc.submit(r) for r in reqs]
            svc.drain()
            got = [(p.response().info.iters, float(p.response().u.max())) for p in pend]
            pins[backend] = got
            gate(all(p.response().ok and p.response().batch_size == 5 for p in pend)
                 and all(abs(g[0] - w[0]) <= 1 and abs(g[1] - w[1]) <= 1e-10
                         for g, w in zip(got, JAX_SERVE[backend])),
                 f"serve {backend}: reference size {got} against the JAX package's "
                 f"{JAX_SERVE[backend]}")

        walls["reference_size_s"] = time.perf_counter() - t0
        # -- the launcher's smoke in a subprocess on the card -----------------
        import repro_torch

        env = {**os.environ, "PYTHONPATH": str(Path(repro_torch.__file__).parents[1])}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke"],
                              capture_output=True, text=True, env=env, timeout=300)
        smoke = {"rc": proc.returncode, "wall_s": time.perf_counter() - t0,
                 "stdout": proc.stdout.strip()[-300:], "stderr": proc.stderr.strip()[-1500:]}
        gate(proc.returncode == 0 and "serve smoke OK on cuda" in proc.stdout,
             f"serve: launch.serve --smoke {smoke}")
    finally:
        telemetry.disable()
        telemetry.reset()
        telemetry.clear_flight()
        spans._FLIGHT_PATH = None
        shutil.rmtree(tmp, ignore_errors=True)
    walls["phase_s"] = time.perf_counter() - t_phase
    out = {"phase": "serve", "n": SERVE_N, "dofs": runs["csr"]["waves"][0][0].plan.num_dofs,
           "elements": runs["csr"]["waves"][0][0].plan.num_cells, "wave": SERVE_WAVE,
           "rate_per_s": SERVE_RATE, "buckets": SERVE_BUCKETS, "backends": results,
           "plain_checks": plain, "reference_size": pins, "launch_smoke": smoke,
           "walls_s": walls,
           "launches": launches, "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    for ok, what in gates:
        check(ok, what)
    return out


TRACE_OPENINGS = ("none", "one_kernel", "sleep", "pad")
TRACE_REPEATS = {"local": 8, "context": 3, "coords": 2}


# The sharded phase (A16): ranks spawned on the one card, each with its own
# process group over a file rendezvous under build/
SHARDED_THETA_STEPS = 5
SHARDED_GRAD_N = 16
SHARDED_UNEVEN_N = 9  # E = 4,374: blocks of 1,094 on 4 ranks, the last 1,092
SHARDED_GROUP_TIMEOUT_S = 60
SHARDED_REPS = 25


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _host_ms(fn, reps: int = SHARDED_REPS) -> float:
    """Median host wall time of ``fn`` between two device synchronisations
    (for work that blocks the host, as a gloo all-reduce does)."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls)


def _sharded_theta(prob, backend):
    """SHARDED_THETA_STEPS Crank–Nicolson steps on matrix-free operators
    at CG tolerance 1e-12 (absolute 1e-15) from the sine state."""
    from repro_torch.core import SolverSpec

    integ, u0 = _heat_rollout(prob, backend,
                              spec=SolverSpec(method="cg", tol=1e-12, atol=1e-15))
    traj, info = integ.rollout(u0, SHARDED_THETA_STEPS, return_info=True)
    return traj, info.iters.tolist()


def _sharded_assembly(plan, mesh) -> dict:
    """The sharded stiffness and load against the single-device B1 + B2
    assembly: (max abs difference, max |value|) each, and whether they are
    bit-equal."""
    from repro_torch.core import (assemble, assemble_rhs, assemble_rhs_sharded,
                                  assemble_sharded, weakform as wf)

    out = {}
    for name, sharded, single in (
            ("stiffness", lambda: assemble_sharded(plan, wf.diffusion(None), mesh).vals,
             lambda: assemble(plan, wf.diffusion(None)).vals),
            ("load", lambda: assemble_rhs_sharded(plan, wf.source(1.0), mesh),
             lambda: assemble_rhs(plan, wf.source(1.0)))):
        got, want = sharded(), single()
        out[name] = {"max_abs_err": float((got - want).abs().max()),
                     "scale": float(want.abs().max()), "bit_equal": torch.equal(got, want)}
    return out


def _sharded_nccl1(mesh) -> dict:
    """A one-rank NCCL world at n = 64: the sharded assembly and the
    sharded matrix-free solve of each store against the unsharded ones."""
    from repro_torch.core import unit_cube_tet
    from repro_torch.fem import PoissonProblem

    prob, setup_s = timed(lambda: PoissonProblem(unit_cube_tet(MAIN_N), device="cuda"))
    stores = {}
    for store in MATFREE_STORES:
        r0 = prob.solve(f=1.0, backend="matfree", store=store)
        r1, first_s = timed(lambda: prob.solve(f=1.0, backend="matfree_sharded", store=store))
        # warm walls, one after the other in this process
        _, warm0 = timed(lambda: prob.solve(f=1.0, backend="matfree", store=store))
        _, warm1 = timed(lambda: prob.solve(f=1.0, backend="matfree_sharded", store=store))
        stores[store] = {"bit_equal": torch.equal(r0.u, r1.u), "iters": r1.iters,
                         "unsharded_iters": r0.iters, "first_s": first_s, "warm_s": warm1,
                         "unsharded_warm_s": warm0,
                         "max_abs_diff": float((r0.u - r1.u).abs().max())}
    return {"setup_s": setup_s, "assembly": _sharded_assembly(prob.plan, mesh),
            "stores": stores}


def _sharded_block_kernels(plan, mesh, y_local) -> dict:
    """B1 and B2 at the rank's block: B1 on the block's coordinates against
    ``local_stiffness_p1_ref``; B2 on the block's stiffness table (B1's
    output) and vector table (``y_local``) bit for bit against the ordered
    plain sum on the table and against ``seg_reduce_ref``."""
    from repro_torch import kernels
    from repro_torch.kernels.ref import local_stiffness_p1_ref, seg_reduce_ref

    ordered = ordered_reduce_ref()
    shard = plan.shard(mesh)
    rho = torch.ones(shard.num_cells, dtype=torch.float64, device="cuda")
    k_e = kernels.local_stiffness_p1(shard.coords, rho)
    err, scale = max_err(k_e, local_stiffness_p1_ref(shard.coords, rho))
    out = {"block": list(shard.block),
           "b1": {"elements": shard.num_cells, "max_abs_err": err, "scale": scale}}
    for name, src, table in (("b2_stiffness", k_e, shard.mat_reduce),
                             ("b2_vector", y_local, shard.vec_reduce)):
        got = kernels.seg_reduce(src, table)
        err, scale = max_err(got, seg_reduce_ref(src, table.rows, table.n_rows))
        out[name] = {"rows": table.n_rows, "src": table.n_src, "max_abs_err": err,
                     "scale": scale,
                     "bit_equal_ordered": torch.equal(got, ordered(src, table.slots, table.ptr))}
    return out


def _sharded_gloo2(mesh) -> dict:
    """Rank ``mesh.rank`` of two on the one card (gloo) at n = 64: the
    path (sharded assembly and a sharded matrix-free solve on each store,
    counted from 0), the assembly against the single-device one, each
    store's u against ``ell``, one apply's gather, action, B2 and
    all-reduce, the θ rollout and the gradient against the unsharded
    ones, B1/B2 at the rank's block, device memory."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import (SolverSpec, assemble_rhs, assemble_rhs_sharded,
                                  assemble_sharded, matfree_operator, matfree_solve,
                                  unit_cube_tet, weakform as wf)
    from repro_torch.core.assembly import reduce_vector
    from repro_torch.fem import PoissonProblem
    from repro_torch.sharding import COLLECTIVES, reduce_from_shards, reset_collectives

    probe = torch.full((4,), float(mesh.rank + 1), dtype=torch.float64, device="cuda")
    dist.all_reduce(probe)
    torch.cuda.reset_peak_memory_stats()
    prob, setup_s = timed(lambda: PoissonProblem(unit_cube_tet(MAIN_N), device="cuda"))
    plan, bc = prob.plan, prob.bc
    ell = prob.solve(f=1.0)

    # the path, counted from 0 around it
    kernels.reset_launches()
    reset_collectives()
    _, assemble_s = timed(lambda: (assemble_sharded(plan, wf.diffusion(None), mesh),
                                   assemble_rhs_sharded(plan, wf.source(1.0), mesh)))
    firsts = {}
    for store in MATFREE_STORES:
        before, before_c = dict(kernels.LAUNCHES), dict(COLLECTIVES)
        res, first_s = timed(lambda: prob.solve(f=1.0, backend="matfree_sharded", store=store))
        firsts[store] = (res, first_s, {k: v - before[k] for k, v in kernels.LAUNCHES.items()},
                         {k: v - before_c[k] for k, v in COLLECTIVES.items()})
    launches, collectives = dict(kernels.LAUNCHES), dict(COLLECTIVES)
    memory = {"peak_bytes": torch.cuda.max_memory_allocated(),
              "allocated_bytes": torch.cuda.memory_allocated()}

    out = {"probe": probe.tolist(), "setup_s": setup_s, "assemble_s": assemble_s,
           "launches": launches, "collectives": collectives, "memory": memory,
           "assembly": _sharded_assembly(plan, mesh), "ell_iters": ell.iters, "stores": {}}
    x = ell.u.clone()
    m = bc.free_mask.to(x.dtype)
    for store in MATFREE_STORES:
        res, first_s, counts, coll = firsts[store]
        _, warm_s = timed(lambda: prob.solve(f=1.0, backend="matfree_sharded", store=store))
        op = matfree_operator(plan, wf.diffusion(None), store=store).sharded(mesh).condensed(bc)
        block = op._block()
        shard = block.plan
        xe = (m * x)[shard.cell_dofs]
        y_local = block._local_apply(xe, False)
        part = reduce_vector(y_local, shard)
        buffers = iter([part.clone() for _ in range(SHARDED_REPS + 1)])
        kernels.reset_launches()
        reset_collectives()
        op.matvec(x)
        torch.cuda.synchronize()
        per_apply = {"b2": kernels.LAUNCHES["seg_reduce"],
                     "all_reduce": COLLECTIVES["reduce_from_shards"]}
        out["stores"][store] = {
            "iters": res.iters, "converged": res.converged, "residual": res.residual,
            "max_u": float(res.u.max()), "max_abs_diff_vs_ell": float((res.u - ell.u).abs().max()),
            "u_digest": _digest(res.u), "first_s": first_s, "warm_s": warm_s,
            "launches": counts, "collectives": coll, "per_apply": per_apply,
            "gather_ms": time_ms(lambda: (m * x)[shard.cell_dofs]),
            "action_ms": time_ms(lambda: block._local_apply(xe, False)),
            "b2_ms": time_ms(lambda: reduce_vector(y_local, shard)),
            "all_reduce_host_ms": _host_ms(lambda: reduce_from_shards(next(buffers), mesh)),
            "apply_host_ms": _host_ms(lambda: op.matvec(x))}
    out["kernels"] = _sharded_block_kernels(plan, mesh, y_local)

    (traj_sh, it_sh), theta_s = timed(lambda: _sharded_theta(prob, "matfree_sharded"))
    (traj_mf, it_mf), theta_mf_s = timed(lambda: _sharded_theta(prob, "matfree"))
    out["theta"] = {"iters": it_sh, "unsharded_iters": it_mf, "wall_s": theta_s,
                    "unsharded_wall_s": theta_mf_s, "traj_digest": _digest(traj_sh),
                    "max_rel_diff": float((traj_sh - traj_mf).abs().max()
                                          / traj_mf.abs().max())}

    p16 = PoissonProblem(unit_cube_tet(SHARDED_GRAD_N), device="cuda")
    load16 = p16.bc.project_residual(assemble_rhs(p16.plan, wf.source(1.0)))
    x_mid = p16.plan.coords[:, :, 0].mean(dim=1)
    spec = SolverSpec(method="cg", tol=1e-12, atol=1e-12)

    def grad(sharded):
        rho = (1.0 + x_mid).requires_grad_(True)
        op16 = matfree_operator(p16.plan, wf.diffusion(rho))
        if sharded:
            op16 = op16.sharded(mesh)
        u = matfree_solve(op16.condensed(p16.bc), load16, spec)
        return torch.autograd.grad((u ** 2).sum(), rho)[0]

    reset_collectives()
    g_sh = grad(True)
    grad_collectives = dict(COLLECTIVES)
    g_mf = grad(False)
    out["gradient"] = {"n": SHARDED_GRAD_N, "g_digest": _digest(g_sh),
                       "collectives": grad_collectives,
                       "rel_diff": float((g_sh - g_mf).abs().max() / g_mf.abs().max())}
    return out


def _sharded_gloo4(mesh) -> dict:
    """Rank ``mesh.rank`` of four at unit_cube_tet(9) (E = 4,374, split
    unevenly): the assembly against the single-device one, the sharded
    solve against ``matfree`` and ``ell``."""
    from repro_torch.core import unit_cube_tet
    from repro_torch.fem import PoissonProblem

    prob = PoissonProblem(unit_cube_tet(SHARDED_UNEVEN_N), device="cuda")
    ell = prob.solve(f=1.0)
    mf = prob.solve(f=1.0, backend="matfree")
    sh = prob.solve(f=1.0, backend="matfree_sharded")
    return {"elements": prob.plan.num_cells, "block": list(prob.plan.shard(mesh).block),
            "assembly": _sharded_assembly(prob.plan, mesh), "iters": sh.iters,
            "matfree_iters": mf.iters, "ell_iters": ell.iters, "u_digest": _digest(sh.u),
            "max_abs_diff_vs_ell": float((sh.u - ell.u).abs().max())}


SHARDED_JOBS = {"nccl1": _sharded_nccl1, "gloo2": _sharded_gloo2, "gloo4": _sharded_gloo4}


def _sharded_rank(rank: int, size: int, backend: str, init_file: str, job: str, out) -> None:
    """One rank of the ``sharded`` phase: a process group of ``backend``
    over a file rendezvous (with a timeout, so that a rank that dies fails
    the world instead of hanging it), the job on the card, its readings or
    its traceback put on ``out``; nothing on stdout."""
    import datetime
    import os
    import traceback

    import torch.distributed as dist

    # no network on the machine: the ranks meet on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=size,
                                timeout=datetime.timedelta(seconds=SHARDED_GROUP_TIMEOUT_S))
        from repro_torch.sharding import fem_mesh

        res = SHARDED_JOBS[job](fem_mesh(device="cuda"))
        dist.barrier()
        out.put((rank, res, None))
    except Exception:  # the rank's boundary: report the traceback, fail the phase
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _sharded_world(job: str, backend: str, size: int, timeout: float):
    """Spawn ``size`` ranks of ``job`` and wait for them: (results by rank,
    errors, wall seconds).  Every rank is joined, or terminated, before
    this returns."""
    import os
    import queue

    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    init = ROOT / "build" / f"rendezvous_{os.getpid()}_{job}"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    procs = [ctx.Process(target=_sharded_rank, args=(r, size, backend, str(init), job, results))
             for r in range(size)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(size):
            rank, res, err = results.get(timeout=timeout)
            if err is None:
                got[rank] = res
            else:
                errors.append(f"{job} rank {rank}:\n{err}")
    except queue.Empty:
        errors.append(f"{job}: {len(got)} of {size} ranks answered within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        init.unlink(missing_ok=True)
    return got, errors, time.perf_counter() - t0


def phase_sharded():
    """Element-parallel sharding (A16) on the card, ranks spawned with
    ``torch.multiprocessing``: a one-rank NCCL world at n = 64 (the sharded
    assembly and each store's sharded matrix-free solve bit-equal to the
    unsharded ones); two ranks on the one card over gloo at n = 64 (the
    sharded stiffness and load within 1e-13 of max|vals| of the
    single-device B1 + B2 assembly, each store's solve in 147 ± 1
    iterations with u within 1e-8 of ``ell``, both ranks bit-identical, 5
    Crank–Nicolson steps within 1e-10 of ``matfree``, ∂/∂ρ of Σu² at n =
    16 within 1e-10 of the unsharded gradient, B1/B2 at each rank's block
    against their plain versions, one B2 and one all-reduce an apply, the
    apply's gather / action / B2 / all-reduce times and device memory); and
    four ranks at unit_cube_tet(9), whose 4,374 elements split unevenly."""
    worlds, gates = {}, []

    def gate(cond, what):
        gates.append((bool(cond), what))

    t_phase = time.perf_counter()
    for job, backend, size, timeout in (("nccl1", "nccl", 1, 240), ("gloo2", "gloo", 2, 420),
                                        ("gloo4", "gloo", 4, 180)):
        got, errors, wall = _sharded_world(job, backend, size, timeout)
        worlds[job] = {"backend": backend, "ranks": size, "wall_s": wall,
                       "results": [got.get(r) for r in range(size)], "errors": errors}
        gate(not errors, f"sharded {job}: " + "\n".join(errors))
    failed = [ok for ok, _ in gates if not ok]
    if not failed:
        one = worlds["nccl1"]["results"][0]
        for name, row in one["assembly"].items():
            gate(row["bit_equal"], f"sharded nccl1: the {name} is not bit-equal to assemble's")
        for store, row in one["stores"].items():
            gate(row["bit_equal"] and row["iters"] == row["unsharded_iters"],
                 f"sharded nccl1 {store}: not bit-equal to the unsharded solve {row}")

        ranks = worlds["gloo2"]["results"]
        for r, res in enumerate(ranks):
            gate(res["probe"] == [3.0] * 4, f"gloo2 rank {r}: CUDA all-reduce gave {res['probe']}")
            for name, row in res["assembly"].items():
                gate(row["max_abs_err"] <= 1e-13 * row["scale"],
                     f"gloo2 rank {r}: the sharded {name} is {row} from the single-device one")
            for store, row in res["stores"].items():
                b1 = 1 if store == "local" else 0
                gate(row["converged"] and abs(row["iters"] - 147) <= 1,
                     f"gloo2 rank {r} {store}: {row['iters']} iterations")
                gate(row["max_abs_diff_vs_ell"] <= 1e-8,
                     f"gloo2 rank {r} {store}: u {row['max_abs_diff_vs_ell']} from ell's")
                # a solve: the load's Reduce, the Jacobi diagonal, CG's first
                # residual, one apply an iteration and the final residual
                gate(row["launches"]["seg_reduce"] == row["iters"] + 4
                     and row["collectives"]["reduce_from_shards"] == row["iters"] + 3
                     and row["launches"]["local_stiffness_p1"] == b1,
                     f"gloo2 rank {r} {store}: launches {row['launches']}, "
                     f"all-reduces {row['collectives']}")
                gate(row["per_apply"] == {"b2": 1, "all_reduce": 1},
                     f"gloo2 rank {r} {store}: an apply launched {row['per_apply']}")
            ker = res["kernels"]
            gate(ker["b1"]["max_abs_err"] <= 1e-12 * ker["b1"]["scale"],
                 f"gloo2 rank {r}: B1 at the block {ker['b1']}")
            for name in ("b2_stiffness", "b2_vector"):
                gate(ker[name]["bit_equal_ordered"]
                     and ker[name]["max_abs_err"] <= 1e-12 * ker[name]["scale"],
                     f"gloo2 rank {r}: {name} at the block {ker[name]}")
            gate(res["theta"]["max_rel_diff"] <= 1e-10,
                 f"gloo2 rank {r}: θ rollout {res['theta']['max_rel_diff']} from matfree's")
            gate(res["gradient"]["rel_diff"] <= 1e-10,
                 f"gloo2 rank {r}: gradient {res['gradient']['rel_diff']} from the unsharded")
            for name in ("local_stiffness_p1", "seg_reduce"):
                gate(res["launches"][name] > 0, f"gloo2 rank {r}: {name} never launched")
        a, b = ranks
        for store in MATFREE_STORES:
            gate(a["stores"][store]["u_digest"] == b["stores"][store]["u_digest"]
                 and a["stores"][store]["iters"] == b["stores"][store]["iters"],
                 f"gloo2 {store}: the ranks' u or iterations differ")
        gate(a["theta"]["traj_digest"] == b["theta"]["traj_digest"]
             and a["theta"]["iters"] == b["theta"]["iters"], "gloo2: the ranks' θ rollouts differ")
        gate(a["gradient"]["g_digest"] == b["gradient"]["g_digest"],
             "gloo2: the ranks' gradients differ")
        gate([res["kernels"]["block"] for res in ranks] == [[0, 786_432], [786_432, 1_572_864]],
             f"gloo2: blocks {[res['kernels']['block'] for res in ranks]}")

        four = worlds["gloo4"]["results"]
        gate([res["block"] for res in four]
             == [[0, 1094], [1094, 2188], [2188, 3282], [3282, 4374]],
             f"gloo4: blocks {[res['block'] for res in four]}")
        for r, res in enumerate(four):
            for name, row in res["assembly"].items():
                gate(row["max_abs_err"] <= 1e-13 * row["scale"],
                     f"gloo4 rank {r}: the sharded {name} is {row} from the single-device one")
            gate(abs(res["iters"] - res["matfree_iters"]) <= 1
                 and res["max_abs_diff_vs_ell"] <= 1e-8, f"gloo4 rank {r}: {res}")
        gate(len({(res["u_digest"], res["iters"]) for res in four}) == 1,
             "gloo4: the ranks' u or iterations differ")

    # the path's launches: the two ranks' sharded assembly and three solves
    launches = ({k: sum(res["launches"][k] for res in worlds["gloo2"]["results"])
                 for k in worlds["gloo2"]["results"][0]["launches"]}
                if not failed else None)
    out = {"phase": "sharded", "n": MAIN_N, "launches": launches, "worlds": worlds,
           "phase_s": time.perf_counter() - t_phase,
           "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    for ok, what in gates:
        check(ok, what)
    return out


# ---------------------------------------------------------------------------
# lm: the LM harness's dense decoder family (A17a)
# ---------------------------------------------------------------------------

LM_DENSE_ARCHS = ("qwen3-4b", "qwen3-32b", "deepseek-67b", "nemotron-4-340b", "internvl2-26b")
LM_FAMILY_ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "rwkv6-1.6b", "zamba2-7b",
                   "whisper-tiny")
LM_ARCHS = LM_DENSE_ARCHS + LM_FAMILY_ARCHS
LM_PIN_SEED = 0
LM_PIN_SHAPE = (2, 16)                 # batch, text tokens
LM_PIN_FRAMES = 24                     # whisper-tiny's encoder frames in its pin case
LM_PIN_TRAIN = {"lr": 1e-3, "warmup": 1, "total_steps": 10}
LM_PIN_STEPS = 3
LM_PIN_LOGITS = 8                      # logits[:, 0, :8] of each row are pinned
LM_PIN_TOL = 1e-4                      # relative, on the card and in the CPU test
# The decode step reads the bfloat16 cache and rounds p to bfloat16 before
# P·V, as the reference does: a last-bit difference in a float32 k, v or p
# between the card and the CPU can move such an entry by one bfloat16 ulp,
# so the card's decode logits are held to JAX's within one bfloat16 ulp
# (2^-8) of scale, and to the port's CPU decode from the card's own cache
# within LM_PIN_TOL.
LM_PIN_DECODE_TOL = 2.0 ** -8
# The JAX package's numbers on the pin cases (``lm_pin_case``), measured on
# the CPU: the loss, the loss and grad norm of each of 3 optimizer steps on
# the same batch (the step's loss is taken before its update), the loss
# after them, and the prefill / one-decode-step logits (the first 8 of each
# row and the norm over the real vocabulary).
JAX_LM_PINS = {
    "qwen3-4b": {
        "loss": 5.901381969451904, "final_loss": 3.7568225860595703,
        "step_losses": [5.901381969451904, 5.014453411102295, 4.319572925567627],
        "step_grad_norms": [7.7017011642456055, 6.379878997802734, 6.08925199508667],
        "prefill": {"norm": 21.288331471563833, "head": [
            0.07698269933462143, 0.12820182740688324, -0.8348533511161804, 0.011488699354231358,
            1.3610143661499023, -0.6728768944740295, -0.6784833073616028, 1.2900500297546387,
            -0.16334980726242065, 0.5081207752227783, -1.0115400552749634, 0.2688653767108917,
            0.29161378741264343, -0.2475825548171997, 0.3618781268596649, 0.7262352705001831,
        ]},
        "decode": {"norm": 21.88612402162556, "head": [
            -0.5073102712631226, 0.31808701157569885, -0.8942578434944153, 0.4472994804382324,
            0.46658164262771606, -0.43989571928977966, -0.9117133021354675, 0.7130260467529297,
            0.0424654521048069, -0.7116301655769348, 2.1440463066101074, -0.09954910725355148,
            0.582161545753479, 1.8864554166793823, 0.5025530457496643, -0.2919577658176422,
        ]},
    },
    "qwen3-32b": {
        "loss": 5.901381969451904, "final_loss": 3.7568225860595703,
        "step_losses": [5.901381969451904, 5.014453411102295, 4.319572925567627],
        "step_grad_norms": [7.7017011642456055, 6.379878997802734, 6.08925199508667],
        "prefill": {"norm": 21.288331471563833, "head": [
            0.07698269933462143, 0.12820182740688324, -0.8348533511161804, 0.011488699354231358,
            1.3610143661499023, -0.6728768944740295, -0.6784833073616028, 1.2900500297546387,
            -0.16334980726242065, 0.5081207752227783, -1.0115400552749634, 0.2688653767108917,
            0.29161378741264343, -0.2475825548171997, 0.3618781268596649, 0.7262352705001831,
        ]},
        "decode": {"norm": 21.88612402162556, "head": [
            -0.5073102712631226, 0.31808701157569885, -0.8942578434944153, 0.4472994804382324,
            0.46658164262771606, -0.43989571928977966, -0.9117133021354675, 0.7130260467529297,
            0.0424654521048069, -0.7116301655769348, 2.1440463066101074, -0.09954910725355148,
            0.582161545753479, 1.8864554166793823, 0.5025530457496643, -0.2919577658176422,
        ]},
    },
    "deepseek-67b": {
        "loss": 5.966094493865967, "final_loss": 3.7213246822357178,
        "step_losses": [5.966094493865967, 5.040828704833984, 4.306770324707031],
        "step_grad_norms": [7.734354496002197, 6.729176998138428, 6.615397930145264],
        "prefill": {"norm": 21.329010548586403, "head": [
            -0.010750778950750828, 0.5254642963409424, -0.536795973777771, 0.448494553565979,
            1.1846648454666138, -0.4837603271007538, -0.9497647285461426, 1.3569540977478027,
            0.24461010098457336, 0.8563153743743896, -0.4558897912502289, 0.25550439953804016,
            0.16654668748378754, 0.2180889993906021, -0.03067731484770775, 0.34061214327812195,
        ]},
        "decode": {"norm": 21.51506833873277, "head": [
            -0.5327645540237427, 0.2994299530982971, -0.7007169723510742, 0.4592343866825104,
            0.47033578157424927, -0.2268950343132019, -1.0909688472747803, 0.7448234558105469,
            0.3173823058605194, -0.11100072413682938, 1.5236085653305054, 0.14551421999931335,
            0.21555599570274353, 1.2813743352890015, 0.666973888874054, -0.35803139209747314,
        ]},
    },
    "nemotron-4-340b": {
        "loss": 5.819390296936035, "final_loss": 3.2707228660583496,
        "step_losses": [5.819390296936035, 4.759725093841553, 3.908400058746338],
        "step_grad_norms": [7.526327610015869, 6.085470676422119, 5.173087120056152],
        "prefill": {"norm": 22.954579219792834, "head": [
            -1.9203100204467773, 0.4065743386745453, 1.5026620626449585, 1.1747066974639893,
            1.4484752416610718, 0.08590462803840637, -1.2385281324386597, 1.2431092262268066,
            -0.11211106926202774, -1.3345537185668945, 0.21348021924495697, -1.8493294715881348,
            0.6725641489028931, 0.07734557241201401, 0.5322287678718567, -0.24560312926769257,
        ]},
        "decode": {"norm": 22.52722944386327, "head": [
            -1.0071200132369995, -1.6009736061096191, 0.30737876892089844, -0.47637781500816345,
            0.8054092526435852, 2.3677492141723633, -0.8613043427467346, 1.9459081888198853,
            -0.368901789188385, -0.9774875640869141, -0.3351723551750183, -1.7527365684509277,
            0.6810330152511597, 0.7765281200408936, 1.3487484455108643, -0.41192227602005005,
        ]},
    },
    "internvl2-26b": {
        "loss": 6.013975143432617, "final_loss": 3.681288719177246,
        "step_losses": [6.013975143432617, 4.929405212402344, 4.212551116943359],
        "step_grad_norms": [8.189508438110352, 5.872615337371826, 5.171969413757324],
        "prefill": {"norm": 23.304532227860637, "head": [
            -0.07203083485364914, 2.067119836807251, 1.2955552339553833, 1.2562320232391357,
            1.4111764430999756, -0.9587210416793823, -0.30494433641433716, 1.032596230506897,
            -0.24706973135471344, -0.8248146772384644, 0.09129785746335983, -0.2506009042263031,
            1.8127670288085938, 0.9977678060531616, 1.1731551885604858, 1.7137551307678223,
        ]},
        "decode": {"norm": 22.513776082843574, "head": [
            -0.7224345207214355, 1.1829649209976196, -0.09421131759881973, 1.3884540796279907,
            0.5257292985916138, 0.5783681869506836, 0.5128270983695984, 1.1808069944381714,
            -0.9319416880607605, -0.3112335503101349, -0.2411395162343979, -0.3878796696662903,
            0.22397427260875702, 0.9808418154716492, 1.6688140630722046, 0.9667549133300781,
        ]},
    },
    "qwen3-moe-30b-a3b": {
        "loss": 6.314986705780029, "final_loss": 4.03675651550293,
        "step_losses": [6.314986705780029, 5.194511413574219, 4.660815715789795],
        "step_grad_norms": [6.862246036529541, 5.6453070640563965, 6.259795188903809],
        "prefill": {"norm": 23.027400872373967, "head": [
            0.2501823306083679, 0.3523837924003601, -1.0100561380386353, -1.92172110080719,
            -0.6134594082832336, 0.6212752461433411, -1.1775853633880615, 1.934861660003662,
            0.5565177798271179, 0.8095695972442627, -0.41134992241859436, 0.638436496257782,
            0.375395268201828, 0.036056049168109894, 0.7807801961898804, -1.1728590726852417,
        ]},
        "decode": {"norm": 22.90241505108468, "head": [
            0.7564656734466553, -0.21333958208560944, 0.1960456371307373, -0.5084850788116455,
            0.5143436789512634, 0.5276702642440796, 0.3334618806838989, 1.7254624366760254,
            0.2773328423500061, -1.8905012607574463, -0.7342661619186401, 0.9667069911956787,
            0.933770477771759, 1.2538782358169556, -0.6626486778259277, -2.1992745399475098,
        ]},
    },
    "llama4-maverick-400b-a17b": {
        "loss": 6.046197891235352, "final_loss": 3.4213404655456543,
        "step_losses": [6.046197891235352, 4.722609043121338, 3.657621383666992],
        "step_grad_norms": [8.405623435974121, 6.407298564910889, 5.721567153930664],
        "prefill": {"norm": 24.04938659596146, "head": [
            0.10037511587142944, -1.2644845247268677, 1.2219325304031372, -1.8508914709091187,
            1.9135160446166992, -0.4926224946975708, -1.7838213443756104, -0.6216846704483032,
            1.7359333038330078, 0.36280253529548645, -0.7642924785614014, 0.3311542868614197,
            -0.8610168695449829, -0.19195924699306488, 1.9223315715789795, 0.9504520297050476,
        ]},
        "decode": {"norm": 23.495879847095946, "head": [
            -1.3135403394699097, -0.6000087857246399, -0.9126715064048767, -0.03090474009513855,
            0.3887713551521301, -1.0475033521652222, -1.9932653903961182, -2.0580496788024902,
            0.08079995959997177, 0.196303129196167, -0.7929314374923706, -0.9280939698219299,
            -0.2214236855506897, -2.7940406799316406, -0.3537585437297821, -0.6671246886253357,
        ]},
    },
    "rwkv6-1.6b": {
        "loss": 6.086196422576904, "final_loss": 3.668578624725342,
        "step_losses": [6.086196422576904, 4.981728553771973, 4.203218460083008],
        "step_grad_norms": [2028.785888671875, 44.14396286010742, 68.43218231201172],
        "prefill": {"norm": 22.627771083419432, "head": [
            -0.3145429491996765, -0.5847053527832031, 0.13181491196155548, -0.5432112812995911,
            -1.0664868354797363, -0.5114272236824036, 0.7121044993400574, 0.10614582896232605,
            -1.9757702350616455, 0.9172000288963318, -0.06461819261312485, -1.015816569328308,
            0.8522946834564209, 1.9470436573028564, 0.2921687364578247, 1.2414401769638062,
        ]},
        "decode": {"norm": 23.664556811030508, "head": [
            -2.2096381187438965, 0.9836785793304443, -1.0279674530029297, -0.6952508687973022,
            -1.269500970840454, -0.32265669107437134, 0.2236274778842926, 0.3492327332496643,
            -0.9670823216438293, 1.2462575435638428, 0.40864238142967224, 1.1970654726028442,
            -0.636516273021698, -0.6120502352714539, 0.5224255919456482, -1.9599045515060425,
        ]},
    },
    "zamba2-7b": {
        "loss": 6.132490158081055, "final_loss": 3.6303539276123047,
        "step_losses": [6.132490158081055, 4.992997646331787, 4.218731880187988],
        "step_grad_norms": [10.792404174804688, 8.089300155639648, 7.079855918884277],
        "prefill": {"norm": 23.304585266460773, "head": [
            -1.5429387092590332, 0.5021837949752808, 0.34819895029067993, 1.564948558807373,
            0.4217771887779236, -0.4405800998210907, 0.024958953261375427, -0.08494970202445984,
            0.5943989157676697, 0.39692339301109314, -0.5612823963165283, 0.48421981930732727,
            2.1425044536590576, -0.07557955384254456, 0.37710538506507874, -0.6284205317497253,
        ]},
        "decode": {"norm": 24.572905871411024, "head": [
            0.6154999732971191, 1.3478524684906006, -2.877138376235962, -1.336215853691101,
            1.053246021270752, -1.1280027627944946, -0.5512241125106812, -2.3025455474853516,
            0.674457311630249, -0.39682459831237793, -0.6093084216117859, 0.5020235180854797,
            -2.462822914123535, 0.12098902463912964, 1.0344386100769043, -0.5180901885032654,
        ]},
    },
    "whisper-tiny": {
        "loss": 6.241849899291992, "final_loss": 4.570272445678711,
        "step_losses": [6.241849899291992, 5.375491142272949, 4.886719226837158],
        "step_grad_norms": [5.305478096008301, 3.756276845932007, 3.0948712825775146],
        "prefill": {"norm": 23.736238645061544, "head": [
            -1.4937021732330322, 0.3171631395816803, 0.8340499997138977, -1.8659087419509888,
            -0.6194753050804138, -1.3557943105697632, -0.4294300079345703, -3.2144768238067627,
            -1.8196532726287842, 0.13517287373542786, -0.4107019007205963, -2.103198766708374,
            0.7678393125534058, 0.08779062330722809, 0.1764543056488037, -3.0697262287139893,
        ]},
        "decode": {"norm": 23.59985127260201, "head": [
            -1.3012192249298096, 0.2724624574184418, 1.2651643753051758, -2.0417497158050537,
            -0.367735892534256, -1.5780600309371948, -0.4712269604206085, -3.3417069911956787,
            -2.242830514907837, 0.452923983335495, -0.17833884060382843, -2.5368852615356445,
            0.5684479475021362, -0.18784303963184357, 0.6665124893188477, -3.372729539871216,
        ]},
    },
}


def lm_pin_overrides(arch: str) -> dict:
    """The smoke config's overrides for the pins: float32 compute, and two
    microbatches for nemotron-4 and llama4-maverick (their bfloat16
    gradient accumulation)."""
    kw = {"compute_dtype": "float32"}
    if arch in ("nemotron-4-340b", "llama4-maverick-400b-a17b"):
        kw["microbatches"] = {"pin": 2}
    return kw


def lm_pin_case(arch: str):
    """(config, numpy parameters at the reference's law, numpy batch): the
    inputs that the port here and the JAX package in the CPU test share."""
    import dataclasses

    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import build_model
    from repro_torch.models.layers import numpy_params

    cfg = dataclasses.replace(smoke_variant(ARCHS[arch]), **lm_pin_overrides(arch))
    params = numpy_params(build_model(cfg).param_specs(), LM_PIN_SEED)
    rng = np.random.default_rng(LM_PIN_SEED + 1)
    b, s = LM_PIN_SHAPE
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.frontend == "patch_embed":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio_frames":
        batch["audio_embeds"] = rng.standard_normal(
            (b, LM_PIN_FRAMES, cfg.d_model)).astype(np.float32)
    return cfg, params, batch


def lm_pin_summary(logits) -> dict:
    """The pinned part of (B, 1, V) logits, from a host float array."""
    return {"head": [float(x) for x in logits[:, 0, :LM_PIN_LOGITS].reshape(-1)],
            "norm": float(np.linalg.norm(logits[:, 0].astype(np.float64)))}


def lm_pin_run(arch: str, device: str) -> dict:
    """The pin quantities of ``arch`` computed by the port on ``device``."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.models.layers import init_params, tree_map
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step

    cfg, host, hbatch = lm_pin_case(arch)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in hbatch.items()}
    out = {}
    with torch.no_grad():
        params = lm_params_from_numpy(host, device)
        out["loss"] = float(model.loss(params, batch))
        b, s = LM_PIN_SHAPE
        n_img = cfg.num_frontend_tokens if cfg.frontend == "patch_embed" else 0
        prompt = {k: (v[:, : s - 1] if k == "tokens" else v)
                  for k, v in batch.items() if k != "labels"}
        logits, cache = model.prefill(params, prompt, s + n_img)
        out["prefill"] = lm_pin_summary(logits.cpu().numpy())
        dbatch = {"tokens": batch["tokens"][:, s - 1:], "cache_len": s - 1 + n_img}
        if device != "cpu":     # the same decode on the host from this cache
            on_host = tree_map(lambda t: t.cpu(), cache)
            logits, _ = model.decode(lm_params_from_numpy(host, "cpu"),
                                     {"tokens": dbatch["tokens"].cpu(),
                                      "cache_len": dbatch["cache_len"]}, on_host)
            out["decode_host_same_cache"] = lm_pin_summary(logits.numpy())
        logits, _ = model.decode(params, dbatch, cache)
        out["decode"] = lm_pin_summary(logits.cpu().numpy())
    state = {"params": lm_params_from_numpy(host, device),
             "opt": init_params(make_optimizer(cfg.optimizer).init_specs(model.param_specs()),
                                torch.Generator(device), device),
             "step": torch.tensor(0, dtype=torch.int32)}
    step = make_train_step(cfg, ShapeSpec("pin", "train", LM_PIN_SHAPE[1], LM_PIN_SHAPE[0]),
                           **LM_PIN_TRAIN)
    losses, norms = [], []
    for _ in range(LM_PIN_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    with torch.no_grad():
        out["final_loss"] = float(model.loss(state["params"], batch))
    out["step_losses"], out["step_grad_norms"] = losses, norms
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _rel_logits(a: dict, b: dict) -> float:
    return max(_rel(a["head"], b["head"]), _rel(a["norm"], b["norm"]))


def lm_pin_errors(got: dict, pin: dict) -> dict:
    """Relative error of each pinned quantity (vectors: max |Δ| over max
    |pin|)."""
    return {"loss": _rel(got["loss"], pin["loss"]),
            "step_losses": _rel(got["step_losses"], pin["step_losses"]),
            "step_grad_norms": _rel(got["step_grad_norms"], pin["step_grad_norms"]),
            "final_loss": _rel(got["final_loss"], pin["final_loss"]),
            "prefill": _rel_logits(got["prefill"], pin["prefill"]),
            "decode": _rel_logits(got["decode"], pin["decode"])}


LM_SERVE = {"batch": 4, "prompt": 512, "decode_steps": 32, "check_layers": 4,
            "check_decode": 8}
LM_TRAIN = {"layers": 8, "batch": 8, "seq": 512, "microbatches": 2, "steps": 20,
            "lr": 3e-4, "warmup": 5}
LM_FREE_SHARE = 0.2                    # the train cell leaves a fifth of the card free
H100_BF16_PEAK = 989e12                # dense bf16 FLOP/s, H100 SXM data sheet


def _sync_s(fn):
    """(result, wall seconds) of ``fn()`` ended by a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _lm_profile(fn, host_ops: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler: wall (profiled), device
    busy time, idle share, the number of device kernels and the top ones.
    ``host_ops=False`` traces the device alone, which keeps a trace of
    100k launches quick to read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _open_trace()
        _, wall = _sync_s(fn)
    busy, top = _device_time(prof)
    n = sum(ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and not ev.key.startswith("tg.")
            and "spin_kernel" not in ev.key)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3), "kernels": n, "top": top}


# whisper-tiny: 30 s of audio (the encoder's 1,500 frames); a decoder prompt
# of 64 tokens to serve, and its 448-token context (Whisper's) to train
LM_WHISPER = {"frames": 1500, "prompt": 64}
F32_LOG_MAX = float(np.log(np.finfo(np.float32).max))     # 88.72: exp() above overflows
DECAY_PROBE_CHUNKS = (1, 4, 8, 16, 32, 64, 256)


def _decay_probe(fn) -> dict:
    """Run ``fn`` (a no-grad forward of an RWKV6 or Mamba2 model) with the
    chunked scans' inputs recorded: each scan's log-decay per step (RWKV6's
    logw, Mamba2's Δt·A) summed over the chunk-aligned windows of each size
    in ``DECAY_PROBE_CHUNKS``.  The chunked forms take exp of minus such a
    sum (RWKV6's exp(−Λ_incl), Mamba2's exp(Λ_t − Λ_s) before the mask), so
    a window below −88.72 overflows float32 and its rows turn NaN (ROADMAP
    C4, C5).  Returns the most negative window of each size over all scans,
    the number of scans with one below the limit, and the first scan whose
    output is not finite."""
    from unittest import mock

    from repro_torch.models import mamba2, rwkv6

    sums = {c: [] for c in DECAY_PROBE_CHUNKS}
    first_bad = []

    def record(logdecay, out):
        s = logdecay.shape[1]
        for c in DECAY_PROBE_CHUNKS:
            pad = -(-s // c) * c - s
            win = torch.nn.functional.pad(logdecay.movedim(1, -1), (0, pad))
            sums[c].append(float(win.reshape(*win.shape[:-1], -1, c).sum(-1).min()))
        if not first_bad and not bool(torch.isfinite(out).all()):
            first_bad.append(len(sums[1]) - 1)
        return out

    wkv, ssd = rwkv6._wkv_chunked, mamba2._ssd_chunked

    def wkv_rec(r, k, v, logw, u, state, chunk):
        out = wkv(r, k, v, logw, u, state, chunk)
        record(logw.float(), out[0])
        return out

    def ssd_rec(x, dt, a_log, b_in, c_in, state, chunk):
        out = ssd(x, dt, a_log, b_in, c_in, state, chunk)
        if x.shape[1] > 1:                                   # not a decode step
            record(dt.float() * -torch.exp(a_log.float()), out[0])
        return out

    with torch.no_grad(), mock.patch.object(rwkv6, "_wkv_chunked", wkv_rec), \
            mock.patch.object(mamba2, "_ssd_chunked", ssd_rec):
        fn()
    return {"scans": len(sums[1]),
            "min_window_sum": {c: min(v) for c, v in sums.items()},
            "scans_below_limit": {c: sum(x < -F32_LOG_MAX for x in v) for c, v in sums.items()},
            "first_nonfinite_scan": first_bad[0] if first_bad else None}


def _family_inputs(cfg, b, s, gen):
    """A batch's extra inputs on the card: whisper's encoder frames."""
    if cfg.frontend == "audio_frames":
        return {"audio_embeds": torch.randn((b, LM_WHISPER["frames"], cfg.d_model),
                                            generator=gen, device="cuda")}
    return {}


def _serve_cell(cfg, gate, prompt: int, decode_steps: int, host_ops: bool = False) -> dict:
    """``cfg`` served in bfloat16 (tp_degree 1): ``LM_SERVE["batch"]``
    prompts of ``prompt`` tokens from ``SyntheticLMData`` (whisper's with
    its encoder frames), then ``decode_steps`` greedy decode steps, twice
    (the second warm); a profiled prefill and decode step (``host_ops``: the
    host's ops traced too); an RWKV6 or Mamba2 scan's decay sums on the
    prompt."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.layers import init_params, tree_leaves
    from repro_torch.train import make_decode_fn, make_prefill_fn

    b, s, n_dec = LM_SERVE["batch"], prompt, decode_steps
    shape = ShapeSpec("lm_serve", "decode", s + n_dec, b)
    prefill, pspecs = make_prefill_fn(cfg, shape, tp_degree=1)
    decode, _, _ = make_decode_fn(cfg, shape, tp_degree=1)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(pspecs, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    weight_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    batch = {"tokens": torch.from_numpy(next(SyntheticLMData(cfg.vocab_size, s, b))["tokens"]).to(
        "cuda"), **_family_inputs(cfg, b, s, gen)}

    runs = []
    for _ in range(2):
        (logits, cache), t_prefill = _sync_s(lambda: prefill(params, batch))
        finite = torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(n_dec):
            logits, cache = decode(params, {"tokens": tok, "cache_len": s + i}, cache)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t1
        runs.append({"prefill_ms": t_prefill * 1e3,
                     "prefill_tokens_per_s": b * s / t_prefill,
                     "decode_ms_per_token": t_decode * 1e3 / n_dec,
                     "decode_tokens_per_s": b * n_dec / t_decode,
                     "finite": bool(finite)})
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    peak = torch.cuda.max_memory_allocated()
    profiled = {"prefill": _lm_profile(lambda: prefill(params, batch), host_ops),
                "decode_step": _lm_profile(lambda: decode(
                    params, {"tokens": tok, "cache_len": s + n_dec - 1}, cache), host_ops)}
    probe = (_decay_probe(lambda: prefill(params, batch))
             if cfg.family in ("ssm", "hybrid") else None)
    for run in runs:
        gate(run["finite"], f"serve {cfg.name}: non-finite logits {run}")
    del params, cache, logits
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "params": n_params, "weight_bytes": weight_bytes,
            "weights_dtype": "bfloat16", "batch": b, "prompt": s, "decode_steps": n_dec,
            "ssm_chunk": cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else None,
            "frames": LM_WHISPER["frames"] if cfg.frontend == "audio_frames" else None,
            "init_s": init_s, "cold": runs[0], "warm": runs[1], "profiled": profiled,
            "decay_probe": probe, "cache_bytes": cache_bytes, "peak_bytes": peak,
            "baseline_bytes": base}


def _train_cell(cfg, gate, batch_size: int, seq: int, microbatches: int, steps: int,
                lr: float, warmup: int, host_ops: bool = False) -> dict:
    """``cfg`` trained with its optimizer on ``batch_size`` × ``seq`` tokens
    (whisper with its encoder frames) in ``microbatches``, remat on:
    ``steps`` of ``make_train_step`` (peak learning rate ``lr`` after
    ``warmup`` steps) on ``SyntheticLMData`` through the prefetching device
    iterator; finite losses and grad norms, the last 5 losses below the
    first 5, a fifth of the card left free; a profiled step; an RWKV6 or
    Mamba2 scan's decay sums on the first batch."""
    import dataclasses

    from repro_torch.configs import ShapeSpec
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.models.layers import init_params, tree_leaves
    from repro_torch.train import make_train_state_specs, make_train_step

    cfg = dataclasses.replace(cfg, microbatches={"lm_train": microbatches})
    shape = ShapeSpec("lm_train", "train", seq, batch_size)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(0)
    state = init_params(make_train_state_specs(cfg), gen, "cuda")
    state["step"] = state["step"].cpu()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    step = make_train_step(cfg, shape, lr=lr, warmup=warmup, total_steps=steps)
    extra = _family_inputs(cfg, batch_size, seq, gen)
    it = SyntheticLMData(cfg.vocab_size, seq, batch_size).device_iterator("cuda")
    losses, norms, walls = [], [], []
    probe = None
    try:
        if cfg.family in ("ssm", "hybrid"):
            first = {**next(it), **extra}
            probe = _decay_probe(lambda: build_model(cfg).loss(state["params"], first))
        for _ in range(steps):
            batch = {**next(it), **extra}
            (state, metrics), wall = _sync_s(lambda: step(state, batch))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            walls.append(wall)
        peak = torch.cuda.max_memory_allocated()
        batch = {**next(it), **extra}
        profiled = _lm_profile(lambda: step(state, batch), host_ops)
    finally:
        it.close()
    total = torch.cuda.get_device_properties(0).total_memory
    warm = statistics.median(walls[1:])
    tokens = batch_size * seq
    gate(all(math.isfinite(x) for x in losses + norms),
         f"train {cfg.name}: non-finite {losses} {norms}")
    gate(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
         f"train {cfg.name}: the loss did not fall {losses}")
    gate(peak <= (1 - LM_FREE_SHARE) * total,
         f"train {cfg.name}: peak {peak} bytes leaves less than a fifth of {total}")
    del state
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "params": n_params, "optimizer": cfg.optimizer,
            "batch": batch_size, "seq": seq, "microbatches": microbatches, "lr": lr,
            "remat": cfg.remat, "ssm_chunk": cfg.ssm_chunk if cfg.family in ("ssm", "hybrid")
            else None, "decay_probe": probe, "losses": losses, "grad_norms": norms,
            "step_ms": [w * 1e3 for w in walls], "first_step_ms": walls[0] * 1e3,
            "warm_step_ms_median": warm * 1e3, "tokens_per_s": tokens / warm,
            "profiled_step": profiled, "peak_bytes": peak, "baseline_bytes": base,
            "card_bytes": total}


def _lm_serve(gate) -> dict:
    """Full-width qwen3-4b served in bfloat16 (``_serve_cell``: all 36
    layers, 4 prompts of 512 tokens, 32 greedy decode steps); then the
    depth-4 float32 check of the decode logits against a full forward over
    the same tokens."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import decoder_forward

    cfg = ARCHS["qwen3-4b"]
    b, s = LM_SERVE["batch"], LM_SERVE["prompt"]
    out = _serve_cell(cfg, gate, s, LM_SERVE["decode_steps"], host_ops=True)
    prompt = torch.from_numpy(next(SyntheticLMData(cfg.vocab_size, s, b))["tokens"]).to("cuda")

    # the cache against a full forward: depth 4, float32 compute, same tokens
    cfg4 = dataclasses.replace(cfg, num_layers=LM_SERVE["check_layers"], compute_dtype="float32")
    model = build_model(cfg4, tp_degree=1)
    n_chk = LM_SERVE["check_decode"]
    with torch.no_grad():
        p4 = init_params(model.param_specs(), torch.Generator("cuda").manual_seed(1), "cuda")
        logits, cache = model.prefill(p4, {"tokens": prompt}, s + n_chk)
        toks = [prompt]
        got = [logits[:, 0]]
        for i in range(n_chk):
            tok = got[-1].argmax(-1, keepdim=True)
            toks.append(tok)
            logits, cache = model.decode(p4, {"tokens": tok, "cache_len": s + i}, cache)
            got.append(logits[:, 0])
        full, _ = decoder_forward(cfg4, p4, {"tokens": torch.cat(toks, dim=1)})
        want = full[:, s - 1:s + n_chk]
        got = torch.stack(got, dim=1)
        err = float((got - want).abs().max())
        ratio = float(((got - want).abs() / (2e-2 + 2e-2 * want.abs())).max())
    gate(ratio <= 1.0, f"lm serve: decode logits {err} from the full forward (2e-2)")
    del p4, cache, full, got, want
    torch.cuda.empty_cache()
    return {"arch": "qwen3-4b", **out,
            "check": {"layers": cfg4.num_layers, "compute": "float32", "decode_steps": n_chk,
                      "max_abs_err": err, "err_over_tol": ratio}}


def _lm_train_flops(cfg, tokens: int, seq: int) -> tuple[int, int]:
    """(model FLOPs of one train step, the matmul weights N): 6·N·tokens for
    the weight products (N: the layers' and the unembedding's weights, not
    the embedding gather) plus 3 × the attention products (q·k and p·v over
    the full square that ``flash_attention`` computes); remat's recompute
    is not counted."""
    d, h, kv, hd, ff = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = d * h * hd * 2 + 2 * d * kv * hd + 3 * d * ff
    n = cfg.num_layers * per_layer + d * cfg.padded_vocab
    attn = 3 * 2 * 2 * tokens * seq * h * hd * cfg.num_layers
    return 6 * n * tokens + attn, n


def _lm_train(gate) -> dict:
    """qwen3-4b at full width and depth 8 (``_train_cell``): AdamW, batch
    8 × 512 in two microbatches, remat on, 20 steps; its model FLOPs and
    their rate against the bf16 peak."""
    import dataclasses

    from repro_torch.configs import ARCHS

    t = LM_TRAIN
    cfg = dataclasses.replace(ARCHS["qwen3-4b"], num_layers=t["layers"])
    out = _train_cell(cfg, gate, t["batch"], t["seq"], t["microbatches"], t["steps"], t["lr"],
                      t["warmup"], host_ops=True)
    warm = out["warm_step_ms_median"] / 1e3
    flops, n_matmul = _lm_train_flops(cfg, t["batch"] * t["seq"], t["seq"])
    return {"arch": "qwen3-4b", **out, "matmul_params": n_matmul, "model_flops_per_step": flops,
            "model_tflops_per_s": flops / warm / 1e12, "mfu_vs_bf16_peak": flops / warm / H100_BF16_PEAK}



def _lm_launcher(gate) -> dict:
    """``repro_torch.launch.train`` at ``--smoke`` on the card: 20 steps with
    checkpoints every 10, then a relaunch to 35 that must resume at 20."""
    import contextlib
    import io
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import main as train_main

    ckpt = ROOT / "build" / "lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ["--arch", "qwen3-4b", "--smoke", "--seq-len", "64", "--batch", "8",
            "--ckpt-dir", str(ckpt), "--ckpt-every", "10", "--log-every", "100",
            "--device", "cuda"]
    runs = []
    for steps in (20, 35):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            loss = train_main(args + ["--steps", str(steps)])
        runs.append({"steps": steps, "final_loss": loss, "wall_s": time.perf_counter() - t0,
                     "latest_step": CheckpointManager(str(ckpt)).latest_step(),
                     "log": buf.getvalue().splitlines()})
    gate(runs[0]["latest_step"] == 20, f"lm launcher: first run ended at {runs[0]}")
    gate("[resume] restoring step 20" in runs[1]["log"][0],
         f"lm launcher: the relaunch did not resume at 20: {runs[1]['log'][:2]}")
    gate(runs[1]["latest_step"] == 35 and math.isfinite(runs[1]["final_loss"]),
         f"lm launcher: relaunch {runs[1]}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"runs": runs}


def _lm_f32_contractions() -> dict:
    """What the float32 results of bfloat16 contractions cost: the
    unembedding at the decode (4 tokens) and train-microbatch (2,048 tokens)
    shapes, as ``dot_f32`` computes it (operands widened to float32), beside
    a bfloat16 product and, where this torch has it, ``torch.mm(...,
    out_dtype=torch.float32)``."""
    from repro_torch.models.layers import dot_f32

    gen = torch.Generator("cuda").manual_seed(2)
    w = torch.randn((2560, 152064), generator=gen, device="cuda").bfloat16()
    out = {}
    for rows in (4, 2048):
        x = torch.randn((rows, 2560), generator=gen, device="cuda").bfloat16()
        row = {"dot_f32_ms": time_ms(lambda: dot_f32(x, w), reps=10),
               "bf16_mm_ms": time_ms(lambda: x @ w, reps=10)}
        try:
            ref = dot_f32(x, w)
            got = torch.mm(x, w, out_dtype=torch.float32)
            row["mm_out_dtype_ms"] = time_ms(lambda: torch.mm(x, w, out_dtype=torch.float32),
                                             reps=10)
            row["mm_out_dtype_max_rel_err"] = float((got - ref).abs().max() / ref.abs().max())
        except (TypeError, RuntimeError, NotImplementedError) as exc:
            row["mm_out_dtype_ms"] = None
            row["mm_out_dtype_error"] = f"{type(exc).__name__}: {str(exc)[:120]}"
        out[f"rows_{rows}"] = row
    return out


def phase_lm():
    """The LM harness's dense decoder family (A17a): (a) the five ported
    architectures at smoke width in float32 against pinned JAX numbers; (b)
    qwen3-4b served at full width; (c) qwen3-4b trained at full width and
    depth 8; (d) the launcher's checkpoint and resume.  (b)-(d) are the
    path whose kernel launches are counted: it launches none of B1-B6."""
    from repro_torch import kernels

    gates = []

    def gate(cond, what):
        gates.append((bool(cond), what))

    t_phase = time.perf_counter()
    pins = {}
    for arch in LM_DENSE_ARCHS:
        got = lm_pin_run(arch, "cuda")
        errs = lm_pin_errors(got, JAX_LM_PINS[arch])
        errs["decode_vs_host_same_cache"] = _rel_logits(got["decode"],
                                                        got["decode_host_same_cache"])
        pins[arch] = {"errors": errs, "got": got}
        gate(max(v for k, v in errs.items() if k != "decode") <= LM_PIN_TOL
             and errs["decode"] <= LM_PIN_DECODE_TOL, f"lm pins {arch}: {errs}")
    kernels.reset_launches()
    serve = _lm_serve(gate)
    train = _lm_train(gate)
    launcher = _lm_launcher(gate)
    launches = dict(kernels.LAUNCHES)
    contractions = _lm_f32_contractions()
    out = {"phase": "lm", "pins": pins, "serve": serve, "train": train, "launcher": launcher,
           "f32_contractions": contractions, "launches": launches,
           "phase_s": time.perf_counter() - t_phase,
           "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    for ok, what in gates:
        check(ok, what)
    return out


# ---------------------------------------------------------------------------
# lm_families: the MoE, RWKV6, Mamba2, hybrid and audio families (A17b)
# ---------------------------------------------------------------------------

LM_FAMILY_TRAIN = {"steps": 10, "lr": 3e-4, "warmup": 3}
# each published configuration's cells: the serve config's overrides (its
# depth; the scans' chunk, ROADMAP C4/C5; a prompt length or decode steps
# other than LM_SERVE's), and the train config's with the train batch and a
# learning rate other than LM_FAMILY_TRAIN's (None: no train cell).  The
# chunked scans are a Python loop of small launches a chunk, so zamba2's
# prompt and both scans' train batches are cut to what the phase's time
# allows; rwkv6 trains at lr 3e-5, as at 3e-4 its loss rose and was NaN
# from the fourth step (PERF.md §6; ROADMAP C4).
LM_FAMILY_CELLS = {
    "rwkv6-1.6b": ({"ssm_chunk": 8},
                   {"ssm_chunk": 8, "batch": 8, "seq": 128, "microbatches": 1, "lr": 3e-5}),
    "zamba2-7b": ({"ssm_chunk": 8, "prompt": 128, "decode_steps": 16},
                  {"num_layers": 12, "ssm_chunk": 8, "batch": 8, "seq": 128,
                   "microbatches": 1}),
    "whisper-tiny": ({"prompt": LM_WHISPER["prompt"]}, {"batch": 8, "seq": 448, "microbatches": 2}),
    "qwen3-moe-30b-a3b": ({"num_layers": 24},
                          {"num_layers": 2, "batch": 8, "seq": 512, "microbatches": 2}),
    "llama4-maverick-400b-a17b": ({"num_layers": 1}, None),
}
def _moe_split(cfg) -> dict:
    """One MoE layer of ``cfg`` at its widths in bfloat16 on the serve cell's
    prompt batch (4 × 512): device time of ``moe_apply`` and of its parts —
    the router (gates, top-k, the (G, T, E, C) dispatch and combine
    tensors), the dispatch contraction ``gtec,gtd→gecd``, the expert
    products, the combine contraction ``gtec,gecd→gtd`` and the shared
    expert — by CUDA events, median of 10."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.layers import P, init_params, tree_map

    cfg = dataclasses.replace(cfg, num_layers=1)
    specs = tree_map(lambda sp: P(sp.shape, sp.axes, sp.init, sp.scale, torch.bfloat16),
                     moe.moe_specs(cfg))
    gen = torch.Generator("cuda").manual_seed(3)
    params = init_params(specs, gen, "cuda")
    b, s = LM_SERVE["batch"], LM_SERVE["prompt"]
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").bfloat16()
    with torch.no_grad():
        dispatch, combine, _ = moe.route(cfg, params, x)
        dispatch, combine = dispatch.bfloat16(), combine.bfloat16()
        expert_in = torch.einsum("gtec,gtd->gecd", dispatch, x)
        expert_out = moe.experts(params, expert_in)
        parts = {
            "route": time_ms(lambda: moe.route(cfg, params, x), reps=10),
            "dispatch_contraction": time_ms(lambda: torch.einsum("gtec,gtd->gecd", dispatch, x),
                                            reps=10),
            "expert_products": time_ms(lambda: moe.experts(params, expert_in), reps=10),
            "combine_contraction": time_ms(
                lambda: torch.einsum("gtec,gecd->gtd", combine, expert_out), reps=10),
        }
        if cfg.moe_shared_expert:
            parts["shared_expert"] = time_ms(lambda: moe.shared_expert(params["shared"], x),
                                             reps=10)
        layer = time_ms(lambda: moe.moe_apply(cfg, params, x), reps=10)
    e, c = cfg.num_experts, dispatch.shape[-1]
    dense = parts["dispatch_contraction"] + parts["combine_contraction"]
    out = {"experts": e, "top_k": cfg.experts_per_token, "capacity": c,
           "dispatch_shape": [b, s, e, c], "moe_apply_ms": layer, "parts_ms": parts,
           "dense_dispatch_combine_share": dense / layer,
           "router_share": parts["route"] / layer,
           "expert_products_share": parts["expert_products"] / layer,
           # the expert products' FLOPs at these slots against the tokens' own
           "slot_flops_over_token_flops": e * c / (s * cfg.experts_per_token)}
    del params, x, dispatch, combine, expert_in, expert_out
    torch.cuda.empty_cache()
    return out


def _family_checks(gate) -> dict:
    """The families at smoke width in float32 on the card: RWKV6 and Mamba2
    chunked against stepwise (the reference tests' bars, 1e-3 and 5e-2),
    RWKV6's chunk-size invariance (chunks 8, 16, 20 over 40 tokens), the
    chunked WKV's overflow at chunk 64 (ROADMAP C4: the same rows finite as
    on the host, agreeing), and MoE routing on tied gates (a zero router:
    every token to experts 0..k-1, the first C tokens kept, the output
    against the host's at 1e-4)."""
    import dataclasses

    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import build_model, moe, rwkv6
    from repro_torch.models.hybrid import hybrid_forward
    from repro_torch.models.layers import numpy_params
    from repro_torch.models.transformer import decoder_forward

    out = {}

    def stepwise(model, params, tokens):
        s = tokens.shape[1]
        logits, cache = model.prefill(params, {"tokens": tokens[:, :1]}, s)
        got = [logits[:, 0]]
        for t in range(1, s):
            logits, cache = model.decode(params, {"tokens": tokens[:, t:t + 1], "cache_len": t},
                                         cache)
            got.append(logits[:, 0])
        return torch.stack(got, dim=1)

    def ratio(got, want, tol):
        return float(((got - want).abs() / (tol + tol * want.abs())).max())

    with torch.no_grad():
        for arch, s, tol in (("rwkv6-1.6b", 48, 1e-3), ("zamba2-7b", 32, 5e-2)):
            cfg = dataclasses.replace(smoke_variant(ARCHS[arch]), compute_dtype="float32")
            model = build_model(cfg, tp_degree=1)
            params = lm_params_from_numpy(numpy_params(model.param_specs(), 0), "cuda")
            tokens = torch.from_numpy(np.random.default_rng(3).integers(
                0, cfg.vocab_size, (2, s))).to("cuda")
            full = (decoder_forward(cfg, params, {"tokens": tokens})[0] if cfg.family == "ssm"
                    else hybrid_forward(cfg, params, {"tokens": tokens}))
            r = ratio(stepwise(model, params, tokens), full, tol)
            out[f"{arch}_chunked_vs_stepwise"] = {"tokens": s, "bar": tol, "err_over_bar": r}
            gate(r <= 1.0, f"lm_families: {arch} chunked against stepwise {r} of the bar {tol}")

        tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 40))).to("cuda")
        logits = []
        for chunk in (8, 16, 20):
            cfg = dataclasses.replace(smoke_variant(ARCHS["rwkv6-1.6b"]),
                                      compute_dtype="float32", ssm_chunk=chunk)
            params = lm_params_from_numpy(numpy_params(build_model(cfg).param_specs(), 0), "cuda")
            logits.append(decoder_forward(cfg, params, {"tokens": tokens})[0])
        inv = max(ratio(lg, logits[0], 1e-3) for lg in logits[1:])
        out["rwkv6_chunk_invariance"] = {"chunks": [8, 16, 20], "err_over_bar": inv}
        gate(inv <= 1.0, f"lm_families: rwkv6 chunk-size invariance {inv} of the bar 1e-3")

        rng = np.random.default_rng(5)
        b, s, h, d = 1, 100, 2, 4
        r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
        u = rng.standard_normal((h, d)).astype(np.float32)
        state = rng.standard_normal((b, h, d, d)).astype(np.float32)
        logw = np.full((b, s, h, d), -2.0, np.float32)
        c4 = {}
        for chunk in (16, 64):
            args = [torch.from_numpy(a) for a in (r, k, v, logw, u, state)]
            host = rwkv6._wkv_chunked(*args, chunk)[0]
            card = rwkv6._wkv_chunked(*(a.cuda() for a in args), chunk)[0].cpu()
            hfin = torch.isfinite(host).all(-1).all(-1)[0]
            cfin = torch.isfinite(card).all(-1).all(-1)[0]
            agree = float(_rel(card[:, cfin].numpy(), host[:, hfin].numpy())) if bool(
                cfin.any()) else 0.0
            c4[chunk] = {"finite_rows": int(cfin.sum()), "same_rows": bool(torch.equal(hfin, cfin)),
                         "max_rel_err_finite": agree}
        out["rwkv6_chunk_overflow_c4"] = c4
        gate(c4[16]["finite_rows"] == s and c4[64]["finite_rows"] == s - 64
             and c4[16]["same_rows"] and c4[64]["same_rows"]
             and max(c4[16]["max_rel_err_finite"], c4[64]["max_rel_err_finite"]) <= 1e-4,
             f"lm_families: the chunked WKV's overflow (C4) differs from the host's: {c4}")

        cfg = dataclasses.replace(smoke_variant(ARCHS["qwen3-moe-30b-a3b"]),
                                  compute_dtype="float32")
        host_params = numpy_params(moe.moe_specs(cfg), 3)
        host_params["router"] = np.zeros_like(host_params["router"])
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (2, 24, cfg.d_model)).astype(np.float32))
        want, _ = moe.moe_apply(cfg, lm_params_from_numpy(host_params, "cpu"), x)
        got, _ = moe.moe_apply(cfg, lm_params_from_numpy(host_params, "cuda"), x.cuda())
        gates = torch.full((2, 24, cfg.num_experts), 1.0 / cfg.num_experts, device="cuda")
        idx = moe.top_k_lower_index_first(gates, cfg.experts_per_token)[1]
        c = moe._capacity(cfg, 24)
        kept = (got.abs().sum(-1) > 0).cpu()
        ties = {"experts_chosen": sorted(int(i) for i in idx.unique().cpu()),
                "capacity": c, "kept_first_c_only": bool(kept[:, :c].all() and not kept[:, c:].any()),
                "max_rel_err_vs_host": _rel(got.cpu().numpy(), want.numpy())}
        out["moe_tied_gates"] = ties
        gate(ties["experts_chosen"] == list(range(cfg.experts_per_token))
             and ties["kept_first_c_only"] and ties["max_rel_err_vs_host"] <= 1e-4,
             f"lm_families: MoE routing on tied gates {ties}")
    return out


def phase_lm_families():
    """The LM harness's remaining families (A17b): (a) all ten
    architectures at smoke width in float32 against pinned JAX numbers;
    (b) the families' checks at smoke width; (c) the published widths
    (``LM_FAMILY_CELLS``): rwkv6-1.6b served and trained at full depth and
    zamba2-7b served at full depth and trained at 12 layers, both at
    ssm_chunk 8 (ROADMAP C4, C5), with their scans' decay sums probed;
    whisper-tiny served and trained at full size on 1,500 frames;
    qwen3-moe-30b-a3b served at depth 24 and trained at depth 2;
    llama4-maverick-400b-a17b served at depth 1; (d) one MoE layer of each
    at 128 experts split into router, dense dispatch and combine, and
    expert products.  (c) is the path whose kernel launches are counted: it
    launches none of B1-B6."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import ARCHS

    gates = []

    def gate(cond, what):
        gates.append((bool(cond), what))

    t_phase = time.perf_counter()
    pins = {}
    for arch in LM_ARCHS:
        got = lm_pin_run(arch, "cuda")
        errs = lm_pin_errors(got, JAX_LM_PINS[arch])
        errs["decode_vs_host_same_cache"] = _rel_logits(got["decode"],
                                                        got["decode_host_same_cache"])
        pins[arch] = {"errors": errs, "got": got}
        gate(max(v for k, v in errs.items() if k != "decode") <= LM_PIN_TOL
             and errs["decode"] <= LM_PIN_DECODE_TOL, f"lm_families pins {arch}: {errs}")
    t_pins = time.perf_counter() - t_phase
    checks = _family_checks(gate)
    kernels.reset_launches()
    cells = {}
    for arch, (serve_kw, train_kw) in LM_FAMILY_CELLS.items():
        t_cell = time.perf_counter()
        kw = dict(serve_kw)
        sizes = [kw.pop(k, LM_SERVE[k]) for k in ("prompt", "decode_steps")]
        cell = {"serve": _serve_cell(dataclasses.replace(ARCHS[arch], **kw), gate, *sizes)}
        if train_kw is not None:
            kw = dict(train_kw)
            sizes = [kw.pop(k) for k in ("batch", "seq", "microbatches")]
            t = {**LM_FAMILY_TRAIN, **({"lr": kw.pop("lr")} if "lr" in kw else {})}
            cell["train"] = _train_cell(dataclasses.replace(ARCHS[arch], **kw), gate, *sizes,
                                        t["steps"], t["lr"], t["warmup"])
        cell["cell_s"] = time.perf_counter() - t_cell
        cells[arch] = cell
    launches = dict(kernels.LAUNCHES)
    moe_split = {arch: _moe_split(ARCHS[arch])
                 for arch in ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")}
    out = {"phase": "lm_families", "pins": pins, "pins_s": t_pins, "checks": checks,
           "cells": cells, "moe_split": moe_split, "launches": launches,
           "phase_s": time.perf_counter() - t_phase,
           "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    for ok, what in gates:
        check(ok, what)
    return out


# ---------------------------------------------------------------------------
# lm_layout: the LM's 2-D layout on DTensor and the dry-run tooling (A17c)
# ---------------------------------------------------------------------------

# (a) the `lm` phase's train cell on a (1, 1) mesh of one NCCL rank
LAYOUT_ONE = {"layers": 8, "batch": 8, "seq": 512, "microbatches": 2, "steps": 10,
              "lr": 3e-4, "warmup": 5}
LAYOUT_ONE_TOL = 1e-6                  # relative, if the losses are not bit-equal
# (b) four gloo ranks on the one card, a (2, 2) mesh
LAYOUT_FOUR = {"layers": 2, "batch": 8, "seq": 128, "steps": 3, "lr": 3e-4, "warmup": 1,
               "prefill_batch": 4, "prompt": 128, "decode_steps": 8}
LAYOUT_FOUR_TOL = 5e-3                 # relative to the one-rank run: bf16 compute, TP sums
LAYOUT_LOGITS_TOL = 2.0 ** -7          # bf16 compute: two bf16 ulps of the logits' scale
# float32 compute on the same bf16 weights: prefill 1e-4 of scale, decode one
# bf16 ulp (it reads the bf16 cache) — the CPU tests' bars
LAYOUT_LOGITS_F32_TOL = (1e-4, 2.0 ** -8)
# (c) the dry-run on the host, and (d) the launcher under torchrun
LAYOUT_DRYRUN_ARCH = "qwen3-4b"
LAYOUT_PERF = ("train_4k", "baseline,seqpar,dp_attn")
LAYOUT_LAUNCH = {"first": 6, "second": 10, "every": 3, "lr": 3e-2}
LAYOUT_GROUP_TIMEOUT_S = 120


class _CollectiveTap:
    """The functional collectives DTensor issues, tapped where it calls
    them (``torch.distributed._functional_collectives``): their bytes by
    kind (results; the operand of a reduce-scatter), their count, and —
    with ``timed`` — their wall time between two device synchronisations
    (gloo stages a CUDA tensor through host memory)."""

    # the names under which torch's releases have DTensor call them
    KINDS = {"all_reduce": "all-reduce", "all_gather_tensor": "all-gather",
             "all_gather_tensor_autograd": "all-gather", "all_gather_single": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_autograd": "reduce-scatter",
             "reduce_scatter_single": "reduce-scatter",
             "all_to_all_single": "all-to-all", "all_to_all_single_autograd": "all-to-all"}

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.bytes = {k: 0 for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                     "collective-permute")}
        self.counts = dict.fromkeys(self.bytes, 0)
        self.seconds = 0.0
        self._saved = {}
        self._depth = 0

    def __enter__(self):
        import torch.distributed._functional_collectives as funcol
        import torch.distributed.tensor._collective_utils as cu
        import torch.distributed.tensor.placement_types as pt

        for name, kind in self.KINDS.items():
            fn = getattr(funcol, name, None)
            if fn is not None:
                self._saved[(funcol, name)] = fn
                setattr(funcol, name, self._wrap(fn, kind))
        # the all-to-all of a Shard(i) → Shard(j) redistribute, where DTensor
        # calls it through its own helper (a custom op on a CUDA mesh; on a
        # CPU mesh the helper all-gathers through the functions above)
        for mod in (cu, pt):
            fn = getattr(mod, "shard_dim_alltoall", None)
            if fn is not None:
                self._saved[(mod, "shard_dim_alltoall")] = fn
                setattr(mod, "shard_dim_alltoall", self._wrap(fn, "all-to-all", helper=True))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self._saved.items():
            setattr(mod, name, fn)

    def _wrap(self, fn, kind, helper: bool = False):
        def tapped(tensor, *args, **kwargs):
            before = sum(self.counts.values())
            timed = self.timed and not self._depth
            self._depth += 1
            try:
                if timed:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                out = fn(tensor, *args, **kwargs)
                if timed:
                    if hasattr(out, "wait"):
                        out = out.wait()
                    torch.cuda.synchronize()
                    self.seconds += time.perf_counter() - t0
            finally:
                self._depth -= 1
            if helper and sum(self.counts.values()) > before:
                return out              # the helper's own collectives were tapped
            src = tensor if kind == "reduce-scatter" else out
            self.bytes[kind] += src.numel() * src.element_size()
            self.counts[kind] += 1
            return out

        return tapped


def _layout_cfg(layers: int, **kw):
    import dataclasses

    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS["qwen3-4b"], num_layers=layers, **kw)


def _layout_state(specs, shardings, seed: int):
    """A train state drawn on the card from ``seed`` (every rank the same
    draw): the parameters drawn whole and placed (``distribute_tree``: each
    rank keeps its shard), the optimizer's zeros allocated shard by shard;
    without shardings the whole state."""
    from repro_torch.models.layers import init_params
    from repro_torch.sharding import distribute_tree

    gen = torch.Generator("cuda").manual_seed(seed)
    params = init_params(specs["params"], gen, "cuda")
    if shardings is None:
        opt = init_params(specs["opt"], gen, "cuda")
        return {"params": params, "opt": opt, "step": torch.zeros((), dtype=torch.int32)}
    params = distribute_tree(params, shardings["params"])
    opt = _zeros_placed(specs["opt"], shardings["opt"])
    return {"params": params, "opt": opt, "step": torch.zeros((), dtype=torch.int32)}


def _zeros_placed(specs, shardings):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if isinstance(specs, dict):
        return {k: _zeros_placed(specs[k], shardings[k]) for k in specs}
    sh = shardings
    local, _ = compute_local_shape_and_global_offset(specs.shape, sh.mesh, sh.placements)
    return DTensor.from_local(torch.zeros(local, dtype=specs.dtype, device="cuda"), sh.mesh,
                              sh.placements, run_check=False, shape=torch.Size(specs.shape),
                              stride=torch.empty(specs.shape, device="meta").stride())


def _layout_batches(cfg, seq: int, batch: int, n: int) -> list:
    from repro_torch.data import SyntheticLMData

    data = SyntheticLMData(cfg.vocab_size, seq, batch)
    return [next(data) for _ in range(n)]


def _layout_steps(step, state, batches, place) -> tuple:
    """``len(batches)`` steps: (state, losses, grad norms, wall seconds)."""
    losses, norms, walls = [], [], []
    for b in batches:
        b = place(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return state, losses, norms, walls


def _layout_one(rank: int, size: int) -> dict:
    """(a) qwen3-4b at its published widths and depth 8 on a (1, 1) mesh of
    one NCCL rank: ``jit_train_step`` against ``make_train_step`` from the
    same draw, 10 steps each; then one step under the op counter."""
    from repro_torch.analysis.op_cost import count_ops
    from repro_torch.analysis.roofline import analyze
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import model_flops_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import RULES_SINGLE_POD, distribute_tree
    from repro_torch.train import jit_train_step, make_train_step

    t = LAYOUT_ONE
    cfg = _layout_cfg(t["layers"], microbatches={"lm_layout": t["microbatches"]})
    shape = ShapeSpec("lm_layout", "train", t["seq"], t["batch"])
    kw = {"lr": t["lr"], "warmup": t["warmup"], "total_steps": t["steps"]}
    batches = _layout_batches(cfg, t["seq"], t["batch"], t["steps"] + 1)
    out = {}

    def on_card(b):
        return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}

    # the unsharded step first, then the same draw on the (1, 1) mesh
    step = make_train_step(cfg, shape, **kw)
    from repro_torch.train import make_train_state_specs

    specs = make_train_state_specs(cfg)
    state = _layout_state(specs, None, LM_PIN_SEED)
    state, losses, norms, walls = _layout_steps(step, state, batches[:-1], on_card)
    out["plain"] = {"losses": losses, "grad_norms": norms, "step_ms": [w * 1e3 for w in walls],
                    "peak_bytes": torch.cuda.max_memory_allocated()}
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    mesh = make_host_mesh(1, 1, device_type="cuda")
    sstep, specs, state_sh, batch_sh = jit_train_step(cfg, shape, mesh, RULES_SINGLE_POD, **kw)
    state = _layout_state(specs, state_sh, LM_PIN_SEED)
    state, losses, norms, walls = _layout_steps(
        sstep, state, batches[:-1], lambda b: distribute_tree(on_card(b), batch_sh))
    out["sharded"] = {"losses": losses, "grad_norms": norms,
                      "step_ms": [w * 1e3 for w in walls],
                      "peak_bytes": torch.cuda.max_memory_allocated()}

    # one more step under the op counter: the port's roofline of this cell
    batch = distribute_tree(on_card(batches[-1]), batch_sh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with count_ops() as counter:
        sstep(state, batch)
    torch.cuda.synchronize()
    rep = analyze(counter.cost, arch="qwen3-4b", shape="lm_layout", mesh_name="1x1", chips=1,
                  model_flops=model_flops_for(cfg, shape))
    out["roofline"] = {**{k: v for k, v in rep.row().items() if k != "collectives"},
                       "counted_step_ms": (time.perf_counter() - t0) * 1e3,
                       "collective_bytes": rep.collective_bytes,
                       "bytes_upper": counter.cost.bytes_upper}
    out["launches"] = dict(_kernel_launches())
    return out


def _kernel_launches() -> dict:
    from repro_torch import kernels

    return kernels.LAUNCHES


def _layout_four(rank: int, size: int) -> dict:
    """(b) qwen3-4b at its published widths and depth 2 on four gloo ranks
    on the one card, a (2, 2) mesh: 3 steps (rank 0 also runs the one-rank
    step from the same draw), one step under the op counter and the
    collective tap, the elastic reshard of the weights, and the sharded
    prefill and decode on the bfloat16 weights, in the configuration's
    bfloat16 compute and in float32 (rank 0 also serves the gathered
    weights on one rank)."""
    import os

    import torch.distributed as dist

    from repro_torch.analysis.op_cost import count_ops
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import flatten_with_paths, tree_map
    from repro_torch.sharding import RULES_SINGLE_POD, distribute_tree, make_shardings
    from repro_torch.train import jit_train_step, make_train_state_specs, make_train_step
    from repro_torch.train.serve_step import make_decode_fn, make_prefill_fn

    t = LAYOUT_FOUR
    cfg = _layout_cfg(t["layers"])
    shape = ShapeSpec("lm_layout_four", "train", t["seq"], t["batch"])
    kw = {"lr": t["lr"], "warmup": t["warmup"], "total_steps": t["steps"]}
    batches = _layout_batches(cfg, t["seq"], t["batch"], t["steps"] + 1)
    mesh = make_host_mesh(2, 2, device_type="cuda")
    out = {"rank": rank}

    def on_card(b):
        return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}

    step, specs, state_sh, batch_sh = jit_train_step(cfg, shape, mesh, RULES_SINGLE_POD, **kw)
    state = _layout_state(specs, state_sh, LM_PIN_SEED)
    place = lambda b: distribute_tree(on_card(b), batch_sh)                 # noqa: E731
    state, losses, norms, walls = _layout_steps(step, state, batches[:-1], place)
    out["train"] = {"losses": losses, "grad_norms": norms, "step_ms": [w * 1e3 for w in walls]}

    # one step with the collectives tapped (bytes, count) under the op counter,
    # then one with them timed between synchronisations
    batch = place(batches[-1])
    with _CollectiveTap() as tap, count_ops() as counter:
        step(state, batch)
    out["collectives"] = {"tapped_bytes": tap.bytes, "tapped_counts": tap.counts,
                          "counted_bytes": counter.cost.collective_by_kind,
                          "counted_counts": counter.cost.collective_counts,
                          "counted_flops": counter.cost.flops,
                          "counted_bytes_primary": counter.cost.bytes}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _CollectiveTap(timed=True) as timed:
        step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["split"] = {"step_ms": wall * 1e3, "collectives_ms": timed.seconds * 1e3,
                    "compute_ms": (wall - timed.seconds) * 1e3, "collectives": timed.counts}

    # the one-rank run from the same draw (rank 0; the others wait)
    if rank == 0:
        ref = _layout_state(make_train_state_specs(cfg), None, LM_PIN_SEED)
        ref, rl, rn, rw = _layout_steps(make_train_step(cfg, shape, **kw), ref,
                                        batches[:-1], on_card)
        out["one_rank"] = {"losses": rl, "grad_norms": rn, "step_ms": [w * 1e3 for w in rw]}
        del ref
        torch.cuda.empty_cache()
    dist.barrier()

    # elastic reshard of the trained weights and step: (2, 2) → (4, 1) → (1, 4)
    # (the optimizer state takes the same path; the CPU tests restore it too,
    # and its 7.8 GB read by four ranks would double the phase)
    ckpt = os.path.join(os.environ["TG_LAYOUT_DIR"], "reshard")
    mgr = CheckpointManager(ckpt, max_to_keep=1)
    weights = {"params": state["params"], "step": state["step"]}
    wspecs = {"params": specs["params"], "step": specs["step"]}
    t0 = time.perf_counter()
    mgr.save(1, weights, extra={"data": {"step": t["steps"], "seed": 0}}, blocking=True)
    dist.barrier()
    out["save_s"] = time.perf_counter() - t0
    equal = {}
    for data, model in ((4, 1), (1, 4)):
        m2 = make_host_mesh(data, model, device_type="cuda")
        t0 = time.perf_counter()
        restored = mgr.restore(1, wspecs, device="cuda",
                               shardings=make_shardings(wspecs, m2, RULES_SINGLE_POD))
        same = True
        for (p, a), (_, b) in zip(flatten_with_paths(weights), flatten_with_paths(restored)):
            full_a = a.full_tensor() if hasattr(a, "full_tensor") else a
            full_b = b.full_tensor() if hasattr(b, "full_tensor") else b
            same = same and torch.equal(full_a.cpu() if full_a.dim() == 0 else full_a,
                                        full_b.to(full_a.device))
            same = same and (b.dim() == 0 or b.device_mesh == m2)
            del full_a, full_b
        equal[f"{data}x{model}"] = {"bit_equal": same, "restore_s": time.perf_counter() - t0}
        del restored
    out["reshard"] = {"equal": equal,
                      "extra": mgr.restore_manifest(1)["extra"]}

    # the sharded prefill and decode against one rank's, on the trained params
    # served in bfloat16: in the configuration's bfloat16 compute, and in
    # float32, where what is left is the bfloat16 cache's rounding
    served = tree_map(lambda x: x.to(torch.bfloat16), state["params"])
    del state, weights
    torch.cuda.empty_cache()
    b, s, n = t["prefill_batch"], t["prompt"], t["decode_steps"]
    sshape = ShapeSpec("lm_layout_serve", "prefill", s + n, b)
    rng = np.random.default_rng(LM_PIN_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + n)).astype(np.int32))
    full = tree_map(lambda x: x.full_tensor(), served)
    out["serve"] = {}
    for cdt in ("bfloat16", "float32"):
        scfg = _layout_cfg(t["layers"], compute_dtype=cdt)
        prefill, _ = make_prefill_fn(scfg, sshape, mesh=mesh, rules=RULES_SINGLE_POD)
        decode, _, _ = make_decode_fn(scfg, sshape, mesh=mesh, rules=RULES_SINGLE_POD)
        t0 = time.perf_counter()
        logits, cache = prefill(served, {"tokens": toks[:, :s].to("cuda")})
        got = [logits.full_tensor().float()]
        for i in range(n):
            logits, cache = decode(served, {"tokens": toks[:, s + i:s + i + 1].to("cuda"),
                                            "cache_len": s + i}, cache)
            got.append(logits.full_tensor().float())
        torch.cuda.synchronize()
        res = {"sharded_s": time.perf_counter() - t0}
        del cache
        if rank == 0:
            model = build_model(scfg, tp_degree=2)
            with torch.no_grad():
                logits, cache = model.prefill(full, {"tokens": toks[:, :s].to("cuda")}, s + n)
                want = [logits.float()]
                for i in range(n):
                    logits, cache = model.decode(
                        full, {"tokens": toks[:, s + i:s + i + 1].to("cuda"), "cache_len": s + i},
                        cache)
                    want.append(logits.float())
            v = scfg.vocab_size         # the real vocabulary: the padding holds −1e30
            errs = [float((g[..., :v] - w[..., :v]).abs().max() / w[..., :v].abs().max())
                    for g, w in zip(got, want)]
            res.update(prefill_rel_err=errs[0], decode_rel_errs=errs[1:])
            del cache, want
        res["digest"] = _digest(torch.stack(got))
        out["serve"][cdt] = res
    out["launches"] = dict(_kernel_launches())
    return out


LAYOUT_JOBS = {"one": ("nccl", 1, _layout_one), "four": ("gloo", 4, _layout_four)}


def _layout_rank(rank: int, size: int, backend: str, init_file: str, job: str, out) -> None:
    """One rank of the ``lm_layout`` phase (the ``sharded`` phase's
    pattern): a process group of ``backend`` over a file rendezvous, the
    job on the card, its readings or its traceback put on ``out``."""
    import datetime
    import os
    import traceback

    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=size,
                                timeout=datetime.timedelta(seconds=LAYOUT_GROUP_TIMEOUT_S))
        from repro_torch import kernels
        from repro_torch.sharding.partitioning import gloo_cuda_collectives

        kernels.reset_launches()
        # several gloo ranks on the one card: DTensor's functional collectives
        # through c10d's in-place ones (torch 2.11's functional all-gather
        # crashes on a gloo group of CUDA tensors)
        with gloo_cuda_collectives() if backend == "gloo" else contextlib.nullcontext():
            res = LAYOUT_JOBS[job][2](rank, size)
        dist.barrier()
        out.put((rank, res, None))
    except Exception:  # the rank's boundary: report the traceback, fail the phase
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _layout_world(job: str, timeout: float):
    """Spawn the ranks of ``job`` (``LAYOUT_JOBS``) and wait for them:
    (results by rank, errors, wall seconds)."""
    import os
    import queue

    import torch.multiprocessing as tmp

    backend, size, _ = LAYOUT_JOBS[job]
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    init = ROOT / "build" / f"rendezvous_{os.getpid()}_layout_{job}"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    procs = [ctx.Process(target=_layout_rank, args=(r, size, backend, str(init), job, results))
             for r in range(size)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(size):
            rank, res, err = results.get(timeout=timeout)
            if err is None:
                got[rank] = res
            else:
                errors.append(f"{job} rank {rank}:\n{err}")
    except queue.Empty:
        errors.append(f"{job}: {len(got)} of {size} ranks answered within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        init.unlink(missing_ok=True)
    return got, errors, time.perf_counter() - t0


_LAYOUT_DRYRUN: dict = {}       # the dry-run subprocess, when the full run starts it early


def _layout_dryrun_start(outdir):
    """(c) The dry-run and the perf variants on the host, in a subprocess
    started now (they need no card; the full run starts it before its
    first phase, so that it runs beside the card's work): ``LAYOUT_DRYRUN_ARCH`` over the four
    shapes on 16×16, its prefill_32k on 2×16×16 (its train_4k and
    decode_32k there take 3 and 9 minutes of DTensor's sharding
    propagation on a 3-D mesh, on the CPU), and ``LAYOUT_PERF``."""
    import os

    script = (
        "import sys, time, json\n"
        "from repro_torch.launch import dryrun, perf\n"
        "t = {}\n"
        f"a = {LAYOUT_DRYRUN_ARCH!r}\n"
        f"out = {str(outdir)!r}\n"
        "t0 = time.perf_counter()\n"
        "r1 = dryrun.main(['--arch', a, '--out', out + '/dryrun_results_torch.json'])\n"
        "r2 = dryrun.main(['--arch', a, '--shape', 'prefill_32k', '--multi-pod', '--append',\n"
        "                  '--out', out + '/dryrun_results_torch.json'])\n"
        "t['dryrun_s'] = time.perf_counter() - t0\n"
        "t0 = time.perf_counter()\n"
        f"r3 = perf.main(['--arch', a, '--shape', {LAYOUT_PERF[0]!r}, '--variants',\n"
        f"                {LAYOUT_PERF[1]!r}, '--out', out + '/perf_results_torch.json'])\n"
        "t['perf_s'] = time.perf_counter() - t0\n"
        "print(json.dumps({'codes': [r1, r2, r3], **t}))\n"
    )
    import shutil

    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(Path(sys.path[0])), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(outdir))


def _layout_dryrun_stop() -> None:
    """Kill the early-started dry-run if a phase before lm_layout failed."""
    proc = _LAYOUT_DRYRUN.pop("proc", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


def _layout_dryrun_finish(proc, outdir, gate) -> dict:
    from repro_torch.launch.dryrun import should_skip

    try:
        stdout, stderr = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    gate(proc.returncode == 0, f"lm_layout dry-run: exit {proc.returncode}: {stderr[-2000:]}")
    rows, perf_rows, summary = [], [], {}
    try:
        summary = json.loads(stdout.strip().splitlines()[-1])
        rows = json.loads((outdir / "dryrun_results_torch.json").read_text())
        perf_rows = json.loads((outdir / "perf_results_torch.json").read_text())
    except (ValueError, IndexError, OSError) as exc:
        gate(False, f"lm_layout dry-run: no results ({exc}): {stderr[-1000:]}")
    from repro_torch.configs import ARCHS, SHAPES

    keep = ("arch", "shape", "mesh", "status", "reason", "error", "variant", "t_compute_s",
            "t_memory_s", "t_collective_s", "bottleneck", "flops_per_rank", "bytes_per_rank",
            "useful_flops_ratio", "roofline_fraction", "peak_memory_GiB", "run_seconds")
    for r in rows + perf_rows:
        ok = r["status"] == "ok" or (
            r["status"] == "skip"
            and r.get("reason") == should_skip(ARCHS[r["arch"]], SHAPES[r["shape"]]))
        gate(ok, f"lm_layout dry-run row {r.get('arch')} {r.get('shape')} {r.get('mesh')} "
                 f"{r.get('variant', '')}: {r['status']} {r.get('error', '')[:300]}")
    gate(len(rows) == 5 and len(perf_rows) == len(LAYOUT_PERF[1].split(",")),
         f"lm_layout dry-run: {len(rows)} rows, {len(perf_rows)} perf rows")
    return {"summary": summary,
            "rows": [{k: r[k] for k in keep if k in r} for r in rows],
            "perf_rows": [{k: r[k] for k in keep if k in r} for r in perf_rows],
            "collectives": {f"{r['shape']}/{r['mesh']}": r["collectives"]["by_kind"]
                            for r in rows if r["status"] == "ok"}}


def _layout_launcher(gate) -> dict:
    """(d) ``repro_torch.launch.train`` under torchrun: four ranks over
    gloo on the card, ``--smoke --data-axis 2 --model-axis 2``, then a
    relaunch that resumes."""
    import os
    import shutil
    import socket

    ckpt = ROOT / "build" / "lm_layout_launch"
    shutil.rmtree(ckpt, ignore_errors=True)
    t = LAYOUT_LAUNCH
    env = {**os.environ, "PYTHONPATH": str(Path(sys.path[0])), "GLOO_SOCKET_IFNAME": "lo",
           "OMP_NUM_THREADS": "1"}
    runs = []
    for steps in (t["first"], t["second"]):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
               "--master-addr", "127.0.0.1", "--master-port", str(port),
               "-m", "repro_torch.launch.train", "--smoke", "--data-axis", "2",
               "--model-axis", "2", "--steps", str(steps), "--seq-len", "64", "--batch", "8",
               "--lr", str(t["lr"]), "--ckpt-dir", str(ckpt), "--ckpt-every", str(t["every"]),
               "--log-every", "1"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        lines = proc.stdout.splitlines()
        losses = [float(m.group(2)) for m in
                  (re.match(r"step\s+(\d+)\s+loss\s+(\S+)", ln) for ln in lines) if m]
        from repro_torch.checkpoint import CheckpointManager

        runs.append({"steps": steps, "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
                     "losses": losses, "head": lines[:2], "tail": lines[-2:],
                     "latest_step": CheckpointManager(str(ckpt)).latest_step(),
                     "stderr": proc.stderr[-1500:] if proc.returncode else ""})
    first, second = runs
    gate(first["rc"] == 0 and second["rc"] == 0, f"lm_layout launcher: exit codes {runs}")
    gate(first["latest_step"] == t["first"] and second["latest_step"] == t["second"],
         f"lm_layout launcher: checkpoints at {first['latest_step']}, {second['latest_step']}")
    gate(len(first["losses"]) == t["first"] and len(second["losses"]) == t["second"] - t["first"],
         f"lm_layout launcher: {len(first['losses'])} and {len(second['losses'])} steps logged")
    gate(any(f"[resume] restoring step {t['first']}" in ln for ln in second["head"]),
         f"lm_layout launcher: the relaunch did not resume: {second['head']}")
    every = first["losses"] + second["losses"]
    gate(every and all(math.isfinite(x) for x in every)
         and statistics.mean(every[-3:]) < statistics.mean(every[:3]),
         f"lm_layout launcher: losses {every}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"runs": runs}


def phase_lm_layout():
    """The LM's 2-D layout on DTensor and its tooling (A17c): (a) qwen3-4b
    at its published widths, depth 8, on a (1, 1) mesh of one NCCL rank —
    ``jit_train_step`` against ``make_train_step`` from the same draw, 10
    steps each, and the port's roofline of the cell from the op counter;
    (b) qwen3-4b at depth 2 on four gloo ranks on the card, a (2, 2) mesh:
    3 steps identical on every rank, every loss and grad norm within 5e-3
    of one rank, the collective bytes by kind tapped and counted, the
    elastic reshard (2, 2) → (4, 1) → (1, 4), the sharded prefill and 8
    decode steps against one rank in bfloat16 and float32 compute, a step
    split into compute and collectives; (c) the dry-run of qwen3-4b on
    16×16 (and 2×16×16) and the perf variants baseline, seqpar and
    dp_attn, on the host in a subprocess started first; (d) the launcher under
    torchrun on four gloo ranks, with resume.  The path runs none of
    B1-B6: each rank reports its launches."""
    import os
    import shutil

    gates = []

    def gate(cond, what):
        gates.append((bool(cond), what))

    t_phase = time.perf_counter()
    smi, name = device_line()
    outdir = ROOT / "build" / "lm_layout"
    os.environ["TG_LAYOUT_DIR"] = str(outdir)
    dry = _LAYOUT_DRYRUN.pop("proc", None) or _layout_dryrun_start(outdir)
    worlds = {}
    try:
        for job, timeout in (("one", 600), ("four", 600)):
            got, errors, wall = _layout_world(job, timeout)
            worlds[job] = {"wall_s": wall, "errors": errors,
                           "results": [got.get(r) for r in range(LAYOUT_JOBS[job][1])]}
            gate(not errors, f"lm_layout {job}: " + "\n".join(errors))
        launcher = _layout_launcher(gate)
        dryrun = _layout_dryrun_finish(dry, outdir, gate)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()

    one = four = None
    if not worlds["one"]["errors"]:
        a = worlds["one"]["results"][0]
        pl, sh = a["plain"]["losses"], a["sharded"]["losses"]
        bit_equal = pl == sh and a["plain"]["grad_norms"] == a["sharded"]["grad_norms"]
        rel = max(abs(x / y - 1) for x, y in zip(sh + a["sharded"]["grad_norms"],
                                                 pl + a["plain"]["grad_norms"]))
        gate(bit_equal or rel <= LAYOUT_ONE_TOL,
             f"lm_layout one: losses {sh} vs {pl} ({rel} relative)")
        warm = {k: statistics.median(a[k]["step_ms"][1:]) for k in ("plain", "sharded")}
        tokens = LAYOUT_ONE["batch"] * LAYOUT_ONE["seq"]
        flops, _ = _lm_train_flops(_layout_cfg(LAYOUT_ONE["layers"]), tokens, LAYOUT_ONE["seq"])
        roof = a["roofline"]
        one = {"bit_equal": bit_equal, "max_rel_diff": rel, "warm_step_ms": warm,
               "roofline": roof, "lm_phase_model_flops": flops,
               "counted_over_lm_formula": roof["flops_per_rank"] / flops,
               "t_bound_over_step": max(roof["t_compute_s"], roof["t_memory_s"])
               / (warm["sharded"] / 1e3),
               "t_compute_over_step": roof["t_compute_s"] / (warm["sharded"] / 1e3),
               "t_memory_over_step": roof["t_memory_s"] / (warm["sharded"] / 1e3)}
    if not worlds["four"]["errors"]:
        ranks = worlds["four"]["results"]
        r0 = ranks[0]
        for r in ranks[1:]:
            gate(r["train"]["losses"] == r0["train"]["losses"]
                 and r["train"]["grad_norms"] == r0["train"]["grad_norms"],
                 f"lm_layout four: rank {r['rank']} differs {r['train']} {r0['train']}")
            for cdt in ("bfloat16", "float32"):
                gate(r["serve"][cdt]["digest"] == r0["serve"][cdt]["digest"],
                     f"lm_layout four: rank {r['rank']}'s served logits differ ({cdt})")
        rel = max(abs(x / y - 1) for x, y in
                  zip(r0["train"]["losses"] + r0["train"]["grad_norms"],
                      r0["one_rank"]["losses"] + r0["one_rank"]["grad_norms"]))
        gate(rel <= LAYOUT_FOUR_TOL, f"lm_layout four: {rel} from one rank {r0['train']} "
                                     f"{r0['one_rank']}")
        for r in ranks:
            c = r["collectives"]
            gate(c["tapped_bytes"] == c["counted_bytes"],
                 f"lm_layout four rank {r['rank']}: tapped {c['tapped_bytes']} counted "
                 f"{c['counted_bytes']}")
            gate(all(v["bit_equal"] for v in r["reshard"]["equal"].values())
                 and r["reshard"]["extra"] == {"data": {"step": LAYOUT_FOUR["steps"], "seed": 0}},
                 f"lm_layout four rank {r['rank']}: reshard {r['reshard']}")
        bf, f32 = r0["serve"]["bfloat16"], r0["serve"]["float32"]
        errs = {cdt: [r["prefill_rel_err"]] + r["decode_rel_errs"]
                for cdt, r in (("bfloat16", bf), ("float32", f32))}
        gate(max(errs["bfloat16"]) <= LAYOUT_LOGITS_TOL,
             f"lm_layout four: served logits in bfloat16 compute {errs['bfloat16']}")
        gate(f32["prefill_rel_err"] <= LAYOUT_LOGITS_F32_TOL[0]
             and max(f32["decode_rel_errs"]) <= LAYOUT_LOGITS_F32_TOL[1],
             f"lm_layout four: served logits in float32 compute {errs['float32']}")
        four = {"max_rel_diff_vs_one_rank": rel, "served_rel_errs": errs,
                "warm_step_ms": statistics.median(r0["train"]["step_ms"][1:]),
                "one_rank_warm_step_ms": statistics.median(r0["one_rank"]["step_ms"][1:]),
                "split": r0["split"], "collectives": r0["collectives"]}
    launches = None
    if not any(w["errors"] for w in worlds.values()):
        launches = {k: sum(r["launches"][k] for w in worlds.values() for r in w["results"])
                    for k in worlds["one"]["results"][0]["launches"]}
        gate(not any(launches.values()), f"lm_layout: B1-B6 launched on the LM path {launches}")
    out = {"phase": "lm_layout", "nvidia_smi": smi, "device": name, "one": one, "four": four,
           "worlds": worlds, "launcher": launcher, "dryrun": dryrun, "launches": launches,
           "phase_s": time.perf_counter() - t_phase,
           "failed_gates": [what for ok, what in gates if not ok]}
    emit(out)
    (outdir / "phase.json").write_text(json.dumps(out, indent=1, default=str))
    for ok, what in gates:
        check(ok, what)
    return out


def phase_trace_drops():
    """How often a torch.profiler trace misses a launch of B1 or B2 that
    the wrappers counted, and which records it loses: the matrix-free
    gate's window (``_matfree_window`` at n = 64) traced again and again
    on each store, the trace opened four ways in turn: straight away
    (``none``); after one throwaway kernel and a sync (``one_kernel``, the
    opening through PR 19); after two of them, each followed by a 50 ms
    pause (``sleep``); and after ``_open_trace`` (``pad``, the gates').
    Per trace: the wrappers' and the profiler's B1/B2 counts, and the host
    launch calls without a device record, before the window (in the
    opening) and in it.  Reports; holds nothing.  Run it after other
    phases (``--only mixed_bc,elasticity,batched,trace_drops``): a fresh
    process loses fewer records."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import kernels
    from repro_torch.core import assemble_rhs, unit_cube_tet, weakform as wf
    from repro_torch.fem import PoissonProblem

    prob = PoissonProblem(unit_cube_tet(MAIN_N), device="cuda")
    plan, bc = prob.plan, prob.bc
    load = bc.project_residual(assemble_rhs(plan, wf.source(1.0)))
    for store in TRACE_REPEATS:
        _matfree_window(plan, bc, load, store)  # every kernel loaded before the first trace
    torch.cuda.synchronize()
    summary, misses = {}, []
    for store, repeats in TRACE_REPEATS.items():
        for _ in range(repeats):
            for opening in TRACE_OPENINGS:
                kernels.reset_launches()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range({"one_kernel": 1, "sleep": 2}.get(opening, 0)):
                        torch.zeros(1, device="cuda").add_(1)
                        torch.cuda.synchronize()
                        time.sleep(0.05 if opening == "sleep" else 0.0)
                    if opening == "pad":
                        _open_trace()
                    with record_function("window"):
                        _matfree_window(plan, bc, load, store)
                    torch.cuda.synchronize()
                calls = _kernel_calls(prof)
                missed = {k: kernels.LAUNCHES[k] - calls[k]
                          for k in ("local_stiffness_p1", "seg_reduce")}
                start = next(e.time_range.start for e in prof.events()
                             if e.device_type == DeviceType.CPU and e.name == "window")
                lost = _lost_records(prof)
                cell = summary.setdefault(f"{store}/{opening}", {
                    "traces": 0, "with_a_miss": 0, "missed_b1": 0, "missed_b2": 0,
                    "lost_before_window": [], "lost_in_window": []})
                cell["traces"] += 1
                cell["with_a_miss"] += any(missed.values())
                cell["missed_b1"] += missed["local_stiffness_p1"]
                cell["missed_b2"] += missed["seg_reduce"]
                cell["lost_before_window"].append(sum(t < start for t in lost))
                cell["lost_in_window"].append(sum(t >= start for t in lost))
                if any(missed.values()):
                    misses.append({"store": store, "opening": opening, "missed": missed,
                                   "lost_us_from_window": [t - start for t in lost][:12]})
    emit({"phase": "trace_drops", "n": MAIN_N, "window": f"build + diagonal + "
          f"{PROFILED_ITERS} CG iterations", "open_trace_pad": OPEN_TRACE_PAD,
          "summary": summary, "misses": misses[:8]})


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


ONLY_PHASES = ("cold_path", "host_cost", "assembly_cost", "ell_timing", "ell_sweep",
               "reduce_timing", "gradients", "kernels_small", "mixed_bc", "elasticity", "batched",
               "matfree_kernel", "matfree", "opt", "pils", "elemalg", "serve", "sharded", "lm", "lm_families",
               "lm_layout", "trace_drops",
               "quickstart", "kernels_offsets64")


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
             for source in ("local_assembly", "matfree_p1", "seg_reduce", "spmv_ell",
                            "spmv_ell_stream")}
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

    # the lm_layout phase's dry-run runs on one host core beside the phases
    _LAYOUT_DRYRUN["proc"] = _layout_dryrun_start(ROOT / "build" / "lm_layout")
    atexit.register(_layout_dryrun_stop)
    phase_kernels_small()
    phase_reference()
    prob, k, _, main_launches, _ = phase_main_path()
    phase_profile(prob)
    theta_lhs, transient_launches = phase_transient(prob)
    k_stream, stream_launches = phase_stream_solve()
    rows = phase_kernels_main(prob, k, theta_lhs, k_stream, bw, fp64)
    phase_reduce_timing(prob, bw, fp64)
    phase_second_entry()
    phase_gradients()
    mixed = phase_mixed_bc()
    elasticity = phase_elasticity(bw, fp64)
    batched = phase_batched(prob, bw, fp64)
    rows["matfree_p1_diffusion"] = phase_matfree_kernel(bw, fp64, reports["matfree_p1"])
    matfree = phase_matfree(prob)
    opt = phase_opt()
    pils = phase_pils()
    elemalg = phase_elemalg(prob)
    served = phase_serve()
    sharded = phase_sharded()
    lm = phase_lm()
    lm_families = phase_lm_families()
    lm_layout = phase_lm_layout()
    phase_quickstart()
    phase_kernels_offsets64()

    # each kernel's launches on the path that runs it: B1-B4 on the main
    # path, B5 on the θ rollout, B6 in the n = 96 streaming solve
    paths = {**{kname: ("main_path", main_launches) for kname in MAIN_KERNELS},
             "spmv_ell_stream": ("transient", transient_launches),
             "galerkin_residual_ell_stream": ("stream_solve", stream_launches),
             "matfree_p1_diffusion": ("matfree", matfree["launches"])}
    launches = {kname: counts[kname] for kname, (_, counts) in paths.items()}
    # and on this slice's paths, each counted from 0 around its own run
    later = {"mixed_bc": mixed["launches"], "elasticity": elasticity["launches"],
             "batched": batched["coeff_batch"]["launches"], "matfree": matfree["launches"],
             "opt": opt["launches"], "pils": pils["launches"], "elemalg": elemalg["launches"],
             "serve": served["launches"], "sharded": sharded["launches"],
             "lm": lm["launches"], "lm_families": lm_families["launches"],
             "lm_layout": lm_layout["launches"]}

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
              "ell_sweep": lambda: phase_ell_sweep(*card_peaks(name)),
              "reduce_timing": lambda: phase_reduce_timing(None, *card_peaks(name)),
              "gradients": phase_gradients,
              "kernels_small": phase_kernels_small,
              "mixed_bc": phase_mixed_bc,
              "elasticity": lambda: phase_elasticity(*card_peaks(name)),
              "batched": lambda: phase_batched(None, *card_peaks(name)),
              "matfree_kernel": lambda: phase_matfree_kernel(*card_peaks(name)),
              "matfree": lambda: phase_matfree(None),
              "opt": phase_opt,
              "pils": phase_pils,
              "elemalg": lambda: phase_elemalg(None),
              "serve": phase_serve,
              "sharded": phase_sharded,
              "lm": phase_lm,
              "lm_families": phase_lm_families,
              "lm_layout": phase_lm_layout,
              "trace_drops": phase_trace_drops,
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
