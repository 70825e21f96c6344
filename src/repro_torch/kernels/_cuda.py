"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, into ``build/kernels/`` at the root of the checkout,
under a name that hashes the sources and flags, so a changed source builds
anew and an unchanged one loads at once.  :func:`build` compiles several
sources in parallel (one ``nvcc`` process each).

Every exported C function launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; :func:`launch` raises on a
non-zero code and counts the launch in :data:`LAUNCHES`.  A host-side query
(an occupancy lookup) returns its int result, or a negated CUDA error code,
and is called with :func:`query`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "SOURCES", "build", "check_operands", "launch", "query",
           "reset_launches", "symbol"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("local_assembly", "matfree_p1", "seg_reduce", "spmv_ell", "spmv_ell_stream")

# kernel launches per wrapper since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "local_stiffness_p1": 0,
    "matfree_p1_diffusion": 0,
    "seg_reduce": 0,
    "spmv_ell": 0,
    "galerkin_residual_ell": 0,
    "spmv_ell_stream": 0,
    "galerkin_residual_ell_stream": 0,
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"libtg_{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile the libraries of ``names`` that are not built yet, all
    ``nvcc`` processes at once; raises with the compiler's output if one
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, proc, tmp, target))
    errors = []
    for name, proc, tmp, target in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
    if errors:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(errors))


def _library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.tg_error_string.argtypes = [ctypes.c_int]
            lib.tg_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launch(counter: str, source: str, symbol: str, *args) -> None:
    """Call ``symbol`` of library ``source`` with ``args`` (tensors become
    device pointers, ``None`` a null pointer, floats ``double`` and ints
    ``long long``) and the current stream of
    the first tensor's device; raise on a CUDA error, else count one
    launch under ``counter``."""
    lib = _library(source)
    fn = getattr(lib, symbol)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs, types = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
            types.append(ctypes.c_void_p)
        elif a is None:
            cargs.append(ctypes.c_void_p(None))
            types.append(ctypes.c_void_p)
        elif isinstance(a, float):
            cargs.append(ctypes.c_double(a))
            types.append(ctypes.c_double)
        else:
            cargs.append(ctypes.c_longlong(int(a)))
            types.append(ctypes.c_longlong)
    fn.argtypes = [*types, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*cargs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {symbol} failed: error {err} "
            f"({lib.tg_error_string(err).decode()})"
        )
    LAUNCHES[counter] += 1


def query(source: str, symbol: str, device, *args: int) -> int:
    """Call the host-side query ``symbol`` of library ``source`` with int
    arguments on ``device``; returns its result, which is non-negative, or
    raises on the CUDA error it returns negated."""
    lib = _library(source)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_longlong] * len(args)
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        out = fn(*(int(a) for a in args))
    if out < 0:
        raise RuntimeError(f"CUDA query {symbol} failed: error {-out} "
                           f"({lib.tg_error_string(-out).decode()})")
    return out


def symbol(base: str, dtype: torch.dtype) -> str:
    """The exported C name of ``base`` for ``dtype`` (float32/float64)."""
    return f"{base}_{'f64' if dtype == torch.float64 else 'f32'}"


def check_operands(name: str, tensors: dict) -> torch.dtype:
    """Validate the tensors handed to a CUDA kernel: all contiguous, on one
    CUDA device, and the floating ones of one dtype (float32/float64);
    returns that dtype."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: operands must share one CUDA device, got "
                         + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    floats = {t.dtype for t in tensors.values() if t.is_floating_point()}
    if len(floats) != 1 or not floats <= {torch.float32, torch.float64}:
        raise TypeError(f"{name}: floating operands must all be float32 or all "
                        f"float64, got {sorted(map(str, floats))}")
    return floats.pop()
