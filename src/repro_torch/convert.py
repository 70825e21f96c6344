"""State carried across from the JAX package: numpy arrays → port objects.

The JAX side exports its state with ``np.asarray`` (mesh ``points`` /
``cells`` / ``cell_type``, coefficients, a CSR's or a BatchedCSR's
``vals`` / ``indptr`` / ``indices`` / ``shape``, a MixedBCPoisson's facet
sets); :func:`from_numpy` turns such a dict into the port's objects on a
device, so both packages compute on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.assembly import DTYPE, resolve_device
from .core.mesh import Mesh
from .core.sparse import CSR, BatchedCSR, CSRPattern

__all__ = ["from_numpy"]

_MESH_KEYS = ("points", "cells", "cell_type")
_CSR_KEYS = ("vals", "indptr", "indices", "shape")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return torch.tensor(a, dtype=DTYPE, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int64, device=device)
    return torch.tensor(a, device=device)


def from_numpy(state: dict, device=None) -> dict:
    """Convert a dict of exported JAX-side state.

    * ``points``, ``cells``, ``cell_type`` → ``out["mesh"]``, a
      :class:`~repro_torch.core.Mesh` (host arrays, as the mesh is set-up
      data);
    * ``vals``, ``indptr``, ``indices``, ``shape`` (optionally
      ``row_of_nnz``, ``diag_pos``) → ``out["csr"]``, a
      :class:`~repro_torch.core.CSR` with float64 values on ``device``
      (a :class:`~repro_torch.core.BatchedCSR` where ``vals`` is
      ``(B, nnz)``);
      the same keys under a prefix (``mass.vals``, ``mass.indptr``, …,
      ``stiff.vals``, …) → ``out["mass"]``, ``out["stiff"]``, ….  CSRs
      with equal ``shape``, ``indptr`` and ``indices`` share one
      :class:`~repro_torch.core.CSRPattern`, so its ELL layout and
      streaming plans are built once (and ``axpy_csr`` takes them);
    * keys ending in ``facets`` (a MixedBCPoisson's ``d_facets``,
      ``n_facets``, ``r_facets``: ``(F, 2)`` vertex ids) → int64 numpy
      arrays on the host, as the mesh (set-up data);
    * every other array or scalar (per-element ``(E,)``, per-quadrature
      ``(E, Q)`` or nodal ``(N,)`` coefficients, vectors) → a tensor on
      ``device`` under the same key: float64 for floating data, int64 for
      integer data.
    """
    device = resolve_device(device)
    out: dict = {}
    rest = dict(state)
    if all(k in rest for k in _MESH_KEYS):
        out["mesh"] = Mesh(rest.pop("points"), rest.pop("cells"), str(rest.pop("cell_type")))
    prefixes = [""] + sorted({k.rsplit(".", 1)[0] for k in rest if "." in k})
    patterns: list[CSRPattern] = []
    for pre in prefixes:
        keys = {k: f"{pre}.{k}" if pre else k for k in (*_CSR_KEYS, "row_of_nnz", "diag_pos")}
        if not all(keys[k] in rest for k in _CSR_KEYS):
            continue
        vals = _tensor(rest.pop(keys["vals"]), device)
        pattern = CSRPattern(rest.pop(keys["indptr"]), rest.pop(keys["indices"]),
                             tuple(rest.pop(keys["shape"])),
                             rest.pop(keys["row_of_nnz"], None), rest.pop(keys["diag_pos"], None))
        for seen in patterns:
            if (seen.shape == pattern.shape and np.array_equal(seen.indptr, pattern.indptr)
                    and np.array_equal(seen.indices, pattern.indices)):
                pattern = seen
                break
        else:
            patterns.append(pattern)
        out[pre or "csr"] = (BatchedCSR if vals.dim() == 2 else CSR)(vals, pattern)
    for key, value in rest.items():
        if key.endswith("facets"):
            out[key] = np.asarray(value, dtype=np.int64).reshape(-1, 2)
        else:
            out[key] = _tensor(value, device)
    return out
