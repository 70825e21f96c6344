"""State carried across from the JAX package: numpy arrays → port objects.

The JAX side exports its state with ``np.asarray`` (mesh ``points`` /
``cells`` / ``cell_type``, coefficients, a CSR's ``vals`` / ``indptr`` /
``indices`` / ``shape``); :func:`from_numpy` turns such a dict into the
port's objects on a device, so both packages compute on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.assembly import DTYPE, resolve_device
from .core.mesh import Mesh
from .core.sparse import CSR

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
      :class:`~repro_torch.core.CSR` with float64 values on ``device``;
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
    if all(k in rest for k in _CSR_KEYS):
        vals = _tensor(rest.pop("vals"), device)
        out["csr"] = CSR.from_arrays(
            vals, rest.pop("indptr"), rest.pop("indices"), tuple(rest.pop("shape")),
            row_of_nnz=rest.pop("row_of_nnz", None), diag_pos=rest.pop("diag_pos", None),
        )
    for key, value in rest.items():
        out[key] = _tensor(value, device)
    return out
