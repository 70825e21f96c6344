"""AGN — Autoregressive Graph Network backbone for operator learning
(paper SM B.3.2): encoder–processor–decoder on the element graph, GraphSAGE
processor, frequency-enhanced encoder/decoder MLPs, bundled (window-w)
autoregressive updates with boundary clamping.

The torch port of ``repro.pils.gnn``.  The activation is GELU's tanh
approximation, as ``jax.nn.gelu``'s default; the neighbour sum is an
``index_add`` over the edges.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.assembly import resolve_device

__all__ = ["element_graph_edges", "agn_init", "agn_apply", "agn_rollout", "freq_features"]


def element_graph_edges(cells: np.ndarray) -> np.ndarray:
    """Fully-connect nodes within each element (Fig. B.13), dedup + both
    directions; returns (n_edges, 2) [src, dst]."""
    k = cells.shape[1]
    pairs = []
    for a in range(k):
        for b in range(k):
            if a != b:
                pairs.append(cells[:, [a, b]])
    edges = np.concatenate(pairs, axis=0)
    edges = np.unique(edges, axis=0)
    return edges.astype(np.int64)


def freq_features(x: torch.Tensor, k_max: int) -> torch.Tensor:
    """Frequency-enhanced features (Eq. B.20)."""
    feats = [x]
    for k in range(1, k_max + 1):
        feats.append(torch.sin(k * x))
        feats.append(torch.cos(k * x))
    return torch.cat(feats, dim=-1)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _normal(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def _mlp_init(generator, dims, dtype, device):
    params = []
    for i, o in zip(dims[:-1], dims[1:]):
        w = _normal(generator, (i, o), dtype, device) * np.sqrt(2.0 / i)
        params.append({"w": w, "b": torch.zeros((o,), dtype=dtype, device=device)})
    return params


def _mlp_apply(params, x, act=_gelu):
    for layer in params[:-1]:
        x = act(x @ layer["w"] + layer["b"])
    last = params[-1]
    return x @ last["w"] + last["b"]


def agn_init(generator: torch.Generator, in_channels: int, out_channels: int,
             hidden: int = 64, n_layers: int = 3, k_freq: int = 4, coord_dim: int = 2,
             dtype=torch.float64, device=None):
    """in_channels: state channels per node (window w); out per step bundle.
    Weights drawn from ``generator`` (on its own device)."""
    device = resolve_device(device)
    enc_in = (in_channels + coord_dim) * (2 * k_freq + 1)
    enc = _mlp_init(generator, [enc_in, hidden, hidden], dtype, device)
    sage = []
    for _ in range(n_layers):
        # GraphSAGE: W_self · h + W_neigh · mean(h_nbr)
        sage.append({
            "self": _normal(generator, (hidden, hidden), dtype, device) * np.sqrt(1.0 / hidden),
            "neigh": _normal(generator, (hidden, hidden), dtype, device) * np.sqrt(1.0 / hidden),
            "b": torch.zeros((hidden,), dtype=dtype, device=device),
        })
    dec = _mlp_init(generator, [hidden, hidden, out_channels], dtype, device)
    return {"enc": enc, "sage": sage, "dec": dec}


def agn_apply(params, node_state: torch.Tensor, coords: torch.Tensor,
              edges, degree: torch.Tensor, k_freq: int = 4) -> torch.Tensor:
    """node_state: (N, C_in), coords: (N, d) → (N, C_out) bundled update.
    ``edges`` is the (n_edges, 2) [src, dst] table, numpy or a tensor
    (pass it on the device once to save a copy per call)."""
    x = torch.cat([node_state, coords], dim=-1)
    h = _mlp_apply(params["enc"], freq_features(x, k_freq))
    edges = torch.as_tensor(edges, dtype=torch.int64, device=h.device)
    src, dst = edges[:, 0], edges[:, 1]
    for layer in params["sage"]:
        msg = torch.zeros_like(h).index_add(0, dst, h[src])
        mean_nbr = msg / degree[:, None]
        h = _gelu(h @ layer["self"] + mean_nbr @ layer["neigh"] + layer["b"])
    return _mlp_apply(params["dec"], h)


def agn_rollout(params, u_window: torch.Tensor, coords, edges, degree,
                n_bundles: int, interior_mask: torch.Tensor,
                bc_values: torch.Tensor | float = 0.0):
    """Autoregressive rollout with window size w (Fig. B.14).

    u_window: (N, w) initial window; each AGN call predicts a *delta bundle*
    (N, w) that advances the window by w steps; Dirichlet nodes are clamped
    after every bundle.  Returns (N, w·n_bundles) trajectory.
    """
    window, traj = u_window, []
    for _ in range(n_bundles):
        new = window + agn_apply(params, window, coords, edges, degree)
        window = torch.where(interior_mask[:, None], new, bc_values)
        traj.append(window)
    # (n_bundles, N, w) → (N, w·n_bundles)
    return torch.stack(traj).permute(1, 0, 2).reshape(u_window.shape[0], -1)
