"""The one generator of every traffic mix: it reads a mix's parameters
(``traffic/<mix>.json``) and draws the input of each operation from the
run's seed.

The input of operation ``i`` depends on ``(seed, stream, i)`` alone and is
drawn on the run's device by a ``torch.Generator`` seeded from a
``numpy.random.SeedSequence`` of the three, so the reference can draw any
operation's input again without keeping it.  Stream 0 feeds the measured
window, stream 1 the warm-up.  What an input is comes from its kind,
``inputs/<kind>.py`` (``input.kind`` of the mix): a class ``Input(spec,
points, cells, device)`` whose ``draw(generator)`` returns the tensor.

With ``pool: P`` the window's inputs are P fixed draws, the same for every
seed, taken in an order the seed permutes (operation i takes member
perm[i mod P]): a cell whose window holds only a few long operations then
does the same work on every seed, in another order.
"""

from __future__ import annotations

import numpy as np
import torch

from .plugins import load

__all__ = ["Draws"]

WINDOW, WARMUP = 0, 1
_POOL, _ORDER = 2, 3     # streams of the pool's members and of their order


class Draws:
    """Inputs of the operations of one run.  ``points`` are the benchmark's
    own mesh vertices and ``cells`` its cells (numpy)."""

    def __init__(self, spec: dict, seed: int, points: np.ndarray, cells: np.ndarray, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.kind = load("inputs", spec["kind"]).Input(spec, points, cells, self.device)
        self.pool = spec.get("pool")
        if self.pool:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed % (1 << 64), _ORDER]))
            self.order = rng.permutation(self.pool)

    def _generator(self, stream: int, i: int) -> torch.Generator:
        entropy = [stream, i] if stream == _POOL else [self.seed % (1 << 64), stream, i]
        state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(state))

    def input(self, i: int, stream: int = WINDOW) -> torch.Tensor:
        """The input of operation ``i`` of ``stream``."""
        if self.pool and stream == WINDOW:
            stream, i = _POOL, int(self.order[i % self.pool])
        return self.kind.draw(self._generator(stream, i))
