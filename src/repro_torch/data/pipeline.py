"""Token data pipeline (the torch port of ``repro.data.pipeline``).

:class:`SyntheticLMData` is the reference's numpy synthesis, unchanged, so
its batches are bit-equal to the reference's for the same seed and step:
a mixture of Zipfian unigram draws and repeated n-gram motifs — enough
signal for a real loss to fall without shipping a dataset.  The iterator
state (the step counter) is part of the checkpoint, so restarts are
reproducible.

:meth:`SyntheticLMData.device_iterator` keeps the reference's background
prefetch thread and queue depth and copies each batch to a torch device;
:meth:`SyntheticLMData.sharded_iterator` does the same for a batch placed
on a ``DeviceMesh`` (every rank makes the same global batch from the seed
and keeps its own rows, so feeding a batch costs no collective).
As in the reference, :meth:`state` counts the batches *made*, which the
prefetch thread runs ahead of the batches consumed.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

__all__ = ["SyntheticLMData"]


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    n_motifs: int = 64
    prefetch: int = 2

    def __post_init__(self):
        self._step = 0
        rng = np.random.default_rng(self.seed)
        self._motifs = rng.integers(
            1, self.vocab_size, size=(self.n_motifs, self.motif_len)
        )

    # -- checkpointable state --------------------------------------------------
    def state(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def restore(self, state: dict):
        self._step = int(state["step"])

    # -- batch synthesis ---------------------------------------------------------
    def _make_batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        ranks = rng.zipf(self.zipf_a, size=(b, s + 1))
        tokens = np.minimum(ranks, self.vocab_size - 1).astype(np.int32)
        # splice motifs for learnable structure
        n_splice = max(1, s // (4 * self.motif_len))
        for bi in range(b):
            for _ in range(n_splice):
                m = self._motifs[rng.integers(self.n_motifs)]
                at = rng.integers(0, s + 1 - self.motif_len)
                tokens[bi, at : at + self.motif_len] = m
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self._make_batch(self._step)
        self._step += 1
        return batch

    # -- device placement ----------------------------------------------------------
    def device_iterator(self, device):
        """Yield batches as int32 tensors on ``device``, made and copied by a
        background prefetch thread (overlaps host synthesis with step time)
        through a queue of depth ``prefetch``.  Closing the generator stops
        the thread."""
        return self._prefetch(lambda host: {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()})

    def sharded_iterator(self, shardings: dict):
        """Yield batches placed by ``shardings`` (a dict of
        :class:`~repro_torch.sharding.NamedSharding` per input, from
        ``make_shardings(model.batch_axes(shape), mesh, rules)``): DTensors
        of which this rank holds its own rows, taken from the global batch
        it made itself (``distribute_tree``: no collective), through the
        same prefetch thread and queue."""
        from ..sharding.partitioning import distribute_tree

        return self._prefetch(lambda host: distribute_tree(
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()},
            {k: shardings[k] for k in host}))

    def _prefetch(self, place):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                dev = place(next(self))
                while not stop.is_set():
                    try:
                        q.put(dev, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join(timeout=10)
