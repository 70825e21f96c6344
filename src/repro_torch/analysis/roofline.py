"""Roofline analysis from the dry-run's per-rank op counts (the torch port
of ``repro.analysis.roofline``; no card needed).

Three terms per (arch × shape × mesh), all in seconds:

    compute    = FLOPs            / peak_FLOP/s
    memory     = bytes            / HBM_bw
    collective = collective_bytes / link_bw

with FLOPs, bytes and collective bytes those of *one rank*
(:mod:`repro_torch.analysis.op_cost` counts the ops on the local shards),
so each term is divided by one card's peak, as the reference divides its
per-device program by one chip's.

Hardware constants (:class:`HW`): the NVIDIA H100 SXM data sheet, which
assumes the card's full 700 W power limit — 989 TFLOP/s dense bfloat16,
3.35 TB/s of HBM3, and 450 GB/s of NVLink each way per card (900 GB/s in
both directions).  A card held below 700 W runs below these peaks.

Collective bytes are summed over the functional collectives one rank
issues; each byte crosses at least one link, so bytes / link_bw is the
single-hop lower bound.
"""

from __future__ import annotations

import dataclasses

from .op_cost import OpCost

__all__ = ["HW", "RooflineReport", "analyze"]


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM at its 700 W power limit (data sheet)."""

    peak_flops: float = 989e12          # dense bf16 per card
    hbm_bw: float = 3.35e12             # bytes/s per card
    link_bw: float = 450e9              # NVLink bytes/s per card, each way


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # per-rank counted flops
    hbm_bytes: float             # per-rank counted bytes
    collective_bytes: float      # per-rank collective bytes
    collective_detail: dict
    model_flops: float           # 6·N·D (or 6·N_active·D)
    peak_memory_bytes: float = 0.0
    hw: HW = dataclasses.field(default_factory=HW)

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted flops across ranks — remat/redundancy."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: how close the dominant term lets
        us get to ideal MODEL_FLOPS/peak execution."""
        ideal = self.model_flops / (self.chips * self.hw.peak_flops)
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return ideal / bound if bound else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "flops_per_rank": self.flops,
            "bytes_per_rank": self.hbm_bytes,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_GiB": self.peak_memory_bytes / 2**30,
            "collectives": self.collective_detail,
        }


def analyze(cost: OpCost, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, hw: HW = HW(), peak_memory_bytes: float = 0.0) -> RooflineReport:
    """The report of one cell from its per-rank :class:`OpCost` (the
    counterpart of ``analyze_compiled``, which read a compiled module)."""
    detail = {
        "by_kind": {k: float(v) for k, v in cost.collective_by_kind.items()},
        "counts": dict(cost.collective_counts),
        "total": float(cost.collective_bytes),
        "dynamic_loops": cost.dynamic_loops,
        "bytes_upper": float(cost.bytes_upper),
    }
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops=float(cost.flops), hbm_bytes=float(cost.bytes),
        collective_bytes=float(cost.collective_bytes), collective_detail=detail,
        model_flops=model_flops, peak_memory_bytes=peak_memory_bytes, hw=hw,
    )
