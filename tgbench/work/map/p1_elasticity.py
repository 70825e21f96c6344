"""Isotropic elasticity, P1 vector: per element the coordinates read and the
12 × 12 K_e written, λ and μ shared."""

from tgbench.work.counts import COORDS, F64, GEOMETRY_FLOPS

BYTES = COORDS + 144 * F64   # a cell
FLOPS = GEOMETRY_FLOPS + 144 * 8
