"""−∇·(ρ∇u), P1: per element the 4 × 3 vertex coordinates and ρ read, K_e
(16 entries) written; the geometry (Jacobian, inverse, determinant ~45,
the four gradients ~27) and 10 distinct 3-term dots (K_e is symmetric)."""

from tgbench.work.counts import COORDS, F64, GEOMETRY_FLOPS

BYTES = COORDS + F64 + 16 * F64   # a cell
FLOPS = GEOMETRY_FLOPS + 10 * 6 + 2
