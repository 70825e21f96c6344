"""∫ f φ, constant f, P1: per element the coordinates read and |T| f / 4
written at each of the 4 vertices."""

from tgbench.work.counts import COORDS, F64

BYTES = COORDS + 4 * F64   # a cell
FLOPS = 20 + 4
