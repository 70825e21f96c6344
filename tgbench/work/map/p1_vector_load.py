"""Constant body force, P1 vector: per element the coordinates read and
|T| b_i / 4 written for each of the 12 DoFs."""

from tgbench.work.counts import COORDS, F64

BYTES = COORDS + 12 * F64   # a cell
FLOPS = 20 + 12
