"""Jacobi-preconditioned CG: one operator application an iteration; x, r
and p read and written, diag⁻¹ read."""

APPLIES = 1     # operator applications an iteration
STATE = 3       # state vectors read once and written once
READ_ONLY = 1   # vectors only read
