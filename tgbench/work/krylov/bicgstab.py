"""Jacobi-preconditioned BiCGSTAB: two operator applications an
iteration; x, r, p and v read and written, r̂ and diag⁻¹ read."""

APPLIES = 2     # operator applications an iteration
STATE = 4       # state vectors read once and written once
READ_ONLY = 2   # vectors only read
