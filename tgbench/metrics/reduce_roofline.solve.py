"""Reduce (B2): per traced solve the matrix's Reduce (E·k² contributions
onto the nnz stored values) and the load's (E·k onto the N DoFs), as a
share of the device time of the kernels launched inside ``tg.reduce``; a
solve whose ranges the trace lost is left out (``Trace.complete_ops_s``)."""

from tgbench.readout import roofline_pct
from tgbench.work.counts import reduce_work


def read(run):
    per_op = run.trace.complete_ops_s("tg.reduce") if run.trace is not None else []
    if not per_op:
        return None
    s = run.sizes
    work = (reduce_work(s.cells * s.local ** 2, s.nnz)
            + reduce_work(s.cells * s.local, s.dofs))
    return roofline_pct(run, work * len(per_op), sum(per_op))
