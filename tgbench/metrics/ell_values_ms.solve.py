"""ELL value layout: the device time of putting a CSR's values into the ELL
layout (``tg.ell.values``), every fill of a traced solve, in ms a solve; a
solve whose ranges the trace lost is left out (``Trace.complete_ops_s``)."""


def read(run):
    per_op = run.trace.complete_ops_s("tg.ell.values") if run.trace is not None else []
    return 1e3 * sum(per_op) / len(per_op) if per_op else None
