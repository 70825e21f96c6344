"""Dirichlet condensation: the device time of the masks on the values and
the load's lift (``tg.condense``), in ms a traced solve; a solve whose
ranges the trace lost is left out (``Trace.complete_ops_s``)."""


def read(run):
    per_op = run.trace.complete_ops_s("tg.condense") if run.trace is not None else []
    return 1e3 * sum(per_op) / len(per_op) if per_op else None
