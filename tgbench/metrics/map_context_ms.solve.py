"""Map: the device time of the element context an einsum Map builds from
the coordinates at each call (``tg.map.context``, inside ``tg.map``), in
ms a traced solve; a solve whose ranges the trace lost is left out
(``Trace.complete_ops_s``)."""


def read(run):
    per_op = run.trace.complete_ops_s("tg.map.context") if run.trace is not None else []
    return 1e3 * sum(per_op) / len(per_op) if per_op else None
