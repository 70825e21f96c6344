"""Map: the least time of the ``tg.map`` calls' work of each traced solve
(per solve, the Map kinds the configuration lists: the matrix's and the
load's), as a share of the device time of the kernels launched inside
those ranges; a solve whose ranges the trace lost is left out
(``Trace.complete_ops_s``)."""

from tgbench.readout import roofline_pct
from tgbench.work.counts import Work, map_work


def read(run):
    per_op = run.trace.complete_ops_s("tg.map") if run.trace is not None else []
    if not per_op:
        return None
    work = sum((map_work(kind, run.sizes.cells) for kind in run.config["work"]["map"]),
               Work(0, 0))
    return roofline_pct(run, work * len(per_op), sum(per_op))
