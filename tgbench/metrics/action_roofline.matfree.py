"""Matrix-free apply: the least time of every ``tg.matfree.action`` call's
work (per element the basis gradients, the measure, the coefficient and
x_e read, y_e written; ``work.counts.action_work``), as a share of the
device time of the kernels launched inside those ranges."""

from tgbench.readout import roofline_pct
from tgbench.work.counts import action_work


def read(run):
    name = "tg.matfree.action"
    if run.trace is None or not run.trace.count(name):
        return None
    work = action_work(run.sizes.cells) * run.trace.count(name)
    return roofline_pct(run, work, run.trace.busy_s(run.trace.launched_in(name)))
