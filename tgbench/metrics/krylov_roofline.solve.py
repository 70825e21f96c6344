"""SpMV and vector kernels of the Krylov loop: the least time of each
traced solve's iterations (per iteration the operator's values and column
indices read once for each application, each state vector read and written
once, the Jacobi diagonal read once; ``work.counts.krylov_work``), as a
share of the device time of the kernels launched inside
``tg.solve.<method>``."""

from tgbench.readout import roofline_pct
from tgbench.work.counts import Work, krylov_work


def read(run):
    name = f"tg.solve.{run.method}"
    if run.trace is None or not run.trace.count(name):
        return None
    s = run.sizes
    work = sum((krylov_work(run.method, s.nnz, s.dofs, n)
                for op in run.traced_iters for n in op), Work(0, 0))
    return roofline_pct(run, work, run.trace.busy_s(run.trace.launched_in(name)))
