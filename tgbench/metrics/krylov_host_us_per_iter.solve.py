"""Exposed host cost of the Krylov loop: over the ``tg.solve.<method>``
ranges of the traced solves, (the range's wall − the device busy time of
the kernels launched inside it) / the iterations, in µs."""


def read(run):
    name = f"tg.solve.{run.method}"
    iters = sum(n for op in run.traced_iters for n in op)
    if run.trace is None or not run.trace.count(name) or not iters:
        return None
    return 1e6 * run.trace.host_minus_device_s(name) / iters
