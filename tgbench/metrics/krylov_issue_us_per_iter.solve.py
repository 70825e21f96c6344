"""The host's time issuing a Krylov iteration: over the ``tg.solve.<method>``
ranges, (the range's wall − the wall of the ``tg.sync`` ranges inside it)
over the traced iterations, in µs.  What is left of the loop once its waits
on the device are taken out: the operator and preconditioner calls and the
vector launches.  Where the device is the slower side (the matrix-free
loop) this host time overlaps the device's work rather than adding to it."""


def read(run):
    t = run.trace
    name = f"tg.solve.{run.method}"
    iters = sum(n for op in run.traced_iters for n in op)
    if t is None or not t.count(name) or not t.count("tg.sync") or not iters:
        return None
    syncs = t.ranges["tg.sync"]
    issue_us = 0.0
    for lo, hi in t.ranges[name]:
        waited = sum(min(e, hi) - max(s, lo) for s, e in syncs if s < hi and e > lo)
        issue_us += hi - lo - waited
    return issue_us / iters
