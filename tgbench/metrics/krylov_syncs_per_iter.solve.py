"""Host syncs of the Krylov loop, over its traced iterations: each ``tg.sync``
range inside the traced operations (each device scalar the program reads
on the host: the stopping target, every stopping test, the final residual,
a solve's relative residual), and each device-to-host copy launched inside
them outside any ``tg.sync`` range (a read the program does not name, as
``.item()`` or ``nonzero`` do).  A solve through the program's helper alone
reads 1 + 4 / iterations, a θ step 1 + 3 / iterations (no relative
residual); more names a sync outside the helper.  A wait with no copy (a
stream or device synchronize) shows in ``krylov_issue_us_per_iter``
instead."""

import bisect


def read(run):
    t = run.trace
    iters = sum(n for op in run.traced_iters for n in op)
    if t is None or not t.count("tg.sync") or not iters:
        return None

    def in_ops(x):
        return any(lo <= x <= hi for lo, hi in t.ops)

    syncs = t.ranges["tg.sync"]
    starts = [s for s, _ in syncs]

    def in_sync(x):
        j = bisect.bisect_right(starts, x) - 1
        return j >= 0 and x <= syncs[j][1]

    named = sum(in_ops(s) for s, _ in syncs)
    unnamed = sum(1 for _, _, name, at in t.device
                  if at is not None and "DtoH" in name and in_ops(at) and not in_sync(at))
    return (named + unnamed) / iters
