"""ELL value layout: the ``tg.ell.values`` fills inside the traced
operations, per solve.  A solve needs one (its values change once); each
one more fills the same values again."""


def read(run):
    t = run.trace
    if t is None or not t.count("tg.ell.values") or not t.ops:
        return None
    fills = sum(any(lo <= s <= hi for lo, hi in t.ops) for s, _ in t.ranges["tg.ell.values"])
    return fills / (len(t.ops) * run.steps_per_op)
