"""Time to solution: the walls of the window's whole solves, each from when
it was due (its input drawn and on the device) to u synchronised, over
their number (the last solve that starts in the window finishes and
counts)."""


def read(run):
    if run.steps_per_op != 1 or not run.ops:
        return None
    return 1e3 * sum(run.walls_s) / run.ops
