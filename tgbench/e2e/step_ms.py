"""The walls of the window's whole rollouts, each from when it was due to
its trajectory synchronised, over all their time steps."""


def read(run):
    if run.steps_per_op <= 1 or not run.ops:
        return None
    return 1e3 * sum(run.walls_s) / (run.ops * run.steps_per_op)
