"""Host set-up: the problem's construction (plan, reduce tables) and its
warm-up operation (the ELL or streaming layout, cached, and a solve capped
at a few iterations or a two-step rollout), timed by the harness; read
from the traced run's set-up."""


def read(run):
    return run.plan_build_s
