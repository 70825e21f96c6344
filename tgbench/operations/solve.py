"""A solve: one call of the problem class's solve on the operation's
input, to u on the device at the configuration's tolerance."""

import warnings

from tgbench.program import Outcome

WARM_ITERS = 3  # the warm-up's solve: every kernel and layout, a few iterations


class Operation:
    def __init__(self, cls, port, config: dict, traffic: dict, spec):
        self.cls, self.port, self.problem = cls, port, config["problem"]
        self.spec, self.call = spec, traffic.get("call", {})

    def run(self, x) -> Outcome:
        res = self.cls.solve(self.port, self.problem, x, self.spec, self.call)
        return Outcome(res.u, [int(res.iters)], [bool(res.converged)])

    def warm(self, x) -> None:
        """The same call capped at a few iterations: the plan's layouts and
        every kernel of the solve, without a whole solve's time."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # it stops short of the tolerance
            self.cls.solve(self.port, self.problem, x, self.spec.replace(maxiter=WARM_ITERS),
                           self.call)
