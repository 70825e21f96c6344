"""The reference's side of a solve: its answer u put into the reference's
own system for the operation's input, and the control's solve of that
system in the program's place."""

import torch


class Check:
    def __init__(self, checker, traffic: dict):
        self.c = checker

    def readings(self, x, out) -> list:
        """``residual_over_target`` of the solve's u; NaN where u is not
        finite."""
        if not bool(torch.isfinite(out).all()):
            return [float("nan")]
        return [self.c.over_target(*self.c.system(x), out)]

    def control(self, solve, x):
        """``(u, [iterations], [converged])`` of ``solve`` on the system."""
        u, it, ok = solve(*self.c.system(x))
        return u, [it], [ok]
