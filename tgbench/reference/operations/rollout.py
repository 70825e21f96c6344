"""The reference's side of a θ rollout of the heat equation M u' + K u = 0,
K the diffusion of the mix's ``rollout.diffusion``: step n solves
(M + θ dt K) uⁿ⁺¹ = (M − (1 − θ) dt K) uⁿ under the Dirichlet conditions.
Each of the program's states is put into the reference's system of its
step, the right-hand side formed from the program's state before it (the
first from the operation's input u0), so each step is checked alone."""

import torch

from tgbench.reference import fem


class Check:
    def __init__(self, checker, traffic: dict):
        self.c = checker
        r = traffic["rollout"]
        self.steps = r["steps"]
        k = fem.diffusion_local(checker.geo, r["diffusion"])
        m = fem.mass_local(checker.geo)
        self.lhs = checker.operator(m + r["theta"] * r["dt"] * k)
        self.rhs = checker.operator(m - (1 - r["theta"]) * r["dt"] * k)

    def step_system(self, u_prev):
        """A step's operator and condensed right-hand side."""
        return self.lhs, self.c.free * self.rhs.apply(u_prev.to(self.c.free.dtype))

    def readings(self, x, out) -> list:
        """``residual_over_target`` of every step; NaN where a state is not
        finite."""
        values = []
        for prev, u in zip([x, *out[:-1]], out):
            if not bool(torch.isfinite(u).all()):
                values.append(float("nan"))
                continue
            values.append(self.c.over_target(*self.step_system(prev), u))
        return values

    def control(self, solve, x):
        """The rollout by ``solve``, each step warm-started at the state
        before it: ``(states, iterations, converged)``, one entry a step."""
        u, states, iters, conv = x.to(self.c.free.dtype), [], [], []
        for _ in range(self.steps):
            u, it, ok = solve(*self.step_system(u), x0=u)
            states.append(u)
            iters.append(it)
            conv.append(ok)
        return torch.stack(states), iters, conv
