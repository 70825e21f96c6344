"""A θ rollout of the heat equation M u' + K u = 0 from the operation's
input u0: ``ThetaIntegrator.from_form`` over the problem's assembler and
Dirichlet conditions, K the diffusion of ``rollout.diffusion``, built
once at set-up; an operation is ``rollout(u0, steps)``."""

from tgbench.program import Outcome

WARM_STEPS = 2  # the warm-up: every kernel and layout of a step


class Operation:
    def __init__(self, cls, port, config: dict, traffic: dict, spec):
        from repro_torch.core import weakform as wf
        from repro_torch.transient import ThetaIntegrator

        r = traffic["rollout"]
        self.steps = r["steps"]
        self.integrator = ThetaIntegrator.from_form(
            port.asm, wf.diffusion(r["diffusion"]), r["dt"], theta=r["theta"], bc=port.bc,
            backend=traffic["call"]["backend"], spec=spec)

    def run(self, x) -> Outcome:
        traj, info = self.integrator.rollout(x, self.steps, return_info=True)
        return Outcome(traj, [int(n) for n in info.iters.tolist()],
                       [bool(c) for c in info.converged.tolist()])

    def warm(self, x) -> None:
        self.integrator.rollout(x, WARM_STEPS)
